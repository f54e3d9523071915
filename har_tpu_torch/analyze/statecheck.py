"""HL002 — state completeness: every field a snapshotted class assigns
in ``__init__`` must round-trip ``state()`` / ``load_state()``.

The bug class back-compat pins patch case by case: a new FleetStats
counter lands in ``__init__`` and the snapshot path silently forgets
it, so the first crash after the feature ships zeroes it — the
conservation law then "balances" against amnesia.  This rule makes the
omission a gate failure at the commit that introduces the field.

Mechanics: for every class in the fileset that defines BOTH ``state``
and ``load_state``, every public attribute assigned in ``__init__``
must be *mentioned* by both methods.  A mention is a ``self.<name>``
access, a string literal naming the field, or membership in a
class-level string table (``_COUNTERS``/``_STAGES``-style tuples) that
the method references — so the ``getattr(self, k) for k in
self._COUNTERS`` idiom counts, and DELETING a name from the table (or
a key line from ``state()``) immediately un-mentions it.

Escapes: underscore-private attributes are process-local by
convention (``StageHistogram._recent`` — the trailing percentile
window restarts after recovery, documented there), and a public field
that intentionally restarts is annotated ``# harlint: ephemeral`` on
its ``__init__`` line (``FleetStats.sessions`` / ``queue_depth`` —
gauges recomputed during restore).

The static half is paired with a runtime guard: ``FleetStats.
load_state`` warns and counts (``unknown_state_keys``) when a state
dict carries keys this version does not know — a newer writer's state
degrades loudly instead of silently dropping fields.
"""

from __future__ import annotations

import ast

from har_tpu_torch.analyze.core import FileContext, Finding, Rule


def _init_fields(cls: ast.ClassDef, ctx: FileContext) -> list[tuple[str, ast.AST]]:
    init = next(
        (
            n
            for n in cls.body
            if isinstance(n, ast.FunctionDef) and n.name == "__init__"
        ),
        None,
    )
    if init is None:
        return []
    fields = []
    for node in ast.walk(init):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        for t in targets:
            if (
                isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name)
                and t.value.id == "self"
                and not t.attr.startswith("_")
            ):
                if ctx.suppressed(node, "ephemeral"):
                    ctx.suppression_hits += 1
                    continue
                fields.append((t.attr, node))
    return fields


def _string_tables(cls: ast.ClassDef) -> dict[str, set[str]]:
    """Class-level assignments of string tuples/lists/sets:
    ``_COUNTERS = ("enqueued", ...)`` -> {"_COUNTERS": {...}}."""
    tables: dict[str, set[str]] = {}
    for node in cls.body:
        if not isinstance(node, ast.Assign):
            continue
        if not isinstance(node.value, (ast.Tuple, ast.List, ast.Set)):
            continue
        strings = {
            e.value
            for e in node.value.elts
            if isinstance(e, ast.Constant) and isinstance(e.value, str)
        }
        if not strings:
            continue
        for t in node.targets:
            if isinstance(t, ast.Name):
                tables[t.id] = strings
    return tables


def _mentions(fn: ast.FunctionDef, tables: dict[str, set[str]]) -> set[str]:
    out: set[str] = set()
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            out.add(node.attr)
            if node.attr in tables:  # self._COUNTERS reference
                out.update(tables[node.attr])
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            out.add(node.value)
        elif isinstance(node, ast.Name) and node.id in tables:
            out.update(tables[node.id])
    return out


class StateCompletenessRule(Rule):
    rule_id = "HL002"
    title = "state completeness"

    def check(self, ctx: FileContext) -> list[Finding]:
        findings: list[Finding] = []
        for cls in ast.walk(ctx.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            methods = {
                n.name: n
                for n in cls.body
                if isinstance(n, ast.FunctionDef)
            }
            if "state" not in methods or "load_state" not in methods:
                continue
            tables = _string_tables(cls)
            state_m = _mentions(methods["state"], tables)
            load_m = _mentions(methods["load_state"], tables)
            for name, node in _init_fields(cls, ctx):
                for method, mentioned in (
                    ("state()", state_m),
                    ("load_state()", load_m),
                ):
                    if name not in mentioned:
                        findings.append(
                            ctx.finding(
                                self.rule_id,
                                node,
                                f"field `{name}` assigned in "
                                f"{cls.name}.__init__ is absent from "
                                f"{method} — it will silently zero "
                                "after a crash recovery; persist it "
                                "with a load default, or annotate a "
                                "deliberately process-local gauge "
                                "with `# harlint: ephemeral`",
                                f"{cls.name}.{name}",
                            )
                        )
        return findings
