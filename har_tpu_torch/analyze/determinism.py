"""HL004 — determinism: the fleet stack's bit-identity pins must not
be one wall-clock read or one unseeded RNG away from flaking.

Three of the stack's strongest guarantees are *bit-identity* pins:
fleet events equal N standalone classifiers, pipelined equals
synchronous, and pre-crash ∪ post-recovery equals uninterrupted.  All
three hold only because every clock is injectable (``FakeClock``) and
every random draw is seeded.  A cache
nondeterminism hunt is what one violation costs.

Flagged inside ``har_tpu_torch/serve/`` and ``har_tpu_torch/adapt/``:

  - ``time.time()`` CALLS — wall-clock reads the fake-clock harness
    cannot intercept — and ``time.time`` passed/stored AS A
    CALLABLE: ``self._clock = clock or time.time`` smuggles the same
    wall clock past the old call-only check, one indirection later.
    An injectable default that must be monotonic spells it
    ``clock or time.monotonic`` (still allowed — monotonic/
    perf_counter duration measurement feeds reporting, not
    decisions); a deliberate wall-clock default (the registry's
    ``created_unix`` stamps) carries a reviewed ``disable=HL004``.
  - ``datetime.datetime.now()`` / ``utcnow()`` — the same wall
    clock wearing a different module; previously invisible to the
    ``time.time``-shaped check.
  - stdlib ``random.*`` calls — the process-global RNG, unseedable per
    run without cross-test contamination;
  - legacy global numpy RNG (``np.random.rand`` / ``np.random.seed`` /
    any ``np.random.<fn>`` other than ``default_rng``) and
    ``np.random.default_rng()`` with NO seed — both draw from
    process-global or OS entropy;
  - iteration directly over a ``set`` expression (literal, set
    comprehension, or ``set(...)`` call) — set order is hash-dependent
    across processes, the dict-order trap for session-id collections
    (plain dicts are insertion-ordered and fine; a session-id SET is
    not).  Wrap in ``sorted(...)``.

WALL-CLOCK ALLOWLIST: ``har_tpu_torch/serve/net/`` is the one
subtree where the wall-clock findings (``time.time`` calls/references,
``datetime.now``) are DECLARED legal — the transport owns real
deadlines, and the leader lease is a cross-process timestamp that
monotonic clocks cannot express (they are not comparable between
processes).  The allowlist is a path scope, not a suppression: the
RNG and set-iteration findings still apply inside it, and a
``time.time()`` planted anywhere else in ``serve/`` (the engine, the
dispatcher) still fails the gate — acceptance-mutation-pinned against
the real ``serve/engine.py``.
"""

from __future__ import annotations

import ast

from har_tpu_torch.analyze.core import FileContext, Finding, Rule

_SCOPES = ("har_tpu_torch/serve/", "har_tpu_torch/adapt/")
# the declared wall-clock scope: real transport deadlines + the
# cross-process leader lease live here and NOWHERE else
_WALLCLOCK_OK = ("har_tpu_torch/serve/net/",)


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id in ("set", "frozenset")
    )


class DeterminismRule(Rule):
    rule_id = "HL004"
    title = "determinism"

    def applies(self, rel: str) -> bool:
        return any(rel.startswith(s) for s in _SCOPES)

    def check(self, ctx: FileContext) -> list[Finding]:
        findings: list[Finding] = []
        # the transport subtree's declared wall-clock legality; every
        # OTHER determinism finding still applies there
        wall_ok = any(ctx.rel.startswith(p) for p in _WALLCLOCK_OK)
        # enclosing-symbol map for readable findings
        symbols: dict[int, str] = {}

        def label(node, qual):
            for sub in ast.walk(node):
                ln = getattr(sub, "lineno", None)
                if ln is not None and ln not in symbols:
                    symbols[ln] = qual

        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                label(node, node.name)

        def flag(node, msg):
            findings.append(
                ctx.finding(
                    self.rule_id, node, msg,
                    symbols.get(getattr(node, "lineno", 0), ""),
                )
            )

        # callable-reference detection: `time.time` appearing OUTSIDE a
        # call's function position (stored as an injectable default,
        # passed as a key fn, ...) is the same wall clock one
        # indirection later — collect the call-position nodes first so
        # the reference walk can exclude them
        call_funcs = {
            id(node.func)
            for node in ast.walk(ctx.tree)
            if isinstance(node, ast.Call)
        }
        for node in ast.walk(ctx.tree):
            if (
                not wall_ok
                and isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "time"
                and node.attr == "time"
                and id(node) not in call_funcs
            ):
                flag(
                    node,
                    "`time.time` stored/passed as a callable — the "
                    "wall clock rides the indirection past the "
                    "FakeClock harness exactly like a direct call; "
                    "default to the injectable clock (or "
                    "`time.monotonic` for durations)",
                )
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ):
                f = node.func
                # datetime.now()/utcnow(): `datetime.now(...)` on the
                # imported class or `datetime.datetime.now(...)` on the
                # module — both are wall clocks the harness cannot fake
                if not wall_ok and f.attr in ("now", "utcnow") and (
                    (
                        isinstance(f.value, ast.Name)
                        and f.value.id == "datetime"
                    )
                    or (
                        isinstance(f.value, ast.Attribute)
                        and f.value.attr == "datetime"
                        and isinstance(f.value.value, ast.Name)
                        and f.value.value.id == "datetime"
                    )
                ):
                    flag(
                        node,
                        f"`datetime.{f.attr}()` — a wall-clock read "
                        "the FakeClock harness cannot intercept (the "
                        "`time.time()` trap in a different module); "
                        "take the injectable clock and derive "
                        "timestamps from it",
                    )
                if isinstance(f.value, ast.Name):
                    if (
                        not wall_ok
                        and f.value.id == "time"
                        and f.attr == "time"
                    ):
                        flag(
                            node,
                            "`time.time()` call — a wall-clock read the "
                            "FakeClock harness cannot intercept; take "
                            "the injectable clock (`self._clock()`) "
                            "instead",
                        )
                    elif f.value.id == "random":
                        flag(
                            node,
                            f"stdlib `random.{f.attr}(...)` — the "
                            "process-global RNG breaks the bit-identity "
                            "pins; draw from a seeded "
                            "`np.random.default_rng(seed)` instead",
                        )
                elif (
                    isinstance(f.value, ast.Attribute)
                    and isinstance(f.value.value, ast.Name)
                    and f.value.value.id in ("np", "numpy")
                    and f.value.attr == "random"
                ):
                    if f.attr != "default_rng":
                        flag(
                            node,
                            f"legacy global `np.random.{f.attr}(...)` — "
                            "unseeded process-global state; use a "
                            "seeded `np.random.default_rng(seed)`",
                        )
                    elif not node.args and not node.keywords:
                        flag(
                            node,
                            "`np.random.default_rng()` without a seed "
                            "draws from OS entropy — pass an explicit "
                            "seed so runs are reproducible",
                        )
            elif isinstance(node, ast.For) and _is_set_expr(node.iter):
                flag(
                    node.iter,
                    "iterating a set — order is hash-dependent across "
                    "processes (the nondeterministic cousin of the "
                    "session-dict-order trap); wrap in `sorted(...)`",
                )
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                for gen in node.generators:
                    if _is_set_expr(gen.iter):
                        flag(
                            gen.iter,
                            "comprehension over a set — order is "
                            "hash-dependent across processes; wrap in "
                            "`sorted(...)`",
                        )
        return findings
