"""harlint core: files, findings, suppressions, and the rule runner.

The fleet stack of the port (``har_tpu_torch.serve`` +
``har_tpu_torch.adapt`` + ``har_tpu_torch.parallel``) is held together
by invariants that tests pin only case by case: the conservation law,
the state()/load_state round trip, the journal-record/replay-handler
bijection, the no-host-sync-on-the-launch-path rule.  harlint checks
them statically: a rule is an AST visitor over a fixed fileset, a
finding is a (rule, file, line, symbol, message) record, and the
release gate (``har_tpu_torch.release_gate``) refuses a tree with any
finding outside the baseline.

Design choices:

  - **Pure stdlib.**  ``ast`` + ``json`` only: ``lint`` runs in the
    release gate's subprocess without importing torch, so it costs the
    gate no CUDA initialisation and stays inside its budget.
  - **Line-anchored suppressions** (``# harlint: <token>``) are
    reviewed contracts, not escape hatches: ``fetch-ok`` marks the one
    allowed host-sync sink (a retire-side fetch), ``host-ok`` marks a
    reviewed host-origin conversion on the launch path, ``ephemeral``
    marks a stats field that intentionally restarts after recovery,
    ``spec-ok`` a reviewed placement, ``disable=HL00X`` is the generic
    last resort.  A token counts on the flagged line, anywhere in a
    multi-line call's span, or on the comment-only line directly above
    (so the annotation can carry prose).
  - **Stable baseline keys.**  A finding's baseline key is
    ``rule|path|symbol|normalized-snippet``: line-number independent,
    so unrelated edits never churn the committed baseline file.
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import re
from pathlib import Path

# the fleet stack: the fileset every rule reasons over by default.
# serving.py rides along because the fleet engine's window assembly,
# smoothing, ingest guard and pad policies live there; utils/backoff.py
# because the dispatch retry loop runs ON the launch path (HL001's
# computed reachability follows retry_call's closures); parallel/
# because HL006/HL007 guard its traced bodies and placements.
DEFAULT_FILESET = (
    "har_tpu_torch/serve",
    "har_tpu_torch/adapt",
    "har_tpu_torch/serving.py",
    "har_tpu_torch/utils/durable.py",
    "har_tpu_torch/utils/backoff.py",
    "har_tpu_torch/parallel",
)

_SUPPRESS_RE = re.compile(r"#\s*harlint:\s*(.+)$")
_KNOWN_TOKENS = {"fetch-ok", "host-ok", "ephemeral", "spec-ok"}


def _parse_tokens(comment: str) -> set[str]:
    """Extract harlint tokens from the text after ``# harlint:`` —
    prose is allowed around them (``# harlint: host-ok (slot list)``)."""
    tokens: set[str] = set()
    for word in re.split(r"[\s,()]+", comment.strip()):
        if word in _KNOWN_TOKENS:
            tokens.add(word)
        elif word.startswith("disable="):
            for rule in word[len("disable="):].split(","):
                if rule:
                    tokens.add(f"disable={rule}")
    return tokens


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to a file/line/symbol."""

    rule: str
    path: str  # repo-relative, posix separators
    line: int
    message: str
    symbol: str = ""  # enclosing function/class qualname
    snippet: str = ""  # normalized source line (baseline key material)

    def key(self) -> str:
        """Line-number-independent identity for the baseline file."""
        return f"{self.rule}|{self.path}|{self.symbol}|{self.snippet}"

    def render(self) -> str:
        sym = self.symbol or "<module>"
        return f"{self.path}:{self.line}: {self.rule} [{sym}] {self.message}"


class FileContext:
    """One parsed source file plus its suppression map."""

    def __init__(self, rel: str, source: str):
        self.rel = rel.replace("\\", "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=self.rel)
        # support context (path-subset runs): informs cross-file
        # analysis — call-graph edges, traced roots, axis tables — but
        # is never itself examined: per-file checks skip it, finalize
        # rules don't scan its bodies, and its suppression consumption
        # stays out of the report
        self.support = False
        # would-be findings a token (fetch-ok / host-ok / ephemeral)
        # suppressed — rules bump this so the report can account for
        # every reviewed escape, not only `disable=` lines
        self.suppression_hits = 0
        # (lineno, token) pairs that actually suppressed something this
        # run — HL008 audits the complement (annotations that suppress
        # NOTHING are rotted contracts and are themselves findings)
        self.suppression_used: set[tuple[int, str]] = set()
        # lineno (1-based) -> set of suppression tokens on that line
        self.suppressions: dict[int, set[str]] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if m:
                tokens = _parse_tokens(m.group(1))
                if tokens:
                    self.suppressions[i] = tokens

    @functools.cached_property
    def wrap_calls(self) -> frozenset:
        """Terminal names of the calls whose first argument is a bare name
        (``torch.compile(step)``): the only calls that can wrap a def by
        name, so a file without one skips the lexical wrap search."""
        return frozenset(
            call_name(node)
            for node in ast.walk(self.tree)
            if isinstance(node, ast.Call)
            and node.args
            and isinstance(node.args[0], ast.Name)
        )

    # ------------------------------------------------------ suppression

    def _node_lines(self, node: ast.AST):
        start = getattr(node, "lineno", 1)
        end = getattr(node, "end_lineno", start) or start
        lines = list(range(start, end + 1))
        # the line directly above joins the annotation surface ONLY
        # when it is a comment-only line (a prose justification block);
        # a trailing token on the previous CODE line must not bleed
        # into this statement
        prev = start - 1
        if (
            prev >= 1
            and prev <= len(self.lines)
            and self.lines[prev - 1].lstrip().startswith("#")
        ):
            lines.insert(0, prev)
        return lines

    def suppressed(self, node: ast.AST, token: str) -> bool:
        for ln in self._node_lines(node):
            if token in self.suppressions.get(ln, ()):
                self.suppression_used.add((ln, token))
                return True
        return False

    def rule_disabled(self, node: ast.AST, rule_id: str) -> bool:
        return self.suppressed(node, f"disable={rule_id}")

    # --------------------------------------------------------- helpers

    def snippet(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return " ".join(self.lines[lineno - 1].split())
        return ""

    def finding(
        self, rule: str, node: ast.AST, message: str, symbol: str = ""
    ) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(
            rule=rule,
            path=self.rel,
            line=line,
            message=message,
            symbol=symbol,
            snippet=self.snippet(line),
        )


def walk_functions(tree: ast.Module):
    """Yield ``(qualname, class_name, node)`` for every function/method
    definition, qualnames dotted through nesting (``Cls.method``)."""
    out = []

    def visit(node, stack):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = ".".join(stack + [child.name])
                cls = stack[-1] if stack else None
                out.append((qual, cls, child))
                visit(child, stack + [child.name])
            elif isinstance(child, ast.ClassDef):
                visit(child, stack + [child.name])
            else:
                visit(child, stack)

    visit(tree, [])
    return out


def walk_scopes(tree: ast.Module) -> list[tuple[str, ast.AST]]:
    """``(qualname, node)`` for every def/class scope, pre-order
    (parents before their children), qualnames dotted through nesting
    — the one walker behind symbol labelling (iterate in order and
    let deeper scopes overwrite: innermost wins) and enclosing-scope
    lookups, so the qualname convention cannot drift between rules."""
    out: list[tuple[str, ast.AST]] = []

    def visit(node, stack):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                out.append((".".join(stack + [child.name]), child))
                visit(child, stack + [child.name])
            else:
                visit(child, stack)

    visit(tree, [])
    return out


def call_name(node: ast.Call) -> str | None:
    """The terminal name a call targets: ``foo()`` -> foo,
    ``a.b.foo()`` -> foo."""
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def receiver_name(node: ast.Call) -> str | None:
    """For ``recv.attr(...)``: the receiver's name when it is a bare
    Name (``np.asarray`` -> "np"); None otherwise."""
    f = node.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        return f.value.id
    return None


class Project:
    """Shared cross-file analysis state for one lint run.

    The call graph (``analyze.callgraph``) is built lazily — only runs
    that include a graph-consuming rule (HL001/HL006) pay for it — and
    built ONCE, however many rules then traverse it."""

    def __init__(self, ctxs: list["FileContext"]):
        self.ctxs = ctxs
        self._graph = None
        self.callgraph_ms = 0.0

    @property
    def callgraph(self):
        if self._graph is None:
            import time

            from har_tpu_torch.analyze.callgraph import CallGraph

            t0 = time.perf_counter()
            self._graph = CallGraph(self.ctxs)
            self.callgraph_ms = (time.perf_counter() - t0) * 1e3
        return self._graph


class Rule:
    """Base class: per-file ``check``, an optional cross-file
    ``finalize`` (HL003 compares record writers against replay
    handlers), and an optional ``audit`` that runs AFTER every other
    rule's suppressions have been consumed (HL008 flags the annotations
    nothing consumed).  ``self.project`` (set by ``run_rules``) carries
    the shared call graph."""

    rule_id = "HL000"
    title = ""
    project: Project | None = None

    def applies(self, rel: str) -> bool:
        return True

    def check(self, ctx: FileContext) -> list[Finding]:
        return []

    def finalize(self, ctxs: list[FileContext]) -> list[Finding]:
        return []

    def audit(
        self, ctxs: list[FileContext], ran: list[str]
    ) -> list[Finding]:
        return []


@dataclasses.dataclass
class LintStats:
    rules_run: list[str]
    files: int
    annotation_suppressed: int = 0
    rule_ms: dict[str, float] = dataclasses.field(default_factory=dict)
    callgraph_ms: float = 0.0


def _apply_disable(
    raw: list[Finding], by_rel: dict[str, FileContext]
) -> tuple[list[Finding], int]:
    """Filter generic ``disable=HL00X`` line suppressions, recording
    which (line, token) pairs were consumed."""
    findings: list[Finding] = []
    suppressed = 0
    for f in raw:
        ctx = by_rel.get(f.path)
        check_lines = [f.line]
        if ctx is not None:
            prev = f.line - 1
            # same adjacency rule as token suppression: the preceding
            # line joins the surface only when it is comment-only
            if (
                1 <= prev <= len(ctx.lines)
                and ctx.lines[prev - 1].lstrip().startswith("#")
            ):
                check_lines.append(prev)
        hit = None
        if ctx is not None:
            for ln in check_lines:
                if f"disable={f.rule}" in ctx.suppressions.get(ln, ()):
                    hit = ln
                    break
        if hit is not None:
            ctx.suppression_used.add((hit, f"disable={f.rule}"))
            suppressed += 1
            continue
        findings.append(f)
    return findings, suppressed


def run_rules(
    ctxs: list[FileContext], rules: list[Rule]
) -> tuple[list[Finding], LintStats]:
    """Run every rule over the fileset; generic ``disable=`` line
    suppressions are applied here so individual rules never need to.
    Per-rule wall time is recorded (``lint --stats`` and the
    release gate's lint budget read it)."""
    import time

    by_rel = {c.rel: c for c in ctxs}
    project = Project(ctxs)
    raw: list[Finding] = []
    rule_ms: dict[str, float] = {}
    for rule in rules:
        rule.project = project
        t0 = time.perf_counter()
        for ctx in ctxs:
            if rule.applies(ctx.rel) and not ctx.support:
                raw.extend(rule.check(ctx))
        raw.extend(rule.finalize([c for c in ctxs if rule.applies(c.rel)]))
        rule_ms[rule.rule_id] = (time.perf_counter() - t0) * 1e3
    findings, suppressed = _apply_disable(raw, by_rel)
    # audit pass: runs after every check/finalize has consumed its
    # suppressions (HL008's staleness question is only answerable then)
    ran = [r.rule_id for r in rules]
    for rule in rules:
        t0 = time.perf_counter()
        audit_raw = rule.audit(
            [c for c in ctxs if rule.applies(c.rel)], ran
        )
        if audit_raw:
            audited, n = _apply_disable(audit_raw, by_rel)
            findings.extend(audited)
            suppressed += n
        rule_ms[rule.rule_id] += (time.perf_counter() - t0) * 1e3
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    stats = LintStats(
        rules_run=ran,
        files=len([c for c in ctxs if not c.support]),
        annotation_suppressed=suppressed
        + sum(c.suppression_hits for c in ctxs if not c.support),
        rule_ms={k: round(v, 2) for k, v in rule_ms.items()},
        callgraph_ms=round(project.callgraph_ms, 2),
    )
    return findings, stats


def discover_files(root: Path, paths=None) -> list[Path]:
    """Resolve the fileset: explicit ``paths`` (files or directories)
    or the default fleet-stack set, as sorted .py files."""
    targets = [root / p for p in (paths or DEFAULT_FILESET)]
    files: list[Path] = []
    for t in targets:
        if t.is_dir():
            files.extend(sorted(t.rglob("*.py")))
        elif t.suffix == ".py" and t.exists():
            files.append(t)
    return files


def load_contexts(root: Path, paths=None) -> list[FileContext]:
    ctxs = []
    for f in discover_files(root, paths):
        rel = f.relative_to(root).as_posix()
        ctxs.append(FileContext(rel, f.read_text()))
    return ctxs
