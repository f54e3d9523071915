"""harlint — AST-based invariant checker for the port's fleet stack.

Eight rules over ``har_tpu_torch/serve`` + ``har_tpu_torch/adapt`` +
``har_tpu_torch/parallel`` (plus the shared ``serving.py`` /
``utils/durable.py`` / ``utils/backoff.py`` they ride on), the JAX
package's ``har_tpu.analyze`` retargeted to the port:

  HL001  hot-path host-sync      no ``.item()``/``.tolist()``/``.cpu()``/
                                 ``.numpy()``/``synchronize``/blocking
                                 host-to-device copy/host
                                 materialization anywhere the project
                                 call graph can reach from the
                                 ``launch``/``_launch_batch`` roots, or
                                 inside a compiled body; retire-side
                                 fetches are the one allowed sink
                                 (``# harlint: fetch-ok``)
  HL002  state completeness      every public field a snapshotted class
                                 assigns in ``__init__`` round-trips
                                 ``state()``/``load_state()``
  HL003  journal exhaustiveness  record types ↔ replay handlers ↔
                                 chaos kill points stay in bijection
  HL004  determinism             no wall clocks (called OR passed as
                                 callables), global RNGs, or set-order
                                 iteration where bit-identity pins live
  HL005  durability              registry/journal writes never bypass
                                 the utils/durable fsync discipline
  HL006  trace purity            nothing reachable from a traced body
                                 (torch.export forward, torch.compile,
                                 torch.func, CUDA-graph capture, fake
                                 kernels) mutates captured state, reads
                                 clocks, prints/logs, or fetches
  HL007  placement coverage      distribute_tensor/local_map declare
                                 placements for every input and output,
                                 every PartitionSpec / rule-table axis
                                 is a declared mesh axis, tables and
                                 spec builders shard >1-D kernels
  HL008  stale suppressions      a ``# harlint:`` annotation that no
                                 longer suppresses anything is itself a
                                 finding — reviewed contracts cannot rot

HL001/HL006/HL007 share the project-wide call graph
(``analyze.callgraph``): ``self.`` methods, typed attributes,
return-type-inferred locals, cross-module imports and nested closures
all resolve, so the guarded surface is computed reachability, not a
name list.

Run it as ``python -m har_tpu_torch.cli lint`` (text or ``--json``;
``--changed``/``--rule`` for fast pre-commit subsets, ``--stats`` for
per-rule timing), or from code via ``run_harlint``.  The port's own
``har_tpu_torch/harlint_baseline.json`` holds reviewed pre-existing
debt; ``har_tpu_torch.release_gate`` fails on any finding outside it
and on a lint slower than its budget.  Nothing here imports torch.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

from har_tpu_torch.analyze.baseline import (
    DEFAULT_BASELINE,
    apply_baseline,
    load_baseline,
    write_baseline,
)
from har_tpu_torch.analyze.core import (
    DEFAULT_FILESET,
    FileContext,
    Finding,
    Rule,
    discover_files,
    load_contexts,
    run_rules,
)
from har_tpu_torch.analyze.determinism import DeterminismRule
from har_tpu_torch.analyze.durability import DurabilityRule
from har_tpu_torch.analyze.hotpath import HotPathRule
from har_tpu_torch.analyze.journalcheck import JournalExhaustivenessRule
from har_tpu_torch.analyze.jitpurity import JitPurityRule
from har_tpu_torch.analyze.partitionspec import (
    AXIS_DECLARERS as _AXIS_DECLARERS,
    PartitionSpecRule,
)
from har_tpu_torch.analyze.statecheck import StateCompletenessRule
from har_tpu_torch.analyze.suppressions import SuppressionAuditRule


def default_rules() -> list[Rule]:
    return [
        HotPathRule(),
        StateCompletenessRule(),
        JournalExhaustivenessRule(),
        DeterminismRule(),
        DurabilityRule(),
        JitPurityRule(),
        PartitionSpecRule(),
        SuppressionAuditRule(),
    ]


def repo_root() -> Path:
    """The checkout root: the directory holding the ``har_tpu_torch``
    package (where the baseline file and the fileset paths resolve)."""
    return Path(__file__).resolve().parent.parent.parent


@dataclasses.dataclass
class LintReport:
    """One harlint run: fresh findings, suppression accounting, and the
    JSON shape the release gate stamps into its log."""

    findings: list[Finding]  # non-baselined — what fails the gate
    baselined: int
    annotation_suppressed: int
    rules_run: list[str]
    files: int
    baseline_path: str
    baseline_size: int
    rule_ms: dict = dataclasses.field(default_factory=dict)
    callgraph_ms: float = 0.0
    lint_ms: float = 0.0  # in-process rule time; the gate measures the
    #                       fresh-interpreter wall clock around it

    @property
    def ok(self) -> bool:
        return not self.findings

    @property
    def suppressed(self) -> int:
        return self.baselined + self.annotation_suppressed

    @property
    def per_rule(self) -> dict:
        """Fresh-finding counts per rule id, zero-filled over the rules
        that ran — the release gate stamps this so a red rule is
        identifiable from the gate log alone."""
        out = {r: 0 for r in self.rules_run}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def to_json(self) -> dict:
        return {
            "ok": self.ok,
            "rules_run": self.rules_run,
            "files": self.files,
            "findings": len(self.findings),
            "per_rule": self.per_rule,
            "suppressed": self.suppressed,
            "baselined": self.baselined,
            "annotation_suppressed": self.annotation_suppressed,
            "baseline": self.baseline_path,
            "baseline_size": self.baseline_size,
            "rule_ms": self.rule_ms,
            "callgraph_ms": self.callgraph_ms,
            "lint_ms": self.lint_ms,
            "findings_list": [
                {
                    "rule": f.rule,
                    "path": f.path,
                    "line": f.line,
                    "symbol": f.symbol,
                    "message": f.message,
                }
                for f in self.findings
            ],
        }

    def render(self) -> str:
        lines = [f.render() for f in self.findings]
        lines.append(
            f"harlint: {len(self.rules_run)} rules over {self.files} "
            f"files — {len(self.findings)} finding(s), "
            f"{self.suppressed} suppressed "
            f"({self.baselined} baseline, "
            f"{self.annotation_suppressed} annotations)"
        )
        return "\n".join(lines)

    def render_stats(self) -> str:
        """``lint --stats``: per-rule wall time + finding counts, so a
        slow-rule regression is visible before it eats the gate's lint
        budget."""
        per = self.per_rule
        rows = [
            f"  {rule:<7} {self.rule_ms.get(rule, 0.0):>8.1f} ms  "
            f"{per.get(rule, 0):>3} finding(s)"
            for rule in self.rules_run
        ]
        rows.append(
            f"  callgraph build: {self.callgraph_ms:.1f} ms "
            "(inside the first consuming rule's time)"
        )
        rows.append(
            f"  total: {self.lint_ms:.1f} ms over {self.files} files"
        )
        return "\n".join(["harlint --stats (per-rule):"] + rows)


def changed_fileset_paths(
    root: Path | str, ref: str = "HEAD"
) -> list[str]:
    """Repo-relative fileset .py files that differ from ``ref``
    (``git diff --name-only`` of the working tree vs the ref, plus
    untracked files) — the ``lint --changed`` fast path.  Only
    files the default fileset would lint are returned, so the subset
    run judges exactly what a full run would judge about them."""
    import subprocess

    root = Path(root)
    try:
        proc = subprocess.run(
            ["git", "diff", "--name-only", ref, "--"],
            cwd=root, capture_output=True, text=True, check=True,
        )
        untracked = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard"],
            cwd=root, capture_output=True, text=True, check=True,
        )
    except (OSError, subprocess.CalledProcessError) as exc:
        raise SystemExit(
            f"lint --changed: git diff vs {ref!r} failed "
            f"({getattr(exc, 'stderr', exc)})"
        )
    changed = {
        line.strip()
        for out in (proc.stdout, untracked.stdout)
        for line in out.splitlines()
        if line.strip().endswith(".py")
    }
    fileset = {
        f.relative_to(root).as_posix()
        for f in discover_files(root)
    }
    return sorted(changed & fileset)


def lint_sources(
    sources: dict[str, str], rules: list[Rule] | None = None
) -> list[Finding]:
    """Run the rules over in-memory ``{repo-relative-path: source}``
    pairs — the fixture-test entry point (each rule's positive and
    negative snippets are pinned through this)."""
    ctxs = [FileContext(rel, src) for rel, src in sorted(sources.items())]
    findings, _ = run_rules(ctxs, rules or default_rules())
    return findings


def run_harlint(
    root: Path | str | None = None,
    paths=None,
    baseline: Path | str | None = None,
    update_baseline: bool = False,
    rules: list[Rule] | None = None,
) -> LintReport:
    """Lint the checkout: load the fileset, run the rules, apply the
    committed baseline.  ``update_baseline=True`` rewrites the baseline
    to the current findings (they then report as baselined).

    A path-subset run (explicit ``paths``, the ``--changed`` fast
    path) drops HL008 AND HL003 from the default rule list: both
    judge whole-fileset properties — suppression staleness needs
    HL001's launch closure actually computed, and HL003's
    journal-writer ↔ replay-handler ↔ kill-point bijections only hold
    over the full set (recover.py linted alone reports every handler
    as orphaned).  An explicit ``rules`` list is always respected as
    given.

    Subset runs also load SUPPORT files alongside the requested paths:
    when HL007 is in play, the axis-declaring files
    (``_AXIS_DECLARERS``) — the declared-mesh-axes table and
    ``*_AXIS`` constant resolution live in ``mesh.py`` et al., and
    judging an edited ``tensor_parallel.py`` without them
    false-positives the spec-builder check on clean code; when HL001,
    HL003 (forced via ``--rule`` — the default subset list drops it)
    or HL006 is in play, the REST OF THE FILESET — reachability roots
    (the ``launch`` defs, the compile/torch.func wrap sites) and HL003's
    journal writers/kill-point call sites live anywhere in the
    project, so a changed helper judged without its callers would
    pass clean on the very launch-path sync the full
    run flags.  Support files inform the analysis only — per-file
    checks and finalize body scans skip them (so the subset run stays
    cheaper than a full lint and its suppression counts cover the
    requested files only), and they never scope a baseline rewrite."""
    import time as _time

    t_lint0 = _time.perf_counter()
    root = Path(root) if root is not None else repo_root()
    baseline_path = (
        Path(baseline) if baseline is not None else root / DEFAULT_BASELINE
    )
    if rules is None:
        rules = default_rules()
        if paths is not None:
            rules = [
                r for r in rules if r.rule_id not in ("HL003", "HL008")
            ]
    ctxs = load_contexts(root, paths)
    requested_rels = {c.rel for c in ctxs}
    if paths is not None:
        rule_ids = {r.rule_id for r in rules}
        support: set[str] = set()
        if "HL007" in rule_ids:
            support |= {
                p for p in _AXIS_DECLARERS
                if p not in requested_rels and (root / p).is_file()
            }
        if rule_ids & {"HL001", "HL003", "HL006"}:
            support |= {
                f.relative_to(root).as_posix()
                for f in discover_files(root)
            } - requested_rels
        if support:
            support_ctxs = load_contexts(root, sorted(support))
            for c in support_ctxs:
                c.support = True
            ctxs = ctxs + support_ctxs
    findings, stats = run_rules(ctxs, rules)
    findings = [f for f in findings if f.path in requested_rels]
    if update_baseline:
        # scope the rewrite to the (rule × file) coverage this run
        # actually examined: a subset run must not retire other files'
        # reviewed entries (support contexts inform the analysis, they
        # are not examined), and a --rule / --changed run that skipped
        # a rule must not retire that rule's entries anywhere
        write_baseline(
            baseline_path,
            findings,
            linted_files=requested_rels,
            rules_run={r.rule_id for r in rules},
        )
    known = load_baseline(baseline_path)
    # rename eligibility is judged against the FULL fileset on disk,
    # not the (possibly partial) linted subset: an entry's file merely
    # missing from a --changed run is not a rename
    fileset_rels = {
        f.relative_to(root).as_posix() for f in discover_files(root)
    }
    fresh, baselined = apply_baseline(
        findings, known, fileset_files=fileset_rels
    )
    try:
        # repo-relative in reports: the gate log is a committed
        # artifact and must not carry machine-specific paths
        baseline_label = str(baseline_path.relative_to(root))
    except ValueError:
        baseline_label = str(baseline_path)
    return LintReport(
        findings=fresh,
        baselined=baselined,
        annotation_suppressed=stats.annotation_suppressed,
        rules_run=stats.rules_run,
        files=len(requested_rels),
        baseline_path=baseline_label,
        baseline_size=len(known),
        rule_ms=stats.rule_ms,
        callgraph_ms=stats.callgraph_ms,
        lint_ms=round((_time.perf_counter() - t_lint0) * 1e3, 2),
    )


__all__ = [
    "DEFAULT_FILESET",
    "Finding",
    "LintReport",
    "Rule",
    "changed_fileset_paths",
    "default_rules",
    "lint_sources",
    "repo_root",
    "run_harlint",
]
