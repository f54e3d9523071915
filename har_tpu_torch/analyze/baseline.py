"""harlint baseline: committed suppression file for pre-existing debt.

The port keeps its own file, ``har_tpu_torch/harlint_baseline.json``
(``DEFAULT_BASELINE``, relative to the checkout root); the JAX
package's root ``harlint_baseline.json`` is never read or written here.

The gate fails on any NON-baselined finding, so new violations can
never land — while debt that predates a rule is recorded (reviewed,
visible, diffable in the change that admits it) instead of blocking the
gate forever.  Entries are line-number independent (``Finding.key``):
``rule|path|symbol|normalized-snippet`` — moving code around does not
churn the file; changing or fixing the flagged line retires the entry.
``apply_baseline`` additionally matches entries path-agnostically as a
fallback — but only entries whose recorded file no longer exists in
the fileset (a genuine rename/move) — so a rename does not stale a
reviewed entry, while a stale entry for a fixed violation in a
still-present file cannot launder an identical new violation in some
other file.  A file DELETED outright is indistinguishable from a
rename at match time, so its entries stay rename-eligible until the
next full ``--update-baseline`` retires them — the residual window the
near-empty-baseline policy (below) exists to keep closed.

The committed file is expected to stay near-empty: every rule ships
with its real findings fixed at introduction time, and
``lint --update-baseline`` exists for the rare reviewed exception,
not as a pressure valve.
"""

from __future__ import annotations

import json
from pathlib import Path

from har_tpu_torch.analyze.core import Finding

BASELINE_VERSION = 1
DEFAULT_BASELINE = "har_tpu_torch/harlint_baseline.json"


def load_baseline(path: Path) -> set[str]:
    """The committed suppression keys (empty set when the file does not
    exist — a missing baseline suppresses nothing)."""
    try:
        data = json.loads(Path(path).read_text())
    except (OSError, ValueError):
        return set()
    return set(data.get("entries") or [])


def apply_baseline(
    findings: list[Finding],
    baseline: set[str],
    fileset_files: set[str] | None = None,
) -> tuple[list[Finding], int]:
    """Split findings into (fresh, n_baselined).

    Matching is two-pass: exact ``rule|path|symbol|snippet`` keys
    first, then a path-agnostic fallback on ``rule|symbol|snippet`` —
    so a reviewed entry survives the file it lives in being renamed or
    moved, not only the ±N-line shifts the line-free key already
    absorbs.  An exact entry covers EVERY finding with its key (the
    baseline file itself is a set, so N identical violating lines in
    one function write one deduplicated entry — it must suppress all N
    or ``--update-baseline`` followed by ``lint`` goes red with
    zero code change).

    The fallback is deliberately narrow: an entry is eligible only if
    it was not consumed exactly AND its recorded file is not among
    ``fileset_files`` — the files that EXIST in the full fileset, not
    merely the ones a subset run happened to lint (an entry's file
    missing from a ``--changed`` subset is not a rename; judging
    eligibility against a partial set would let any baselined entry
    launder an identical new violation during pre-commit runs).  An
    entry whose original file still exists but no longer triggers is
    RETIRED, not transferable.  (An entry whose file was DELETED is
    the one case this proxy cannot tell from a rename — it remains
    eligible until a full ``--update-baseline`` drops it, which is why
    the baseline is kept near-empty.)  ``fileset_files=None`` (direct fixture
    calls) skips the existence judgement and treats every unconsumed
    entry as rename-eligible.  An eligible entry covers all findings
    sharing its relaxed key — the renamed file keeps its N duplicates
    covered, exactly like the exact pass."""

    def relaxed_key(key: str):
        parts = key.split("|", 3)
        return (parts[0], parts[2], parts[3]) if len(parts) == 4 else None

    used_exact: set[str] = set()
    unmatched: list[Finding] = []
    baselined = 0
    for f in findings:
        k = f.key()
        if k in baseline:
            used_exact.add(k)
            baselined += 1
        else:
            unmatched.append(f)
    relaxed: set = set()
    for e in baseline:
        if e in used_exact:
            continue
        if fileset_files is not None and entry_path(e) in fileset_files:
            continue  # original file still present: not a rename
        rk = relaxed_key(e)
        if rk is not None:
            relaxed.add(rk)
    fresh: list[Finding] = []
    for f in unmatched:
        if relaxed_key(f.key()) in relaxed:
            baselined += 1
        else:
            fresh.append(f)
    return fresh, baselined


def entry_path(entry: str) -> str:
    """The repo-relative file a baseline entry refers to (field 2 of
    ``rule|path|symbol|snippet``)."""
    parts = entry.split("|", 2)
    return parts[1] if len(parts) > 1 else ""


def entry_rule(entry: str) -> str:
    """The rule id a baseline entry refers to (field 1 of
    ``rule|path|symbol|snippet``)."""
    return entry.split("|", 1)[0]


def write_baseline(
    path: Path,
    findings: list[Finding],
    linted_files: set[str] | None = None,
    rules_run: set[str] | None = None,
) -> int:
    """Rewrite the baseline to the given findings' keys (sorted,
    deduplicated).  A run's coverage is (rule × file), and the rewrite
    is scoped to exactly that: an existing entry is preserved when its
    file is OUTSIDE ``linted_files`` OR its rule is OUTSIDE
    ``rules_run`` — an ``--update-baseline`` over a path subset or a
    ``--rule`` filter must never silently retire reviewed suppressions
    it did not re-examine (a ``--rule HL001`` pass produces no HL003
    findings, which is absence of evidence, not a fixed violation).
    ``None`` for either means that axis was fully covered (a
    full-fileset, all-rules run owns every entry).  Returns the entry
    count."""
    entries = {f.key() for f in findings}
    for e in load_baseline(path):
        examined_file = (
            linted_files is None or entry_path(e) in linted_files
        )
        examined_rule = (
            rules_run is None or entry_rule(e) in rules_run
        )
        if not (examined_file and examined_rule):
            entries.add(e)
    entries = sorted(entries)
    Path(path).write_text(
        json.dumps(
            {"version": BASELINE_VERSION, "entries": entries}, indent=1
        )
        + "\n"
    )
    return len(entries)
