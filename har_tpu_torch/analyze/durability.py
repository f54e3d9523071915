"""HL005 — durability: the registry and the journal must not bypass
the shared fsync discipline (``har_tpu_torch/utils/durable.py``).

A registry fix is the ancestor of this rule: ``CURRENT`` and
``NEXT_ID`` were once written with a bare ``os.replace``, which orders
the rename against the file's own data but NOT against the parent
directory — after power loss the directory could resurface the old
pointer (or none).  ``utils/durable.py`` now holds the one correct
sequence (tmp → fsync data → rename → fsync dir); this rule keeps
every durable write in the registry/journal modules on it.

Flagged, inside the durability-critical modules only
(``adapt/registry.py``, ``serve/journal.py``, ``utils/durable.py``):

  - an ``open(..., "w"/"a"/"wb"/"ab")`` whose enclosing function
    WRITES through the handle (``.write`` / ``json.dump`` /
    ``np.savez``) but never calls ``os.fsync`` — buffered bytes the
    page cache may still own at the kill instant.  Opens that only
    stash the handle for a later fsynced flush (the journal's segment
    handle) are not flagged;
  - an ``os.replace(...)`` in a function that syncs neither the parent
    directory (``fsync_dir``/``_fsync_dir``) nor routes through the
    durable helpers (``atomic_write``/``durable_append``) — the
    half-atomic rename the module docstring warns about.
"""

from __future__ import annotations

import ast

from har_tpu_torch.analyze.core import (
    FileContext,
    Finding,
    Rule,
    call_name,
    walk_functions,
)

_MODULES = (
    "har_tpu_torch/adapt/registry.py",
    "har_tpu_torch/serve/journal.py",
    "har_tpu_torch/utils/durable.py",
)
_WRITE_MODES = ("w", "a", "wb", "ab", "w+", "a+", "xb", "x")
_WRITE_CALLS = {"write", "dump", "savez", "savez_compressed", "writelines"}
_DIR_SYNC_CALLS = {
    "fsync_dir", "_fsync_dir", "atomic_write", "_atomic_write",
    "durable_append", "_durable_append",
}


def _open_mode(node: ast.Call) -> str | None:
    if len(node.args) >= 2 and isinstance(node.args[1], ast.Constant):
        return str(node.args[1].value)
    for kw in node.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
            return str(kw.value.value)
    return None


class DurabilityRule(Rule):
    rule_id = "HL005"
    title = "durability"

    def applies(self, rel: str) -> bool:
        return rel in _MODULES

    def check(self, ctx: FileContext) -> list[Finding]:
        findings: list[Finding] = []
        for qual, _cls, fn in walk_functions(ctx.tree):
            calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)]
            names = {call_name(n) for n in calls}
            has_fsync = any(
                call_name(n) == "fsync"
                for n in calls
                if isinstance(n.func, ast.Attribute)
            )
            writes = bool(names & _WRITE_CALLS)
            dir_synced = bool(names & _DIR_SYNC_CALLS)
            for n in calls:
                if (
                    isinstance(n.func, ast.Name)
                    and n.func.id == "open"
                    and (_open_mode(n) or "r") in _WRITE_MODES
                    and writes
                    and not has_fsync
                ):
                    findings.append(
                        ctx.finding(
                            self.rule_id,
                            n,
                            f"`open(..., {_open_mode(n)!r})` written "
                            "without an fsync in this function — the "
                            "page cache may still own these bytes at "
                            "the kill instant; route the write through "
                            "har_tpu_torch.utils.durable (atomic_write / "
                            "durable_append)",
                            qual,
                        )
                    )
                elif (
                    isinstance(n.func, ast.Attribute)
                    and n.func.attr == "replace"
                    and isinstance(n.func.value, ast.Name)
                    and n.func.value.id == "os"
                    and not dir_synced
                ):
                    findings.append(
                        ctx.finding(
                            self.rule_id,
                            n,
                            "`os.replace(...)` without a parent-"
                            "directory fsync — after power loss the "
                            "directory can resurface the old entry; "
                            "use utils.durable.atomic_write or follow "
                            "with fsync_dir",
                            qual,
                        )
                    )
        return findings
