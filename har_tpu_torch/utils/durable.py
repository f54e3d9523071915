"""Durable filesystem writes — THE fsync discipline shared by the
model registry (har_tpu.adapt.registry) and the fleet journal
(har_tpu_torch.serve.journal).

``os.replace`` alone only orders the rename against the file's own
data: after a crash the parent directory can still resurface the OLD
entry (or none) unless the directory itself is synced.  Every durable
pointer/log in this codebase goes through one of these three helpers
so the discipline cannot drift between subsystems.

Port of ``har_tpu/utils/durable.py`` (stdlib, copied).
"""

from __future__ import annotations

import os


def fsync_dir(path: str) -> None:
    """fsync a DIRECTORY entry table — the half of atomic-rename
    durability os.replace skips."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # platforms without directory fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write(path: str, data: str) -> None:
    """tmp file → flush+fsync the DATA → rename over the target →
    fsync the PARENT DIRECTORY.  A reader sees the old content or the
    new content, and whichever it sees survives power loss."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path))


def durable_append(path: str, line: str) -> None:
    """Append one line and fsync; the first append also syncs the
    parent directory (the file's dir entry is new)."""
    existed = os.path.exists(path)
    with open(path, "a") as f:
        f.write(line)
        f.flush()
        os.fsync(f.fileno())
    if not existed:
        fsync_dir(os.path.dirname(path))
