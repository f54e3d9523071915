"""Versioned model registry: the lineage store the adaptation loop
promotes into and rolls back from.

``checkpoint.save_model`` / ``save_classical_model`` persist ONE model;
a drift-adaptive fleet needs the family tree: which artifact is serving,
what it was trained on, what it descended from, and what to fall back to
when a promotion regresses.  This registry is that — a plain directory
(no database, inspectable with ``ls`` and ``cat``):

    root/
      versions/v0000001/          one artifact per version: whatever the
        ...                         caller's saver wrote (a neural or
        registry.json               classical checkpoint dir, usually)
      versions/v0000002/
      CURRENT                     atomic pointer (symlink, or a text
                                    file where symlinks don't exist)
      NEXT_ID                     monotone id counter — ids never reuse,
                                    even after prune()
      promotions.jsonl            append-only promote/rollback log: the
                                    evidence trail, and what rollback()
                                    walks to find the prior incumbent

Version ids are MONOTONE (a pruned v3 never comes back as a different
model), ``parent_sha256`` chains each version to the artifact bytes of
the incumbent it was trained to replace, and ``data_fingerprint``
records what it was trained on — so "which windows produced the model
that served Tuesday" is answerable from the directory alone.

Port of ``har_tpu/adapt/registry.py``: the directory layout, pointer,
log and hashes are the JAX package's, so a registry written by either
package reads in the other.  A neural version is the port's checkpoint
(``params.npz``, flax's tree, written from host copies of the weights
wherever the model runs); a classical version is the JAX package's own
files.  ``load_version`` rebuilds a version on the device its caller
names.  ``np.savez`` stamps its zip entries with the time, so two saves
of one model hash apart: a version's ``sha256`` is the hash of the one
save that registered it, and lineage never re-saves a model to compare.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import time
from typing import Callable, Iterable

# the shared fsync discipline (har_tpu_torch.utils.durable): a crash after a
# bare os.replace could surface an empty/old CURRENT or NEXT_ID, and an
# un-synced promotions.jsonl entry would leave rollback() blind to the
# transition it is supposed to walk back
from har_tpu_torch.utils.durable import atomic_write as _atomic_write
from har_tpu_torch.utils.durable import durable_append as _durable_append
from har_tpu_torch.utils.durable import fsync_dir as _fsync_dir

_VERSIONS = "versions"
_CURRENT = "CURRENT"
_NEXT_ID = "NEXT_ID"
_LOG = "promotions.jsonl"
_META = "registry.json"


def data_fingerprint(*arrays) -> str:
    """sha256 over the shapes + bytes of the training arrays — the
    "what was this trained on" stamp.  Order-sensitive by design: the
    same windows in a different order are a different training run."""
    import numpy as np

    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _dir_sha256(path: str) -> str:
    """Deterministic digest of a version dir's artifact bytes (the
    registry's own metadata file excluded — it references this hash)."""
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in sorted(os.walk(path)):
        dirnames.sort()
        for name in sorted(filenames):
            if dirpath == path and name == _META:
                continue
            full = os.path.join(dirpath, name)
            h.update(os.path.relpath(full, path).encode())
            with open(full, "rb") as f:
                for block in iter(lambda: f.read(1 << 20), b""):
                    h.update(block)
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class ModelVersion:
    """One registered model: its directory plus the lineage metadata."""

    version: int
    path: str
    sha256: str
    parent_sha256: str | None
    created_unix: int
    data_fingerprint: str | None
    metrics: dict
    note: str | None

    @property
    def name(self) -> str:
        return f"v{self.version:07d}"


class ModelRegistry:
    """Filesystem model registry with an atomic "current" pointer.

    ``clock`` is injectable (seconds since epoch) so tests produce
    deterministic ``created_unix`` stamps.
    """

    def __init__(self, root: str, *, clock: Callable[[], float] | None = None):
        self.root = os.path.abspath(os.path.expanduser(root))
        # created_unix stamps are MEANT to be wall-clock (lineage
        # records correlate with logs outside the process); the clock
        # stays injectable, so tests are still deterministic
        # harlint: disable=HL004
        self._clock = clock or time.time
        os.makedirs(os.path.join(self.root, _VERSIONS), exist_ok=True)

    # ------------------------------------------------------------ ids

    def _next_id(self) -> int:
        """Allocate the next monotone version id.  Persisted in NEXT_ID
        (atomic tmp+rename) so a pruned id is never reissued; a missing
        counter file (pre-existing registries, manual surgery) falls
        back to max(existing)+1."""
        counter = os.path.join(self.root, _NEXT_ID)
        try:
            with open(counter) as f:
                nxt = int(f.read().strip())
        except (OSError, ValueError):
            existing = [v.version for v in self.versions()]
            nxt = max(existing, default=0) + 1
        _atomic_write(counter, str(nxt + 1))
        return nxt

    # ------------------------------------------------------- registry

    def register(
        self,
        save: Callable[[str], object] | None = None,
        *,
        metrics: dict | None = None,
        data_fingerprint: str | None = None,
        note: str | None = None,
        promote: bool = False,
    ) -> ModelVersion:
        """Allocate a version dir, let ``save(dir)`` write the artifact
        into it, fingerprint the result, and record lineage
        (parent_sha256 = the CURRENT incumbent's artifact hash).

        ``save=None`` registers a metadata-only version (an in-process
        model with no persistent form — e.g. the analytic demo model, or
        a smoke-test stub); it participates in lineage and promotion
        like any other.  ``promote=True`` promotes atomically after
        registering (first version of a fresh registry, typically).
        """
        version = self._next_id()
        cur = self.current()
        path = os.path.join(self.root, _VERSIONS, f"v{version:07d}")
        os.makedirs(path)
        try:
            if save is not None:
                save(path)
            meta = {
                "version": version,
                # metadata-only versions have no artifact bytes to hash;
                # a version-unique sentinel keeps the parent chain
                # non-degenerate (every empty dir hashes identically)
                "sha256": (
                    _dir_sha256(path)
                    if save is not None
                    else f"metadata-only:v{version:07d}"
                ),
                "parent_sha256": None if cur is None else cur.sha256,
                "created_unix": int(self._clock()),
                "data_fingerprint": data_fingerprint,
                "metrics": dict(metrics or {}),
                "note": note,
            }
            # the same fsync discipline as CURRENT/NEXT_ID (harlint
            # HL005): a bare buffered write could leave a promoted
            # version with a torn registry.json after power loss —
            # _load_version would return None and current() would
            # blind the whole lineage chain
            _atomic_write(
                os.path.join(path, _META), json.dumps(meta, indent=1)
            )
        except BaseException:
            shutil.rmtree(path, ignore_errors=True)  # no half-versions
            raise
        mv = self._load_version(path)
        if promote:
            self.promote(version)
        return mv

    def _load_version(self, path: str) -> ModelVersion | None:
        try:
            with open(os.path.join(path, _META)) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            return None  # a half-deleted or foreign dir is not a version
        return ModelVersion(
            version=int(meta["version"]),
            path=path,
            sha256=meta["sha256"],
            parent_sha256=meta.get("parent_sha256"),
            created_unix=int(meta.get("created_unix", 0)),
            data_fingerprint=meta.get("data_fingerprint"),
            metrics=meta.get("metrics", {}),
            note=meta.get("note"),
        )

    def versions(self) -> list[ModelVersion]:
        """All registered versions, ascending."""
        vdir = os.path.join(self.root, _VERSIONS)
        out = []
        for name in sorted(os.listdir(vdir)):
            mv = self._load_version(os.path.join(vdir, name))
            if mv is not None:
                out.append(mv)
        return sorted(out, key=lambda v: v.version)

    def get(self, version: int) -> ModelVersion:
        path = os.path.join(self.root, _VERSIONS, f"v{int(version):07d}")
        mv = self._load_version(path)
        if mv is None:
            raise KeyError(f"no registered version {version}")
        return mv

    # ------------------------------------------------------- pointer

    def current(self) -> ModelVersion | None:
        """The promoted incumbent (None on a fresh registry)."""
        ptr = os.path.join(self.root, _CURRENT)
        if os.path.islink(ptr):
            target = os.readlink(ptr)
        elif os.path.isfile(ptr):
            with open(ptr) as f:
                target = f.read().strip()
        else:
            return None
        return self._load_version(
            os.path.join(self.root, os.path.normpath(target))
        )

    def promote(self, version: int, *, event: str = "promote") -> ModelVersion:
        """Atomically point CURRENT at ``version`` (symlink-or-rename:
        readers see the old pointer or the new one, never a torn state)
        and append the transition to the promotions log."""
        mv = self.get(version)
        prev = self.current()
        ptr = os.path.join(self.root, _CURRENT)
        target = os.path.join(_VERSIONS, mv.name)
        tmp = ptr + ".tmp"
        if os.path.lexists(tmp):
            os.remove(tmp)
        try:
            os.symlink(target, tmp)
        except OSError:
            _atomic_write(ptr, target)  # symlink-less filesystem
        else:
            os.replace(tmp, ptr)
            # a symlink has no data to fsync; the rename's durability
            # lives entirely in the directory entry
            _fsync_dir(self.root)
        _durable_append(
            os.path.join(self.root, _LOG),
            json.dumps(
                {
                    "event": event,
                    "version": mv.version,
                    "from_version": None if prev is None else prev.version,
                    "at_unix": int(self._clock()),
                }
            )
            + "\n",
        )
        return mv

    def rollback(self) -> ModelVersion:
        """Re-promote the version that was serving before the current
        one (from the promotions log), recording the transition as a
        ``rollback`` event.  Raises RuntimeError when there is no prior
        incumbent to fall back to."""
        cur = self.current()
        if cur is None:
            raise RuntimeError("nothing promoted; nothing to roll back")
        prev_version = None
        for line in self._log_lines():
            if line["version"] == cur.version and line["event"] != "rollback":
                prev_version = line["from_version"]
        if prev_version is None:
            raise RuntimeError(
                f"{cur.name} has no recorded predecessor to roll back to"
            )
        return self.promote(prev_version, event="rollback")

    def _log_lines(self) -> Iterable[dict]:
        try:
            with open(os.path.join(self.root, _LOG)) as f:
                return [json.loads(ln) for ln in f if ln.strip()]
        except OSError:
            return []

    def history(self) -> list[dict]:
        """The promote/rollback transitions, oldest first."""
        return list(self._log_lines())

    # --------------------------------------------------------- prune

    def prune(self, keep: int = 5) -> list[int]:
        """Delete the oldest versions beyond ``keep``, never the current
        incumbent or its recorded predecessor (the rollback target must
        survive a prune).  Returns the pruned version ids."""
        cur = self.current()
        protected = set()
        if cur is not None:
            protected.add(cur.version)
            for line in self._log_lines():
                if (
                    line["version"] == cur.version
                    and line["from_version"] is not None
                ):
                    protected.add(line["from_version"])
        versions = self.versions()
        pruned = []
        excess = len(versions) - max(int(keep), 0)
        for mv in versions:
            if excess <= 0:
                break
            if mv.version in protected:
                continue
            shutil.rmtree(mv.path, ignore_errors=True)
            pruned.append(mv.version)
            excess -= 1
        return pruned


# --------------------------------------------------------------------------
# Checkpoint-backed savers: register() plumbing for the two persistence
# families, threading the registry's lineage into the checkpoint meta so
# the artifact is self-describing even outside the registry dir.
# --------------------------------------------------------------------------


def register_neural(
    registry: ModelRegistry,
    model,
    model_name: str,
    *,
    metrics: dict | None = None,
    data_fingerprint: str | None = None,
    promote: bool = False,
    **save_kwargs,
) -> ModelVersion:
    """Register a trained NeuralClassifierModel as a full checkpoint
    (checkpoint.save_model) with lineage stamped into har_meta.json —
    the artifact is self-describing even copied out of the registry.
    The weights are written from host copies, so a model on the card
    registers as it is."""
    from har_tpu_torch.checkpoint import save_model

    cur = registry.current()

    def save(path: str) -> None:
        save_model(
            path,
            model,
            model_name,
            # the allocated dir IS the version name (v%07d)
            version=int(os.path.basename(path)[1:]),
            parent_sha256=None if cur is None else cur.sha256,
            created_unix=int(registry._clock()),
            **save_kwargs,
        )

    return registry.register(
        save,
        metrics=metrics,
        data_fingerprint=data_fingerprint,
        note=f"neural:{model_name}",
        promote=promote,
    )


def register_classical(
    registry: ModelRegistry,
    model,
    *,
    metrics: dict | None = None,
    data_fingerprint: str | None = None,
    promote: bool = False,
    **save_kwargs,
) -> ModelVersion:
    """Register a classical model (checkpoint.save_classical_model)
    with the same lineage stamps."""
    from har_tpu_torch.checkpoint import save_classical_model

    cur = registry.current()

    def save(path: str) -> None:
        save_classical_model(
            path,
            model,
            version=int(os.path.basename(path)[1:]),
            parent_sha256=None if cur is None else cur.sha256,
            created_unix=int(registry._clock()),
            **save_kwargs,
        )

    return registry.register(
        save,
        metrics=metrics,
        data_fingerprint=data_fingerprint,
        note=f"classical:{type(model).__name__}",
        promote=promote,
    )


def load_version(version: ModelVersion | str, device="cuda"):
    """The model a registered version holds, rebuilt on ``device``
    (``cuda`` unless the caller names the CPU): a neural checkpoint
    through ``checkpoint.load_model``, a classical one through
    ``load_classical_model``.  ``version`` is a ModelVersion or its
    directory.  A metadata-only version (registered with ``save=None``)
    has no artifact to load and raises ValueError, as does a JAX neural
    version (an orbax checkpoint, which the port refuses)."""
    from har_tpu_torch.checkpoint import (
        load_classical_model,
        load_model,
        load_model_meta,
    )

    path = version.path if isinstance(version, ModelVersion) else version
    try:
        meta = load_model_meta(path)
    except OSError:
        raise ValueError(
            f"{path} holds no saved model (a metadata-only version)"
        ) from None
    if meta.get("format") == "classical":
        return load_classical_model(path, device)
    return load_model(path, device)
