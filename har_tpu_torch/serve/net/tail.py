"""Continuous journal tailing: the journal-ship protocol pointed at a
moving target.

``fetch_journal`` (serve/net/ship.py) ships a DEAD worker's journal at
failover time — correct, but the failover latency then carries the
whole transfer (``ship_ms`` dominates the ``journal_ship`` bench
lane).  This module reuses the same durable machinery — the fsynced
``ship.log``, idempotent-by-offset chunk pulls, whole-file sha256
verdicts — to follow a LIVE worker's journal continuously, so that by
the time a failover needs the bytes they are already local and the
failover path transfers ~0.

What changes when the source is alive, and how each case is handled:

  the active segment grows    the highest-index ``wal.<k>.log`` is
              append-only; each pass pulls the suffix ``[durable_off,
              manifest_size)`` into ``<name>.part`` and records every
              chunk in ``ship.log``.  The ``.part`` is NEVER renamed
              while tailing — its manifest digest is stale the moment
              it is taken — so a half-tailed destination can never be
              restored by accident (``load_journal``'s
              digest-before-replay guard sees ``ship.log`` without
              ``ship.done`` and refuses);

  sealed files are immutable  snapshot files and all-but-the-highest
              segment never change once listed: they pull exactly like
              a dead ship — digest-verified, renamed into place,
              ``ship_file``-logged;

  the file set changes shape  ``write_snapshot`` rotates to a fresh
              segment and prunes the old ones, always together — so a
              manifest whose FILE NAMES changed marks the one
              re-manifest boundary.  The tail appends a
              ``ship_remanifest`` record (replayed by
              ``ship.replay_ship_log``, which handles every record
              type this module writes), prunes local files the new
              manifest dropped, and keeps durable offsets for files
              that survived (the active segment a snapshot sealed is
              gone from the manifest; its records live on inside the
              new snapshot);

  the source races a pass     a chunk request can lose a race with the
              source's prune (the file vanished under the manifest in
              hand).  That is a STALENESS signal, not corruption: the
              pass ends early and the next cycle re-manifests.

``finalize_tail`` is the failover half: the source is dead and static,
so the remaining suffix (zero bytes when the tail was caught up) pulls
through the same chunk loop, every file's whole-file sha256 verifies
against the final manifest, and only then do ``ship_done`` + the done
marker land — from that instant the destination restores through the
unchanged ``FleetServer.restore`` path, guard on.  A destination that
holds a PRE-replication ``ship.log`` (the cold-ship failover path died
mid-fetch) finalizes identically: the record vocabulary is shared, so
the tailing client IS the resume path for old logs.

Chaos points (declared in ``serve/chaos.py``, TAIL_KILL_POINTS):
``mid_tail_recv`` between chunk pulls (the standby dies mid-tail and
must resume from ``ship.log`` without re-pulling a durable byte),
``mid_tail_remanifest`` at the re-manifest boundary, and
``post_tail_verify`` after finalize's digests verify but before
``ship_done`` (the retry must be idempotent).

Port of ``har_tpu/serve/net/tail.py`` (stdlib, copied).
"""

from __future__ import annotations

import os
import shutil
from typing import Callable

from har_tpu_torch.serve.journal import (
    SHIP_DONE,
    SHIP_LOG,
    _SEG_PREFIX,
    _SEG_SUFFIX,
    _SNAP_PREFIX,
)
from har_tpu_torch.serve.net.ship import (
    DEFAULT_CHUNK_BYTES,
    ShipError,
    ShipUnavailable,
    _check_rel,
    _sha256,
    _ShipJournal,
    _write_done_marker,
    journal_manifest,
    replay_ship_log,
)
from har_tpu_torch.utils.durable import fsync_dir


class LocalShipSource:
    """The ``ShipClient`` read surface over a locally visible root of
    journal directories — no RPC, no agent process.  The in-process
    chaos cells (``serve/chaos.py``) and the unit tests tail through
    this, so the tail/finalize logic is exercised identically whether
    the bytes cross a socket or not; it also models the shared-disk
    deployment where a standby can read the workers' journals
    directly but still wants the durable-resume + digest discipline."""

    def __init__(self, root: str):
        self.root = os.path.abspath(os.path.expanduser(root))

    def _dir(self, name) -> str:
        path = os.path.join(self.root, _check_rel(str(name)))
        if not os.path.isdir(path):
            raise ShipError(f"no journal directory {name!r} under "
                            f"{self.root}")
        return path

    def list(self) -> list[dict]:
        dirs = []
        for name in sorted(os.listdir(self.root)):
            path = os.path.join(self.root, name)
            if not os.path.isdir(path):
                continue
            holds_journal = any(
                n.startswith((_SEG_PREFIX, _SNAP_PREFIX))
                for n in os.listdir(path)
            )
            if holds_journal:
                dirs.append({"name": name, "retired": False})
        return dirs

    def retired(self, src: str) -> bool:
        return False

    def manifest(self, src: str) -> list[dict]:
        return journal_manifest(self._dir(src))

    def chunk(self, src: str, f: str, off: int, n: int):
        path = os.path.join(self._dir(src), _check_rel(str(f)))
        try:
            with open(path, "rb") as fh:
                fh.seek(int(off))
                data = fh.read(int(n))
            size = os.path.getsize(path)
        except OSError as exc:
            # the file vanished under the manifest (the source pruned
            # at a rotation): same taxonomy as the agent's refusal
            raise ShipError(f"local ship source: {exc}") from exc
        return (
            {"f": f, "off": int(off), "n": len(data),
             "eof": int(off) + len(data) >= size},
            data,
        )

    def close(self) -> None:
        pass


# ------------------------------------------------------ manifest shape


def _segment_index(rel: str) -> int | None:
    """``wal.<k>.log`` -> k; None for snapshot files."""
    if not (rel.startswith(_SEG_PREFIX) and rel.endswith(_SEG_SUFFIX)):
        return None
    try:
        return int(rel[len(_SEG_PREFIX):-len(_SEG_SUFFIX)])
    except ValueError:
        return None


def manifest_base(names) -> int:
    """The snapshot rotation index a manifest is anchored at — the
    re-manifest boundary's identity."""
    for rel in names:
        head = rel.split("/", 1)[0]
        if head.startswith(_SNAP_PREFIX):
            try:
                return int(head[len(_SNAP_PREFIX):])
            except ValueError:
                continue
    return -1


def _active_segment(names) -> str | None:
    """The highest-index segment — the one file a live source still
    appends to; everything else in the manifest is immutable."""
    best, best_idx = None, -1
    for rel in names:
        idx = _segment_index(rel)
        if idx is not None and idx > best_idx:
            best, best_idx = rel, idx
    return best


def staged_bytes(dest: str, names) -> int:
    """Locally landed bytes of the manifest's files (finals plus
    ``.part`` tails) — the numerator of the lag_bytes gauge."""
    total = 0
    for rel in names:
        final = os.path.join(dest, rel)
        if os.path.exists(final):
            total += os.path.getsize(final)
        elif os.path.exists(final + ".part"):
            total += os.path.getsize(final + ".part")
    return total


def _prune_tail(dest: str, names) -> None:
    """Drop local files the new manifest no longer lists (the sealed
    segment a snapshot superseded, the previous snapshot's dir) —
    everything except the ship log itself and the done marker."""
    keep = set(names) | {SHIP_LOG, SHIP_DONE}
    keep_heads = {rel.split("/", 1)[0] for rel in keep}
    for name in sorted(os.listdir(dest)):
        path = os.path.join(dest, name)
        if os.path.isdir(path):
            if name not in keep_heads:
                shutil.rmtree(path, ignore_errors=True)
            continue
        rel = name[:-5] if name.endswith(".part") else name
        if rel not in keep:
            try:
                os.remove(path)
            except OSError:
                pass


# ----------------------------------------------------------- the pulls


def _pull_file(source, src, name, target, dest, ship_journal, off,
               chunk_bytes, _chaos, stats, out) -> int:
    """Chunk-pull ``name`` up to byte ``target`` into ``name + .part``,
    recording each landed chunk durably — the shared loop under tailing
    and finalize.  Bytes past the durable offset (a crash between the
    write and its record) are truncated first, exactly like
    ``_fetch_file``; returns the new durable offset."""
    part = os.path.join(dest, name) + ".part"
    with open(part, "ab") as fh:
        if fh.tell() > off:
            fh.truncate(off)
        while off < target:
            _chaos("mid_tail_recv")
            meta, payload = source.chunk(
                src, name, off, min(chunk_bytes, target - off)
            )
            if (
                meta.get("f") != name
                or int(meta.get("off", -1)) != off
                or int(meta.get("n", -1)) != len(payload)
            ):
                raise ShipUnavailable(
                    f"mis-sequenced tail chunk for {name!r}: asked "
                    f"off={off}, got {meta}"
                )
            if not payload:
                # shorter than the manifest in hand: the source moved
                # on (pruned/rotated) — staleness, not corruption
                raise ShipError(
                    f"short read tailing {name!r} at off={off} — the "
                    "manifest went stale under the pass"
                )
            fh.write(payload)
            fh.flush()
            os.fsync(fh.fileno())
            ship_journal.append(
                {"t": "ship_chunk", "f": name, "off": off,
                 "n": len(payload)}
            )
            off += len(payload)
            out["bytes"] += len(payload)
            out["chunks"] += 1
            if stats is not None:
                stats.shipped_bytes += len(payload)
                stats.ship_chunks += 1
    return off


def _land_immutable(source, src, entry, dest, ship_journal, prog,
                    chunk_bytes, _chaos, stats, out) -> None:
    """Pull + verify + rename one immutable manifest entry (snapshot
    file or sealed segment).  A refused digest voids the durable
    progress (``ship_void``) so the next pass re-pulls from zero —
    tailing retries across passes instead of spinning inside one."""
    name = entry["f"]
    final = os.path.join(dest, name)
    parent = os.path.dirname(final)
    if parent != dest:
        os.makedirs(parent, exist_ok=True)
    if (
        os.path.exists(final)
        and os.path.getsize(final) == int(entry["size"])
        and _sha256(final) == entry["sha256"]
    ):
        # crashed between the rename and its log record
        ship_journal.append({"t": "ship_file", "f": name})
        return
    off = _pull_file(
        source, src, name, int(entry["size"]), dest, ship_journal,
        prog.offsets.get(name, 0), chunk_bytes, _chaos, stats, out,
    )
    part = final + ".part"
    if _sha256(part) == entry["sha256"]:
        os.replace(part, final)
        fsync_dir(os.path.dirname(final))
        ship_journal.append({"t": "ship_file", "f": name})
        out["files"] += 1
        return
    try:
        os.remove(part)
    except OSError:
        pass
    ship_journal.append({"t": "ship_void", "f": name})
    raise ShipError(
        f"tailed copy of {name!r} failed its whole-file digest — "
        "voided; the next pass re-pulls it from offset 0"
    )


# ------------------------------------------------------------- tailing


def tail_once(
    source,
    src: str,
    dest: str,
    *,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    chaos: Callable[[str], None] | None = None,
    stats=None,
) -> dict:
    """One tailing pass: re-manifest if the source's file set changed
    shape, land any immutable files, pull the active segment's suffix.
    Returns ``{bytes, chunks, files, remanifests, stale, base,
    manifest_bytes, staged_bytes}`` — ``stale`` means the pass lost a
    race with the source (it rotated mid-pass) and the next cycle will
    re-manifest; every byte that DID land is durable regardless.
    Raises ``ShipUnavailable`` only when the source is unreachable
    outright (the standby parks that source and retries next cycle)."""
    os.makedirs(dest, exist_ok=True)

    def _chaos(point: str) -> None:
        if chaos is not None:
            chaos(point)

    out = {"bytes": 0, "chunks": 0, "files": 0, "remanifests": 0,
           "stale": False, "base": -1, "manifest_bytes": 0,
           "staged_bytes": 0}
    manifest = source.manifest(src)
    names = [e["f"] for e in manifest]
    out["base"] = manifest_base(names)
    out["manifest_bytes"] = sum(int(e["size"]) for e in manifest)
    prog = replay_ship_log(dest)
    ship_journal = _ShipJournal(dest)
    try:
        if prog.manifest is None:
            ship_journal.append(
                {"t": "ship_begin", "src": src, "files": manifest}
            )
        elif [e["f"] for e in prog.manifest] != names:
            # the one point where a live source changes shape: a
            # snapshot rotated the segment set (write_snapshot pairs
            # them by construction)
            _chaos("mid_tail_remanifest")
            ship_journal.append(
                {"t": "ship_remanifest", "src": src, "files": manifest}
            )
            _prune_tail(dest, names)
            keep = set(names)
            prog.offsets = {
                f: o for f, o in prog.offsets.items() if f in keep
            }
            prog.done_files = {
                f for f in prog.done_files if f in keep
            }
            out["remanifests"] = 1
        active = _active_segment(names)
        try:
            for entry in manifest:
                name = _check_rel(entry["f"])
                if name in prog.done_files:
                    continue
                if name == active:
                    # append-only: pull the suffix, never finalize —
                    # the manifest digest of a growing file is stale
                    # by the time it arrives
                    _pull_file(
                        source, src, name, int(entry["size"]), dest,
                        ship_journal, prog.offsets.get(name, 0),
                        chunk_bytes, _chaos, stats, out,
                    )
                else:
                    _land_immutable(
                        source, src, entry, dest, ship_journal, prog,
                        chunk_bytes, _chaos, stats, out,
                    )
        except ShipError as exc:
            if isinstance(exc, ShipUnavailable):
                raise
            out["stale"] = True
    finally:
        ship_journal.close()
    out["staged_bytes"] = staged_bytes(dest, names)
    return out


def finalize_tail(
    source,
    src: str,
    dest: str,
    *,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    chaos: Callable[[str], None] | None = None,
    stats=None,
    reships: int = 2,
) -> dict:
    """Failover completion over a (possibly partial, possibly empty)
    tail: the source is dead and its manifest final, so pull whatever
    suffix is still missing, verify EVERY file's whole-file sha256
    against the final manifest, land ``ship_done`` + the done marker.
    ``out["bytes"]`` is the failover-path transfer — ZERO for a
    caught-up tail, the missing suffix otherwise, the whole journal
    when no standby ever tailed (which makes this a superset of
    ``fetch_journal``'s resume semantics: a cold-ship log finalizes
    here unchanged).  Idempotent under crash-and-retry at every
    boundary; ``ShipError`` after the re-ship budget means the source
    is provably corrupt and is a refusal to restore."""
    os.makedirs(dest, exist_ok=True)

    def _chaos(point: str) -> None:
        if chaos is not None:
            chaos(point)

    out = {"bytes": 0, "chunks": 0, "files": 0, "resumes": 0}
    prog = replay_ship_log(dest)
    if prog.done:
        _write_done_marker(dest)
        return out
    manifest = source.manifest(src)
    names = [e["f"] for e in manifest]
    ship_journal = _ShipJournal(dest)
    try:
        if prog.manifest is None:
            ship_journal.append(
                {"t": "ship_begin", "src": src, "files": manifest}
            )
        else:
            out["resumes"] = 1
            if [e["f"] for e in prog.manifest] != names:
                # the worker snapshotted after the last cycle and died
                # before another ran: adopt the final shape
                ship_journal.append(
                    {"t": "ship_remanifest", "src": src,
                     "files": manifest}
                )
                _prune_tail(dest, names)
                keep = set(names)
                prog.offsets = {
                    f: o for f, o in prog.offsets.items() if f in keep
                }
                prog.done_files = {
                    f for f in prog.done_files if f in keep
                }
        for entry in manifest:
            name = _check_rel(entry["f"])
            if name in prog.done_files:
                continue
            final = os.path.join(dest, name)
            parent = os.path.dirname(final)
            if parent != dest:
                os.makedirs(parent, exist_ok=True)
            if (
                os.path.exists(final)
                and os.path.getsize(final) == int(entry["size"])
                and _sha256(final) == entry["sha256"]
            ):
                ship_journal.append({"t": "ship_file", "f": name})
                continue
            off = prog.offsets.get(name, 0)
            attempts = 0
            while True:
                off = _pull_file(
                    source, src, name, int(entry["size"]), dest,
                    ship_journal, off, chunk_bytes, _chaos, stats, out,
                )
                part = final + ".part"
                if _sha256(part) == entry["sha256"]:
                    os.replace(part, final)
                    fsync_dir(os.path.dirname(final))
                    ship_journal.append({"t": "ship_file", "f": name})
                    break
                attempts += 1
                try:
                    os.remove(part)
                except OSError:
                    pass
                ship_journal.append({"t": "ship_void", "f": name})
                off = 0
                if attempts > reships:
                    raise ShipError(
                        f"finalized copy of {name!r} failed its "
                        f"whole-file digest {attempts} time(s) — the "
                        "source is corrupt; refusing to restore from it"
                    )
            out["files"] += 1
        # every digest green, nothing durable says so yet: the crash
        # window the post_tail_verify kill point lands in — a retry
        # re-verifies the already-local files and pulls zero bytes
        _chaos("post_tail_verify")
        ship_journal.append({"t": "ship_done"})
    finally:
        ship_journal.close()
    _write_done_marker(dest)
    return out
