"""Crash-safe durability for the fleet serving engine: an append-only,
fsync-batched write-ahead journal plus periodic state snapshots.

The engine is fault-tolerant *while alive* (retry ladders,
zero-drop swaps, contained registry I/O) — and kept every byte of it in
process memory, so one SIGKILL would erase a 1,000-session fleet.
Spark's core robustness claim is exactly that missing property:
lineage-based recomputation after worker loss.  This module is the
JAX-side equivalent, shaped for a serving loop instead of an RDD DAG:

  - ``FleetJournal`` — an append-only log of fleet MUTATIONS (session
    add/remove, pushed samples, scored-event acks, drops, declared
    losses, swap records, adaptation transitions).  Records are
    buffered in memory and written+fsynced in batches
    (``JournalConfig.flush_every``) plus at every ack boundary — so a
    kill loses AT MOST the un-flushed suffix, never a torn or
    reordered prefix;
  - periodic SNAPSHOTS of full per-session state (ring buffers,
    smoother state, drift-monitor state, queued windows, stats
    counters, adaptation episode state) written atomically
    (tmp + fsync + rename + dir fsync) with the journal rotated to a
    fresh segment — recovery cost is bounded by the snapshot cadence,
    not the fleet's lifetime;
  - recovery (har_tpu_torch.serve.recover) = load newest snapshot + replay
    the journal suffix.  The binary framing is torn-tail-safe: each
    record carries its length and a CRC, so a record half-written at
    the kill instant is detected and discarded instead of corrupting
    the replay.

Durability contract (test-pinned by the kill-point chaos harness,
har_tpu_torch.serve.chaos):

  - an event DELIVERED to the consumer has its ack on disk (poll()
    flushes acks before returning), so recovery never re-emits it —
    zero double-scored, zero double-counted events;
  - a window enqueued but not acked is recovered as pending and scored
    after restart — with a deterministic model, bit-identically to an
    uninterrupted run.  That includes windows riding an in-flight
    dispatch ticket (the pipelined launch/retire split,
    har_tpu_torch.serve.dispatch): acks are written at RETIRE, so a ticket in
    flight at the kill instant is un-acked by construction, and a
    snapshot taken while it flies serializes its windows as ordinary
    pending — pipelining never changes what a crash can lose;
  - windows whose push records never reached disk are re-deliverable
    from the recovered per-session watermark (``FleetServer.
    watermark``); a transport that cannot replay declares them lost
    (``FleetServer.declare_lost``) and the accounting extends to
    ``enqueued == scored + dropped + pending + lost_in_crash``, with
    ``lost_in_crash`` bounded by the flush interval.

Record framing (little-endian):

    u32 meta_len | u32 payload_len | u32 crc32(meta+payload)
    | meta (UTF-8 JSON) | payload (raw bytes, usually float arrays)

Directory layout::

    root/
      wal.<k>.log     journal segments; <k> bumps at every snapshot
      snap.<k>/       snapshot covering everything before wal.<k>.log
        state.json    scalars + per-session metadata + stats + extras
        arrays.npz    ring buffers, pending windows, smoother arrays

Session ids must be JSON-round-trippable (str or int) to be journaled —
a tuple id would come back as a list and break ack matching.

Port of ``har_tpu/serve/journal.py`` (copied): the framing, the record
meta and the snapshot files are byte-compatible with the JAX package's
in both directions (tests/test_torch_fleet_recovery.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import struct
import zlib
from typing import Callable

import numpy as np

from har_tpu_torch.utils.durable import fsync_dir as _fsync_dir

_HDR = struct.Struct("<III")
_SEG_PREFIX = "wal."
_SEG_SUFFIX = ".log"
_SNAP_PREFIX = "snap."
_STATE = "state.json"
_ARRAYS = "arrays.npz"
# journal-ship receive-side markers (har_tpu.serve.net.ship): a shipped
# copy of a journal directory carries SHIP_LOG (the durable chunk log)
# for its whole life and SHIP_DONE only once every file's whole-file
# digest verified.  load_journal refuses the in-between state — the
# digest-before-replay rule lives HERE, at the replay layer, so no
# caller can restore a torn or bit-rotted ship by accident.
SHIP_LOG = "ship.log"
SHIP_DONE = "ship.done"

# the on-disk format version, stamped into every snapshot: a future
# layout change bumps it and keeps this loader working on old dirs
JOURNAL_FORMAT = 1


class JournalError(RuntimeError):
    """Journal directory unreadable or internally inconsistent."""


@dataclasses.dataclass(frozen=True)
class JournalConfig:
    """Durability/cost knobs for a FleetJournal."""

    # records buffered before an automatic write+fsync; poll() forces a
    # flush at every ack boundary regardless, so this bounds how many
    # PUSH records (the loss window) a kill can erase
    flush_every: int = 64
    # records appended between automatic snapshots (0 = only the
    # attach-time snapshot and explicit snapshot() calls) — bounds
    # recovery replay cost, not durability
    snapshot_every: int = 4096
    # fsync on flush: the durability claim needs it; tests that only
    # exercise replay logic may turn it off for speed
    fsync: bool = True

    def __post_init__(self):
        if self.flush_every < 1:
            raise ValueError("flush_every must be >= 1")
        if self.snapshot_every < 0:
            raise ValueError("snapshot_every must be >= 0")


def encode_record(meta: dict, payload: bytes = b"") -> bytes:
    m = json.dumps(meta, separators=(",", ":")).encode()
    crc = zlib.crc32(m + payload) & 0xFFFFFFFF
    return _HDR.pack(len(m), len(payload), crc) + m + payload


def read_segment(path: str) -> tuple[list[tuple[dict, bytes]], bool]:
    """Decode one segment file; returns (records, torn_tail).  A
    truncated or CRC-failing record ends the read — that is the normal
    signature of a kill mid-write, not an error."""
    records: list[tuple[dict, bytes]] = []
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as exc:
        raise JournalError(f"unreadable journal segment {path}: {exc}")
    pos, n = 0, len(data)
    while pos + _HDR.size <= n:
        meta_len, payload_len, crc = _HDR.unpack_from(data, pos)
        end = pos + _HDR.size + meta_len + payload_len
        if end > n:
            return records, True  # torn tail: record half-written
        body = data[pos + _HDR.size : end]
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            return records, True
        try:
            meta = json.loads(body[:meta_len].decode())
        except ValueError:
            return records, True
        records.append((meta, body[meta_len:]))
        pos = end
    return records, pos < n


def read_segment_from(
    path: str, offset: int
) -> tuple[list[tuple[dict, bytes]], int]:
    """Incremental segment read for the replication tail
    (har_tpu.serve.replica): decode every complete record at or after
    ``offset`` and return (records, next_offset) — the byte cursor just
    past the last decodable record, the resume point for the next pass.
    A torn or half-staged tail simply ends the read (the cursor stays
    before it); the next pass re-reads from there once more bytes land.
    Same framing walk as ``read_segment`` — the two cannot disagree on
    what a record is."""
    records: list[tuple[dict, bytes]] = []
    try:
        with open(path, "rb") as f:
            f.seek(int(offset))
            data = f.read()
    except OSError as exc:
        raise JournalError(f"unreadable journal segment {path}: {exc}")
    pos, n = 0, len(data)
    while pos + _HDR.size <= n:
        meta_len, payload_len, crc = _HDR.unpack_from(data, pos)
        end = pos + _HDR.size + meta_len + payload_len
        if end > n:
            break
        body = data[pos + _HDR.size : end]
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            break
        try:
            meta = json.loads(body[:meta_len].decode())
        except ValueError:
            break
        records.append((meta, body[meta_len:]))
        pos = end
    return records, int(offset) + pos


class FleetJournal:
    """Append-only fleet mutation log + snapshot writer.

    ``chaos`` is the kill-point hook: the engine (and the adaptation
    controller) call ``journal.chaos_point(name)`` at every stage
    boundary; the chaos harness installs a callable that raises a
    simulated crash at a chosen point, and ``kill()`` then models the
    SIGKILL — the un-flushed buffer is discarded, exactly what the
    kernel would have lost.
    """

    def __init__(self, root: str, config: JournalConfig | None = None):
        self.root = os.path.abspath(os.path.expanduser(root))
        self.config = config or JournalConfig()
        os.makedirs(self.root, exist_ok=True)
        self.chaos: Callable[[str], None] | None = None
        # storage fault hook: called with the operation name ("write" /
        # "fsync" / "snapshot") right before the real syscall; a test
        # hook raises OSError (ENOSPC, EIO) there to model a failing
        # disk.  The ENGINE owns the containment policy (count + warn +
        # keep serving, har_tpu_torch.serve.engine); this layer only makes a
        # failed flush RETRY-SAFE (see flush()).
        self.fault: Callable[[str], None] | None = None
        self._buf: list[bytes] = []
        self._since_snapshot = 0
        self._segment = self._next_segment_index()
        self._fh = open(self._segment_path(self._segment), "ab")
        # retry-safety bookkeeping: the segment offset below which every
        # byte is a COMPLETE written record (bytes past it are the torn
        # tail of an in-flight failed write — the rewind target), and
        # whether written-but-unsynced bytes still need an fsync (a
        # failed fsync must be retried even when the record buffer is
        # empty).  The rewind target must advance on write success, NOT
        # after the fsync: once the buffer is cleared the file is the
        # records' only home, and a later failed-write rewind past them
        # would lose acks a healed journal then claims are durable.
        self._written_off = self._fh.tell()
        self._sync_pending = False
        self._killed = False

    # ----------------------------------------------------- file layout

    def _segment_path(self, k: int) -> str:
        return os.path.join(self.root, f"{_SEG_PREFIX}{k}{_SEG_SUFFIX}")

    def _snap_path(self, k: int) -> str:
        return os.path.join(self.root, f"{_SNAP_PREFIX}{k}")

    def _next_segment_index(self) -> int:
        return max(
            (idx for _, idx in _list_indexed(self.root, _SEG_PREFIX)),
            default=-1,
        ) + 1

    # ------------------------------------------------------- appending

    def chaos_point(self, name: str) -> None:
        if self.chaos is not None:
            self.chaos(name)

    def append(self, meta: dict, payload: bytes = b"") -> None:
        if self._killed:
            return
        self._buf.append(encode_record(meta, payload))
        self._since_snapshot += 1
        if len(self._buf) >= self.config.flush_every:
            self.flush()

    def _fault(self, op: str) -> None:
        if self.fault is not None:
            self.fault(op)

    def flush(self) -> None:
        """Write + fsync the buffered records: everything appended so
        far is durable once this returns.

        RETRY-SAFE under storage faults: a failed WRITE (ENOSPC mid-
        record) truncates the segment back to the last complete-record
        offset before re-raising, so the retry cannot leave a torn
        record in the MIDDLE of the log (the torn-tail framing only
        protects the end — records appended after an interior tear
        would be silently unreachable at replay); a failed FSYNC keeps
        the sync-pending flag set, so the next flush re-fsyncs even
        when no new records arrived.  The rewind target advances with
        the WRITE, not the fsync: records whose write landed but whose
        fsync failed live only in the file (the buffer is cleared), so
        a later failed-write rewind must stop short of them.  The
        caller (the engine's containment path) decides whether a
        failure is fatal."""
        if self._killed:
            return
        if self._buf:
            data = b"".join(self._buf)
            try:
                self._fault("write")
                self._fh.write(data)
                self._fh.flush()
            except OSError:
                # rewind to the complete-record prefix: shrinking needs
                # no disk space, so this succeeds even on a full disk;
                # if the handle itself is broken the torn tail stays —
                # and the framing discards it at replay like any kill
                # tear
                try:
                    self._fh.truncate(self._written_off)
                    self._fh.seek(self._written_off)
                except OSError:
                    pass
                raise
            self._buf.clear()
            self._written_off = self._fh.tell()
            self._sync_pending = True
        if self._sync_pending and self.config.fsync:
            self._fault("fsync")
            os.fsync(self._fh.fileno())
        self._sync_pending = False

    @property
    def pending_records(self) -> int:
        return len(self._buf)

    def has_state(self) -> bool:
        """True when the directory already holds a recoverable journal
        (at least one complete snapshot) — what a fresh attach must
        refuse to silently destroy."""
        return bool(_list_indexed(self.root, _SNAP_PREFIX))

    def snapshot_due(self) -> bool:
        return (
            self.config.snapshot_every > 0
            and self._since_snapshot >= self.config.snapshot_every
        )

    # ------------------------------------------------------- snapshots

    def write_snapshot(self, state: dict, arrays: dict) -> str:
        """Atomically persist a full-state snapshot and rotate to a
        fresh segment.  Crash-ordering: the snapshot only becomes
        visible (rename + dir fsync) after its contents are on disk,
        and old segments are deleted only after that — a kill at ANY
        instant leaves either the old snapshot+segments or the new
        ones, never neither."""
        self.flush()
        self._fault("snapshot")
        nxt = self._segment + 1
        snap = self._snap_path(nxt)
        tmp = snap + ".tmp"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        state = dict(state)
        state["journal_format"] = JOURNAL_FORMAT
        state["segment"] = nxt
        with open(os.path.join(tmp, _ARRAYS), "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, _STATE), "w") as f:
            json.dump(state, f)
            f.flush()
            os.fsync(f.fileno())
        self.chaos_point("mid_snapshot")
        # failure-ordered rotation: the NEW segment opens BEFORE the
        # snapshot becomes visible, and the old handle closes only
        # after both succeeded — a failing open (full disk) aborts
        # with the old snapshot + old segment + live handle fully
        # intact (the engine's containment can keep appending), and a
        # failing rename leaves only a harmless empty wal.<nxt>.
        # Committing the snapshot BEFORE the segment rotated would be
        # worse than no snapshot: load_journal reads segments >= the
        # snapshot's index, so records still landing in the OLD
        # segment would silently vanish from replay.
        new_fh = open(self._segment_path(nxt), "ab")
        try:
            os.replace(tmp, snap)
            _fsync_dir(self.root)
        except BaseException:
            new_fh.close()
            try:
                os.remove(self._segment_path(nxt))
            except OSError:
                pass
            raise
        self._fh.close()
        self._segment = nxt
        self._fh = new_fh
        self._written_off = self._fh.tell()
        self._sync_pending = False
        self._since_snapshot = 0
        self.prune()
        return snap

    def prune(self) -> None:
        """Delete journal state the newest rotation supersedes: segments
        and snapshots below the current rotation point, and any torn
        ``*.tmp`` snapshot directory a mid-snapshot kill left behind.
        A torn tmp is invisible to recovery by construction
        (``_list_indexed`` skips ``.tmp`` names, so ``load_journal``
        never reads it) but each one holds a full state copy — a fleet
        that crashes inside snapshots for a week must not fill the disk
        with them.  Pinned in tests/test_recovery.py."""
        for path, idx in _list_indexed(self.root, _SEG_PREFIX):
            if idx < self._segment:
                try:
                    os.remove(path)
                except OSError:
                    pass
        for path, idx in _list_indexed(self.root, _SNAP_PREFIX):
            if idx < self._segment:
                shutil.rmtree(path, ignore_errors=True)
        for name in sorted(os.listdir(self.root)):
            if not name.endswith(".tmp"):
                continue
            path = os.path.join(self.root, name)
            # never the in-progress tmp: prune runs only from
            # write_snapshot AFTER its rename, or between snapshots
            if os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
            else:
                try:
                    os.remove(path)
                except OSError:
                    pass

    # ------------------------------------------------------ lifecycle

    def kill(self) -> None:
        """Simulate SIGKILL: drop the un-flushed buffer and abandon the
        file handle.  What is on disk afterwards is exactly what a real
        kill would have left (the chaos harness's crash model)."""
        self._killed = True
        self._buf.clear()
        try:
            self._fh.close()
        except OSError:
            pass

    def close(self) -> None:
        self.flush()
        self._killed = True
        try:
            self._fh.close()
        except OSError:
            pass


def _list_indexed(root: str, prefix: str) -> list[tuple[str, int]]:
    out = []
    for name in os.listdir(root):
        if not name.startswith(prefix) or name.endswith(".tmp"):
            continue
        stem = name[len(prefix):]
        if stem.endswith(_SEG_SUFFIX):
            stem = stem[: -len(_SEG_SUFFIX)]
        try:
            out.append((os.path.join(root, name), int(stem)))
        except ValueError:
            continue
    return sorted(out, key=lambda t: t[1])


def monitor_state(monitor) -> dict | None:
    """None-tolerant wrapper over ``DriftMonitor.state()`` — the
    serialization itself lives on the monitor class, next to the fields
    it depends on."""
    return None if monitor is None else monitor.state()


def monitor_from_state(state: dict | None):
    """None-tolerant wrapper over ``DriftMonitor.from_state``."""
    if state is None:
        return None
    from har_tpu_torch.monitoring import DriftMonitor

    return DriftMonitor.from_state(state)


def load_journal(
    root: str, *, inflight_ship_ok: bool = False
) -> tuple[dict, dict, list[tuple[dict, bytes]]]:
    """Read a journal directory back: (snapshot_state, snapshot_arrays,
    suffix_records).  The newest COMPLETE snapshot wins (a mid-snapshot
    kill leaves a ``.tmp`` dir, ignored by construction); the suffix is
    every decodable record in segments at or after the snapshot's
    rotation point, torn tails discarded.

    ``inflight_ship_ok`` lifts the partially-shipped-copy refusal for
    the WARM REPLICA only (har_tpu.serve.replica): a standby's tail
    destination carries ``ship.log`` without ``ship.done`` for its
    whole tailing life by design, and its reads are advisory — every
    FAILOVER restore still runs with the guard on, after
    ``finalize_tail`` verified whole-file digests and landed the done
    marker.  Never set this on a recovery path."""
    root = os.path.abspath(os.path.expanduser(root))
    if not os.path.isdir(root):
        raise JournalError(f"no journal directory at {root}")
    if (
        not inflight_ship_ok
        and os.path.exists(os.path.join(root, SHIP_LOG))
        and not os.path.exists(os.path.join(root, SHIP_DONE))
    ):
        raise JournalError(
            f"journal directory {root} is a partially shipped copy "
            "(ship.log without ship.done): the whole-file digests were "
            "never verified — resume the ship "
            "(har_tpu.serve.net.ship.fetch_journal); a torn or "
            "bit-rotted ship is refused, never replayed"
        )
    snaps = _list_indexed(root, _SNAP_PREFIX)
    state: dict = {}
    arrays: dict = {}
    base = 0
    for path, idx in reversed(snaps):
        try:
            with open(os.path.join(path, _STATE)) as f:
                state = json.load(f)
            with np.load(os.path.join(path, _ARRAYS)) as z:
                arrays = {k: z[k] for k in z.files}
        except (OSError, ValueError) as exc:
            raise JournalError(f"unreadable snapshot {path}: {exc}")
        base = idx
        break
    if not state:
        raise JournalError(
            f"no snapshot in {root} — a journaled fleet always writes "
            "one at attach time; is this a journal directory?"
        )
    records: list[tuple[dict, bytes]] = []
    for path, idx in _list_indexed(root, _SEG_PREFIX):
        if idx < base:
            continue
        recs, _torn = read_segment(path)
        records.extend(recs)
    return state, arrays, records
