"""Wire framing + payload codecs for the fleet transport.

The frame format IS the journal's record format
(``har_tpu_torch.serve.journal.encode_record``):

    u32 meta_len | u32 payload_len | u32 crc32(meta+payload)
    | meta (UTF-8 JSON) | payload (raw bytes)

reused deliberately: the payloads that cross the wire — session
exports, scored events, pushed samples — already exist as journal
records (``adopt``/``ack``/``push``), so one framing layer serves the
disk and the socket and the two cannot drift.  What the socket adds
over the disk is an adversarial peer: a frame can arrive torn (TCP
segmentation), corrupted, or absurdly sized, so ``FrameBuffer`` turns
CRC mismatch and oversized lengths into ``FrameError`` (a protocol
violation that kills the connection) instead of the journal reader's
silent torn-tail stop (which is the NORMAL end-of-log signature there).

Codecs mirror the journal record layouts:

  - exports (``encode_export``/``decode_export``): the ``adopt``
    record's shape — scalars + votes + monitor state in the JSON meta,
    ring float32 then EMA float64 concatenated in the payload;
  - events (``encode_events``/``decode_events``): the ``ack`` record's
    shape per event — decision fields in the meta list, probability
    vectors float64-concatenated in the payload;
  - samples (``encode_samples``/``decode_samples``): the ``push``
    record's shape — ``(n, channels)`` float32 rows in the payload.

Numeric fields round-trip through ``tobytes``/``frombuffer`` — exact,
so a migrated stream's bit-identity survives the wire by construction.

Port of ``har_tpu/serve/net/wire.py`` (numpy, copied): frames and codecs
are byte-equal to the JAX package's in both directions, so workers and
controllers of the two packages talk to each other.
"""

from __future__ import annotations

import json
import zlib

import numpy as np

from har_tpu_torch.serve.journal import _HDR, encode_record

# hard per-frame ceiling: the biggest legitimate frame is a push of a
# catch-up burst or a whole-partition poll response — megabytes, not
# gigabytes.  A length field past this is a corrupt or hostile peer and
# the connection dies rather than the allocator.
MAX_FRAME_BYTES = 32 << 20


class FrameError(RuntimeError):
    """Frame-level protocol violation: CRC mismatch, oversized length,
    or undecodable meta.  The connection that produced it is dead."""


def encode_frame(meta: dict, payload: bytes = b"") -> bytes:
    """One wire frame — exactly ``journal.encode_record`` plus the
    size ceiling (a frame we would refuse to read must never be sent)."""
    frame = encode_record(meta, payload)
    if len(frame) > MAX_FRAME_BYTES:
        raise FrameError(
            f"frame of {len(frame)} bytes exceeds MAX_FRAME_BYTES "
            f"({MAX_FRAME_BYTES})"
        )
    return frame


class FrameBuffer:
    """Incremental frame decoder for a TCP byte stream.

    ``feed(chunk)`` appends received bytes; ``next_frame()`` returns
    the oldest complete ``(meta, payload)`` or None — torn frames
    simply wait for more bytes (TCP segmentation is not an error), but
    a CRC mismatch, an oversized length field or undecodable meta is a
    ``FrameError``: on a socket there is no "normal torn tail", only a
    peer that wrote garbage.
    """

    __slots__ = ("_buf", "_skip")

    def __init__(self):
        self._buf = bytearray()
        # bytes of a skipped frame still in flight: dropped at feed()
        # time so a refused payload never accumulates in the buffer
        self._skip = 0

    def feed(self, chunk: bytes) -> None:
        if self._skip:
            if len(chunk) <= self._skip:
                self._skip -= len(chunk)
                return
            chunk = memoryview(chunk)[self._skip :]
            self._skip = 0
        self._buf.extend(chunk)

    def __len__(self) -> int:
        return len(self._buf)

    def peek_header(self):
        """The edge-admission view: ``(meta, payload_len)`` as soon as
        the fixed header + meta bytes have arrived, WITHOUT waiting for
        (or touching) the payload.  This is what lets a gateway refuse
        a frame from its header alone — session count, byte length,
        staleness watermark all ride the meta — before any payload
        decode or allocation happens.  The CRC spans meta+payload and
        therefore cannot be checked yet; an admitted frame still goes
        through ``next_frame``'s full CRC verification, a refused one
        is discarded unverified (worst case a corrupt frame is refused
        as a shed instead of a FrameError — either way it never lands).
        Oversized declared lengths and garbled meta raise FrameError
        exactly like ``next_frame``."""
        buf = self._buf
        if len(buf) < _HDR.size:
            return None
        meta_len, payload_len, _crc = _HDR.unpack_from(buf, 0)
        total = _HDR.size + meta_len + payload_len
        if total > MAX_FRAME_BYTES:
            raise FrameError(
                f"declared frame of {total} bytes exceeds "
                f"MAX_FRAME_BYTES ({MAX_FRAME_BYTES})"
            )
        if len(buf) < _HDR.size + meta_len:
            return None
        try:
            meta = json.loads(
                bytes(buf[_HDR.size : _HDR.size + meta_len]).decode()
            )
        except (ValueError, UnicodeDecodeError) as exc:
            raise FrameError(f"undecodable frame meta: {exc}")
        return meta, payload_len

    def skip_frame(self) -> None:
        """Discard the frame at the head of the buffer without ever
        assembling its payload: bytes already buffered are deleted,
        bytes still in flight are dropped as ``feed`` receives them.
        Only valid after ``peek_header`` returned a header — a refused
        frame costs the edge its header parse, never an allocation."""
        buf = self._buf
        meta_len, payload_len, _crc = _HDR.unpack_from(buf, 0)
        total = _HDR.size + meta_len + payload_len
        have = min(len(buf), total)
        del buf[:have]
        self._skip += total - have

    def next_frame(self):
        buf = self._buf
        if len(buf) < _HDR.size:
            return None
        meta_len, payload_len, crc = _HDR.unpack_from(buf, 0)
        total = _HDR.size + meta_len + payload_len
        if total > MAX_FRAME_BYTES:
            raise FrameError(
                f"declared frame of {total} bytes exceeds "
                f"MAX_FRAME_BYTES ({MAX_FRAME_BYTES})"
            )
        if len(buf) < total:
            return None
        body = bytes(buf[_HDR.size : total])
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            raise FrameError("frame CRC mismatch")
        try:
            meta = json.loads(body[:meta_len].decode())
        except (ValueError, UnicodeDecodeError) as exc:
            raise FrameError(f"undecodable frame meta: {exc}")
        del buf[:total]
        return meta, body[meta_len:]


# --------------------------------------------------------------- codecs


def encode_samples(samples: np.ndarray) -> tuple[dict, bytes]:
    """The ``push`` record layout: float32 rows in the payload, row
    count in the meta (channels are fleet geometry, known both sides)."""
    arr = np.ascontiguousarray(samples, np.float32)
    return {"n": int(arr.shape[0]), "c": int(arr.shape[1])}, arr.tobytes()


def decode_samples(meta: dict, payload: bytes) -> np.ndarray:
    return np.frombuffer(payload, np.float32).reshape(
        int(meta["n"]), int(meta["c"])
    )


def encode_chunk_batch(items, offsets=None) -> tuple[dict, bytes]:
    """Multi-session push codec — one frame per delivery round instead
    of one RPC per session chunk: per-chunk ``{sid, n, c}`` dicts in
    the meta list (the ``push`` record's fields), the float32 sample
    rows concatenated in the payload in delivery order.  The meta's
    ``s`` (session count) and the frame's payload length are exactly
    what the gateway's edge admission reads from the header — a shed
    frame is refused before this payload is ever decoded.

    ``offsets`` (optional, parallel to ``items``) stamps each chunk
    with ``o``: the session-stream sample offset of the chunk's FIRST
    row.  The gateway compares ``o`` against the workers'
    ``watermark(sid)`` to drop already-delivered rows idempotently —
    the dedup that makes a client's post-reconnect re-send lossless
    instead of double-counted."""
    metas: list = []
    chunks: list = []
    for i, (sid, samples) in enumerate(items):
        arr = np.ascontiguousarray(samples, np.float32)
        em = {"sid": sid, "n": int(arr.shape[0]), "c": int(arr.shape[1])}
        if offsets is not None:
            em["o"] = int(offsets[i])
        metas.append(em)
        chunks.append(arr.tobytes())
    return {"chunks": metas, "s": len(metas)}, b"".join(chunks)


def decode_chunk_batch(meta: dict, payload: bytes) -> list:
    """Inverse of ``encode_chunk_batch``: ``[(sid, samples)]`` in
    delivery order.  The sample arrays are zero-copy ``frombuffer``
    views over the received payload — the only copy between the socket
    and the device is the engine's own staging write into its reserved
    ``StagingArena`` slot."""
    out = []
    pos = 0
    view = memoryview(payload)  # slices below are views, not copies
    for em in meta.get("chunks") or []:
        n, c = int(em["n"]), int(em["c"])
        nb = 4 * n * c
        out.append(
            (
                em["sid"],
                np.frombuffer(view[pos : pos + nb], np.float32).reshape(
                    n, c
                ),
            )
        )
        pos += nb
    return out


def encode_drift_reports(items) -> tuple[dict, bytes]:
    """Per-session DriftReport codec: the verdict scalars and the
    ``(generation, onset)`` episode id in the meta, the float64 z /
    log-ratio vectors concatenated in the payload — what ships the
    fleet-global retrain evidence across net workers
    (``NetCluster.observe_drift``).  float64 ``tobytes`` round-trip is
    exact, so the aggregator's thresholds and episode dedup see the
    same numbers on either side of the wire.  Sessions without a
    monitor (report ``None``) are skipped — same contract as
    ``RetrainTrigger.observe_server``."""
    metas: list = []
    chunks: list = []
    for sid, rep in items:
        if rep is None:
            continue
        z = np.ascontiguousarray(rep.location_z, np.float64)
        r = np.ascontiguousarray(rep.scale_log_ratio, np.float64)
        metas.append(
            {
                "sid": sid,
                "dr": bool(rep.drifting),
                "n": int(rep.n_samples),
                "on": None if rep.onset is None else int(rep.onset),
                "gen": int(rep.generation),
                "k": int(z.shape[0]),
            }
        )
        chunks.append(z.tobytes())
        chunks.append(r.tobytes())
    return {"reports": metas}, b"".join(chunks)


def decode_drift_reports(meta: dict, payload: bytes) -> list:
    """Inverse of ``encode_drift_reports``: ``[(sid, DriftReport)]``."""
    from har_tpu_torch.monitoring import DriftReport

    out = []
    pos = 0
    for em in meta.get("reports") or []:
        k = int(em["k"])
        z = np.frombuffer(payload[pos : pos + 8 * k], np.float64)
        pos += 8 * k
        r = np.frombuffer(payload[pos : pos + 8 * k], np.float64)
        pos += 8 * k
        onset = em.get("on")
        out.append(
            (
                em["sid"],
                DriftReport(
                    drifting=bool(em["dr"]),
                    location_z=z,
                    scale_log_ratio=r,
                    n_samples=int(em["n"]),
                    onset=None if onset is None else int(onset),
                    generation=int(em.get("gen", 0)),
                ),
            )
        )
    return out


def encode_export(export: dict) -> tuple[dict, bytes]:
    """Session-export codec — the ``adopt`` journal record's layout:
    scalars/votes/monitor state in the meta, ring float32 then EMA
    float64 in the payload.  ``FleetServer.export_session`` output in,
    ``FleetServer.adopt_session`` input out the other side."""
    ring = np.ascontiguousarray(export["ring"], np.float32)
    ema = export.get("ema")
    payload = ring.tobytes()
    if ema is not None:
        payload += np.ascontiguousarray(ema, np.float64).tobytes()
    meta = {
        "sid": export["sid"],
        "w": int(ring.shape[0]),
        "c": int(ring.shape[1]),
        "n_seen": int(export["n_seen"]),
        "raw_seen": int(export["raw_seen"]),
        "next_emit": int(export["next_emit"]),
        "n_enqueued": int(export.get("n_enqueued", 0)),
        "n_scored": int(export.get("n_scored", 0)),
        "n_dropped": int(export.get("n_dropped", 0)),
        "handoffs": int(export.get("handoffs", 0)),
        "votes": [int(v) for v in export.get("votes") or []],
        "ema": ema is not None,
        "mon": export.get("monitor"),
    }
    return meta, payload


def decode_export(meta: dict, payload: bytes) -> dict:
    window, channels = int(meta["w"]), int(meta["c"])
    ring_bytes = window * channels * 4
    ema = None
    if meta.get("ema"):
        ema = np.frombuffer(payload[ring_bytes:], np.float64)
    return {
        "sid": meta["sid"],
        "ring": np.frombuffer(payload[:ring_bytes], np.float32).reshape(
            window, channels
        ),
        "n_seen": int(meta["n_seen"]),
        "raw_seen": int(meta["raw_seen"]),
        "next_emit": int(meta["next_emit"]),
        "n_enqueued": int(meta.get("n_enqueued", 0)),
        "n_scored": int(meta.get("n_scored", 0)),
        "n_dropped": int(meta.get("n_dropped", 0)),
        "handoffs": int(meta.get("handoffs", 0)),
        "votes": [int(v) for v in meta.get("votes") or []],
        "ema": ema,
        "monitor": meta.get("mon"),
    }


def encode_events(events: list) -> tuple[dict, bytes]:
    """FleetEvent-list codec — each event the ``ack`` record's shape:
    decision fields in the meta, the probability vector float64 in the
    payload.  Exact: the bit-identity pins compare
    ``probability.tobytes()`` and float64 round-trips unchanged.

    The engine types are imported lazily: the framing half of this
    module is also what the journal-ship agent (``net/ship.py``) rides,
    and an agent process streams journal bytes without ever needing the
    serving engine (or torch) loaded."""
    metas = []
    chunks = []
    for fe in events:
        ev = fe.event
        prob = np.ascontiguousarray(ev.probability, np.float64)
        metas.append(
            {
                "sid": fe.session_id,
                "ti": int(ev.t_index),
                "lb": int(ev.label),
                "rl": int(ev.raw_label),
                "lat": float(ev.latency_ms),
                "dr": bool(ev.drift),
                "dm": None if ev.device_ms is None else float(ev.device_ms),
                "dg": bool(fe.degraded),
                "k": int(prob.shape[0]),
            }
        )
        chunks.append(prob.tobytes())
    return {"events": metas}, b"".join(chunks)


def decode_events(meta: dict, payload: bytes) -> list:
    from har_tpu_torch.serve.engine import FleetEvent
    from har_tpu_torch.serving import StreamEvent

    out = []
    pos = 0
    for em in meta.get("events") or []:
        k = int(em["k"])
        prob = np.frombuffer(payload[pos : pos + 8 * k], np.float64)
        pos += 8 * k
        out.append(
            FleetEvent(
                em["sid"],
                StreamEvent(
                    t_index=int(em["ti"]),
                    label=int(em["lb"]),
                    raw_label=int(em["rl"]),
                    probability=prob,
                    latency_ms=float(em["lat"]),
                    drift=bool(em["dr"]),
                    device_ms=em.get("dm"),
                ),
                degraded=bool(em.get("dg")),
            )
        )
    return out
