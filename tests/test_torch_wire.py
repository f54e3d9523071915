"""The wire framing and payload codecs (har_tpu_torch.serve.net.wire) on
the CPU.

The JAX package's framing contracts (tests/test_net.py) on the port:
arbitrary TCP segmentation, torn frames, CRC, the size ceiling, garbled
meta, and the codec fuzz over every journal record type the port's
recovery replays.  Then the wire against ``har_tpu``'s: both packages'
encoders give equal bytes for the same inputs (frames, samples, chunk
batches, exports, events, drift reports), and each package decodes the
other's frames — what a cluster mixing the two packages' workers runs
on.
"""

import json
import re
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from har_tpu_torch.serve.engine import FleetConfig, FleetServer
from har_tpu_torch.serve.faults import FakeClock
from har_tpu_torch.serve.journal import encode_record
from har_tpu_torch.serve.loadgen import AnalyticDemoModel
from har_tpu_torch.serve.net import wire
from har_tpu_torch.serve.net.wire import (
    MAX_FRAME_BYTES,
    FrameBuffer,
    FrameError,
    decode_events,
    decode_export,
    decode_samples,
    encode_events,
    encode_export,
    encode_frame,
    encode_samples,
)

torch.set_num_threads(1)

MODEL = AnalyticDemoModel()
REPO = Path(__file__).resolve().parent.parent


def _decision_fields(fe):
    ev = fe.event
    return (ev.t_index, ev.label, ev.raw_label, ev.drift,
            ev.probability.tobytes())


def _by_session(events):
    out = {}
    for e in events:
        out.setdefault(e.session_id, []).append(_decision_fields(e))
    return out


# ------------------------------------------------------------ framing


def test_frame_roundtrip_survives_arbitrary_tcp_segmentation():
    rng = np.random.default_rng(7)
    frames = [
        ({"m": "push", "id": i, "n": i},
         rng.integers(0, 256, size=int(rng.integers(0, 500))).astype(
             np.uint8).tobytes())
        for i in range(20)
    ]
    stream = b"".join(encode_frame(m, p) for m, p in frames)
    buf = FrameBuffer()
    got = []
    pos = 0
    while pos < len(stream):
        take = int(rng.integers(1, 37))  # adversarial segmentation
        buf.feed(stream[pos : pos + take])
        pos += take
        while True:
            f = buf.next_frame()
            if f is None:
                break
            got.append(f)
    assert got == frames
    assert len(buf) == 0


def test_torn_frame_is_not_an_error_it_waits():
    frame = encode_frame({"m": "x", "id": 1}, b"payload-bytes")
    buf = FrameBuffer()
    buf.feed(frame[: len(frame) - 3])  # truncated: TCP mid-segment
    assert buf.next_frame() is None  # waits, no exception
    buf.feed(frame[len(frame) - 3 :])
    meta, payload = buf.next_frame()
    assert meta == {"m": "x", "id": 1} and payload == b"payload-bytes"


def test_crc_mismatch_kills_the_connection():
    frame = bytearray(encode_frame({"m": "x", "id": 1}, b"abcdef"))
    frame[-2] ^= 0xFF  # flip a payload byte after the CRC was stamped
    buf = FrameBuffer()
    buf.feed(bytes(frame))
    with pytest.raises(FrameError, match="CRC"):
        buf.next_frame()


def test_oversized_frame_rejected_before_allocation():
    # a hostile/corrupt length field must die at the header, not in
    # the allocator: declare 1 GiB, deliver 12 bytes
    hdr = struct.pack("<III", 1 << 30, 0, 0)
    buf = FrameBuffer()
    buf.feed(hdr + b"x" * 12)
    with pytest.raises(FrameError, match="MAX_FRAME_BYTES"):
        buf.next_frame()
    # and the send side refuses to BUILD one it would refuse to read
    with pytest.raises(FrameError):
        encode_frame({"m": "x"}, b"\0" * (MAX_FRAME_BYTES + 1))


def test_garbled_meta_is_a_frame_error():
    # non-JSON meta bytes under a VALID crc: framing ok, meta undecodable
    meta = b"\xff\xfe not json"
    evil = struct.pack("<III", len(meta), 0, zlib.crc32(meta) & 0xFFFFFFFF) + meta
    buf = FrameBuffer()
    buf.feed(evil)
    with pytest.raises(FrameError, match="meta"):
        buf.next_frame()
    # the frame format IS the journal's record format
    assert encode_frame({"m": "x"}, b"p") == encode_record({"m": "x"}, b"p")


def test_peek_and_skip_refuse_a_frame_from_its_header():
    """The edge view: the header and meta read before the payload
    arrives, and a skipped frame's in-flight bytes are dropped at
    ``feed`` time; the next frame decodes clean."""
    first = encode_frame({"m": "push", "s": 3}, b"\1" * 4000)
    second = encode_frame({"m": "x", "id": 2}, b"ok")
    buf = FrameBuffer()
    buf.feed(first[:40])
    meta, plen = buf.peek_header()
    assert meta == {"m": "push", "s": 3} and plen == 4000
    buf.skip_frame()
    buf.feed(first[40:] + second)
    assert buf.next_frame() == ({"m": "x", "id": 2}, b"ok")


# ----------------------------------------------- journal-record codec


def _representative_records():
    """One representative (meta, payload) per journal record type —
    the shapes the engine actually writes."""
    rng = np.random.default_rng(0xC0DEC)
    samples = rng.normal(size=(7, 3)).astype(np.float32)
    probs = rng.random(6).astype(np.float64)
    ring = rng.normal(size=(200, 3)).astype(np.float32)
    ema = rng.random(6).astype(np.float64)
    mon = {"mean": [0.0, 0.1, 0.2], "n": 12}
    return {
        "push": ({"t": "push", "sid": 3, "n": 7, "rn": 8},
                 samples.tobytes()),
        "ack": ({"t": "ack", "sid": 3, "ti": 200, "ver": "A",
                 "shed": False}, probs.tobytes()),
        "acks": ({"t": "acks", "n": 2, "sids": [3, 9], "ver": "A",
                  "shed": False, "tic": 0xDEADBEEF},
                 np.concatenate([probs, probs[::-1]]).tobytes()),
        "drop": ({"t": "drop", "sid": 3, "ti": 250,
                  "reason": "backpressure"}, b""),
        "add": ({"t": "add", "sid": 4, "mon": mon}, b""),
        "remove": ({"t": "remove", "sid": 4}, b""),
        "swap": ({"t": "swap", "ver": "B"}, b""),
        "resize": ({"t": "resize", "tb": 48, "depth": 2, "dir": 1}, b""),
        "disc": ({"t": "disc", "sid": 5}, b""),
        "shed": ({"t": "shed", "on": True}, b""),
        "adopt": ({"t": "adopt", "sid": 6, "n_seen": 400,
                   "raw_seen": 400, "next_emit": 450, "n_enqueued": 5,
                   "n_scored": 5, "n_dropped": 0, "handoffs": 2,
                   "votes": [1, 4], "ema": True, "mon": mon},
                  ring.tobytes() + ema.tobytes()),
        "handoff": ({"t": "handoff", "sid": 6}, b""),
        "lost": ({"t": "lost", "sid": 7, "pos": 300, "n": 2}, b""),
        "adapt": ({"t": "adapt", "state": "shadowing", "job": 1}, b""),
    }


def test_codec_fuzz_covers_every_journal_record_type():
    """The wire frames EVERY journal record type bit-exactly through
    adversarial segmentation — and the covered set is pinned against
    the port's recover.py replay handlers, so a new record type cannot
    ship without joining this round trip."""
    handled = set(
        re.findall(
            r'\bt == "(\w+)"',
            (REPO / "har_tpu_torch" / "serve" / "recover.py").read_text(),
        )
    )
    records = _representative_records()
    assert handled == set(records), handled ^ set(records)
    rng = np.random.default_rng(0xF022)
    for name, (meta, payload) in records.items():
        stream = encode_frame(meta, payload)
        for _ in range(3):  # several random segmentations each
            buf = FrameBuffer()
            pos = 0
            out = None
            while out is None:
                take = int(rng.integers(1, 61))
                buf.feed(stream[pos : pos + take])
                pos += take
                out = buf.next_frame()
            assert out == (meta, payload), name


def _served_events_and_export():
    """Four pushes, events and an export of one session; the FakeClock
    makes every event field, latency included, reproducible."""
    server = FleetServer(
        MODEL, window=100, hop=50, channels=3, smoothing="ema",
        config=FleetConfig(max_sessions=4, max_delay_ms=0.0),
        clock=FakeClock(),
    )
    rng = np.random.default_rng(3)
    server.add_session("s0")
    events = []
    for _ in range(4):
        server.push("s0", rng.normal(size=(50, 3)).astype(np.float32))
        events.extend(server.poll(force=True))
    events.extend(server.flush())
    return events, server.export_session("s0")


def test_export_and_event_codecs_are_bit_exact():
    events, export = _served_events_and_export()
    assert events
    meta, payload = encode_events(events)
    back = decode_events(meta, payload)
    assert _by_session(back) == _by_session(events)
    m, p = encode_export(export)
    json.dumps(m)  # meta must be JSON-clean (it rides the frame)
    back_export = decode_export(m, p)
    assert np.array_equal(back_export["ring"], export["ring"])
    assert np.array_equal(back_export["ema"], export["ema"])
    for k in ("sid", "n_seen", "raw_seen", "next_emit", "n_enqueued",
              "n_scored", "n_dropped", "handoffs", "votes"):
        assert back_export[k] == export[k], k
    arr = np.random.default_rng(4).normal(size=(9, 3)).astype(np.float32)
    sm, sp = encode_samples(arr)
    assert np.array_equal(decode_samples(sm, sp), arr)


def test_chunk_batch_and_drift_report_codecs_roundtrip():
    from har_tpu_torch.monitoring import DriftReport

    rng = np.random.default_rng(5)
    items = [(i, rng.normal(size=(10 + i, 3)).astype(np.float32)) for i in range(4)]
    meta, payload = wire.encode_chunk_batch(items, offsets=[0, 10, 20, 30])
    assert meta["s"] == 4 and [c["o"] for c in meta["chunks"]] == [0, 10, 20, 30]
    for (sid, arr), (sid2, arr2) in zip(items, wire.decode_chunk_batch(meta, payload)):
        assert sid == sid2 and np.array_equal(arr, arr2)
    reports = [("a", DriftReport(True, rng.normal(size=3), rng.normal(size=3), 40, 12, 2)),
               ("b", None),
               ("c", DriftReport(False, rng.normal(size=3), rng.normal(size=3), 7, None, 0))]
    meta, payload = wire.encode_drift_reports(reports)
    back = wire.decode_drift_reports(meta, payload)
    assert [sid for sid, _ in back] == ["a", "c"]
    for (_, want), (_, got) in zip([reports[0], reports[2]], back):
        assert got.location_z.tobytes() == want.location_z.tobytes()
        assert got.scale_log_ratio.tobytes() == want.scale_log_ratio.tobytes()
        assert (got.drifting, got.n_samples, got.onset, got.generation) == (
            want.drifting, want.n_samples, want.onset, want.generation)


# ------------------------------------------------- the port against JAX


def _jax_events_and_export():
    from har_tpu.serve.engine import FleetConfig as JaxConfig
    from har_tpu.serve.engine import FleetServer as JaxServer
    from har_tpu.serve.faults import FakeClock as JaxClock
    from har_tpu.serve.loadgen import AnalyticDemoModel as JaxDemo

    server = JaxServer(
        JaxDemo(), window=100, hop=50, channels=3, smoothing="ema",
        config=JaxConfig(max_sessions=4, max_delay_ms=0.0),
        clock=JaxClock(),
    )
    rng = np.random.default_rng(3)
    server.add_session("s0")
    events = []
    for _ in range(4):
        server.push("s0", rng.normal(size=(50, 3)).astype(np.float32))
        events.extend(server.poll(force=True))
    events.extend(server.flush())
    return events, server.export_session("s0")


def test_encoders_give_jax_bytes():
    """The same inputs through both packages' encoders: equal meta and
    equal payload bytes for every codec, and equal frames (header,
    CRC32, JSON meta) around them."""
    from har_tpu.monitoring import DriftReport as JaxReport
    from har_tpu.serve.net import wire as jax_wire

    from har_tpu_torch.monitoring import DriftReport

    events, export = _served_events_and_export()
    jax_events, jax_export = _jax_events_and_export()
    rng = np.random.default_rng(6)
    samples = rng.normal(size=(17, 3)).astype(np.float32)
    items = [(i, rng.normal(size=(5, 3)).astype(np.float32)) for i in range(3)]
    z, r = rng.normal(size=3), rng.normal(size=3)
    cases = [
        (wire.encode_events(events), jax_wire.encode_events(jax_events)),
        (wire.encode_export(export), jax_wire.encode_export(jax_export)),
        (wire.encode_samples(samples), jax_wire.encode_samples(samples)),
        (wire.encode_chunk_batch(items, [1, 2, 3]),
         jax_wire.encode_chunk_batch(items, [1, 2, 3])),
        (wire.encode_drift_reports([("x", DriftReport(True, z, r, 9, 3, 1))]),
         jax_wire.encode_drift_reports([("x", JaxReport(True, z, r, 9, 3, 1))])),
    ]
    for (ours_meta, ours_payload), (jax_meta, jax_payload) in cases:
        assert ours_meta == jax_meta
        assert ours_payload == jax_payload
        assert wire.encode_frame(ours_meta, ours_payload) == jax_wire.encode_frame(
            jax_meta, jax_payload)
    assert wire.MAX_FRAME_BYTES == jax_wire.MAX_FRAME_BYTES


def test_each_package_decodes_the_others_frames():
    """Frames written by one package decode in the other into its own
    types: events into its ``FleetEvent`` / ``StreamEvent``, exports
    into an adoption the other engine accepts, drift reports into its
    ``DriftReport``."""
    from har_tpu.monitoring import DriftReport as JaxReport
    from har_tpu.serve.engine import FleetEvent as JaxFleetEvent
    from har_tpu.serve.net import wire as jax_wire

    from har_tpu_torch.monitoring import DriftReport
    from har_tpu_torch.serve.engine import FleetEvent

    events, export = _served_events_and_export()
    jax_events, jax_export = _jax_events_and_export()

    def through(frame, buffer_cls):
        buf = buffer_cls()
        buf.feed(frame)
        return buf.next_frame()

    meta, payload = through(jax_wire.encode_frame(*jax_wire.encode_events(jax_events)),
                            FrameBuffer)
    ours = wire.decode_events(meta, payload)
    assert all(type(e) is FleetEvent for e in ours)
    assert _by_session(ours) == _by_session(jax_events)
    meta, payload = through(wire.encode_frame(*wire.encode_events(events)),
                            jax_wire.FrameBuffer)
    theirs = jax_wire.decode_events(meta, payload)
    assert all(type(e) is JaxFleetEvent for e in theirs)
    assert _by_session(theirs) == _by_session(events)

    meta, payload = through(jax_wire.encode_frame(*jax_wire.encode_export(jax_export)),
                            FrameBuffer)
    adopter = FleetServer(MODEL, window=100, hop=50, channels=3, smoothing="ema",
                          config=FleetConfig(max_sessions=4, max_delay_ms=0.0))
    adopter.adopt_session(wire.decode_export(meta, payload))
    assert adopter.watermark("s0") == jax_export["raw_seen"]
    meta, payload = through(wire.encode_frame(*wire.encode_export(export)),
                            jax_wire.FrameBuffer)
    back = jax_wire.decode_export(meta, payload)
    assert back["ring"].tobytes() == export["ring"].tobytes()

    z, r = np.arange(3.0), -np.arange(3.0)
    meta, payload = through(
        jax_wire.encode_frame(*jax_wire.encode_drift_reports([("q", JaxReport(True, z, r, 5, 1, 2))])),
        FrameBuffer)
    ((sid, rep),) = wire.decode_drift_reports(meta, payload)
    assert sid == "q" and type(rep) is DriftReport and rep.generation == 2
    meta, payload = through(
        wire.encode_frame(*wire.encode_drift_reports([("q", DriftReport(True, z, r, 5, 1, 2))])),
        jax_wire.FrameBuffer)
    ((sid, rep),) = jax_wire.decode_drift_reports(meta, payload)
    assert sid == "q" and type(rep) is JaxReport and rep.onset == 1
