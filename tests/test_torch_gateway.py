"""The ingest front door on the port (har_tpu_torch.serve.net.ingest,
gateway, election and ``HAGatewayClient``).

The JAX package's contracts (tests/test_ingest.py and
tests/test_gateway_ha.py) on the port: the shed ladder and its reasons,
header-only judgment, lying frames dying at the header, declared sheds
with conservation balanced, batched frames scoring as per-session
pushes, weighted tenant ladders, replay dedup by watermark, client
offsets rolled back on a shed, the fenced early lease release, the HA
client's capped and jittered redial, ``moved`` receipts and stale
generations.  Then, against ``har_tpu``:

  - ``EdgeAdmission``'s decisions and ``snapshot()`` over a seeded
    stream of headers and tenants equal the JAX package's, call for
    call;
  - lease files, and the (method, meta, payload) of every frame a
    ``GatewayClient`` sends, are byte-equal; either package's client
    drives the other's gateway to the same events.

Last, over ``serve-worker`` and ``serve-gateway`` processes (``nice
19``, one thread each, a few cells at a time under the lock the rank
groups take): the gateway kill matrix with its ``drain`` cell, each
cell's delivered events equal to the JAX package's in-process run on
the same recordings, ``wire_ingest_smoke`` and ``gateway_ha_smoke``.
"""

import json
import os
import socket
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from har_tpu_torch.serve import FleetConfig
from har_tpu_torch.serve.chaos import GATEWAY_KILL_POINTS
from har_tpu_torch.serve.cluster import ClusterConfig, FleetCluster
from har_tpu_torch.serve.journal import _HDR
from har_tpu_torch.serve.loadgen import AnalyticDemoModel
from har_tpu_torch.serve.net.chaos import run_gateway_kill_point
from har_tpu_torch.serve.net.client import HAGatewayClient
from har_tpu_torch.serve.net.election import LeaderLease
from har_tpu_torch.serve.net.gateway import GatewayClient, IngestGateway
from har_tpu_torch.serve.net.ingest import EdgeAdmission, IngestConfig, TenantViolation
from har_tpu_torch.serve.net.rpc import RpcClient, RpcConnectionRefused, RpcServer
from har_tpu_torch.serve.net.smoke import gateway_ha_smoke, wire_ingest_smoke
from har_tpu_torch.serve.net.wire import (
    MAX_FRAME_BYTES,
    FrameBuffer,
    FrameError,
    encode_chunk_batch,
    encode_frame,
)
from har_tpu_torch.utils.backoff import Backoff, BackoffPolicy
from tests._torch_ranks import cell, current_cell, event_fields, jax_reference, run_cells

torch.set_num_threads(1)

MODEL = AnalyticDemoModel()


def _decision_fields(fe):
    ev = fe.event
    return (ev.t_index, ev.label, ev.raw_label, ev.drift, ev.probability.tobytes())


def _by_session(events):
    out = {}
    for e in events:
        out.setdefault(e.session_id, []).append(_decision_fields(e))
    return out


class _Pump:
    """Background stepper for an RpcServer under test."""

    def __init__(self, srv):
        self.srv = srv
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self):
        while not self._stop.is_set():
            self.srv.step(0.02)

    def stop(self):
        self._stop.set()
        self._t.join(timeout=5)

    def close(self):
        self.stop()
        self.srv.close()


# ------------------------------------------------------- shed ladder


def test_ladder_levels_follow_the_backlog_estimate():
    adm = EdgeAdmission(IngestConfig(soft_backlog=10, hard_backlog=20))
    assert adm.level == 0
    adm.note_enqueued(10)
    assert adm.level == 1
    adm.note_enqueued(10)
    assert adm.level == 2
    adm.note_retired(15)
    assert adm.level == 0 and adm.backlog == 5
    adm.note_retired(50)
    assert adm.backlog == 0
    adm.note_enqueued(100)
    adm.resync_backlog(3)
    assert adm.backlog == 3 and adm.level == 0


def test_admission_reasons_cheapest_check_first():
    adm = EdgeAdmission(IngestConfig(soft_backlog=10, hard_backlog=20, max_frame_sessions=4,
                                     max_frame_bytes=1000, max_watermark_lag=50))
    assert adm.admit({"s": 5, "wm": 0}, 10) == "frame_sessions"
    assert adm.admit({"s": 2, "wm": 0}, 2000) == "frame_bytes"
    assert adm.admit({"s": 2, "wm": 100}, 10) is None
    assert adm.admit({"s": 2, "wm": 40}, 10) == "stale"
    assert adm.admit({"s": 2, "wm": 60}, 10) is None
    adm.note_enqueued(10)
    assert adm.admit({"s": 2, "wm": 99}, 10) == "soft_backlog"
    assert adm.admit({"s": 2, "wm": 100}, 10) is None
    adm.note_enqueued(10)
    assert adm.admit({"s": 2, "wm": 100}, 10) == "hard_backlog"
    adm.note_retired(15)
    assert adm.admit({"s": 2, "wm": 100}, 10) is None


def test_admission_receipts_and_watermark_advance():
    adm = EdgeAdmission(IngestConfig(max_frame_sessions=4))
    assert adm.admit({"s": 3, "wm": 30}, 100) is None
    assert adm.admit({"s": 9, "wm": 60}, 200) == "frame_sessions"
    assert adm.latest_wm == 30  # a refused frame's samples never landed
    assert adm.admit({"s": 2, "wm": 60}, 50) is None
    assert adm.latest_wm == 60
    snap = adm.snapshot()
    assert (snap["admitted_frames"], snap["admitted_sessions"], snap["admitted_bytes"]) == (2, 5, 150)
    assert (snap["shed_frames"], snap["shed_sessions"], snap["shed_bytes"]) == (1, 9, 200)
    assert snap["shed_by_reason"] == {"frame_sessions": 1}


def test_tenant_ladders_ride_weighted_shares():
    """Each tenant walks the ladder against its own weighted share: the
    storming tenant is refused while the protected one keeps landing."""
    adm = EdgeAdmission(IngestConfig(soft_backlog=40, hard_backlog=80,
                                     tenants=(("care", 3.0), ("bulk", 1.0))))
    adm.note_enqueued(20, "bulk")
    assert adm.tenant_level("bulk") == 2 and adm.tenant_level("care") == 0
    assert adm.level == 0
    assert adm.admit({"s": 1, "wm": 0, "tn": "bulk"}, 10) == "hard_backlog"
    assert adm.admit({"s": 1, "wm": 5, "tn": "care"}, 10) is None
    adm.note_retired(5, "bulk")
    assert adm.tenant_level("bulk") == 1
    assert adm.admit({"s": 1, "wm": 10, "tn": "bulk"}, 10) is None
    assert adm.admit({"s": 1, "wm": 5, "tn": "bulk"}, 10) == "soft_backlog"
    adm.note_retired(10, "bulk")
    assert adm.tenant_level("bulk") == 0
    assert adm.admit({"s": 1, "wm": 5, "tn": "bulk"}, 10) is None
    snap = adm.snapshot()
    assert snap["tenants"]["care"]["shed_frames"] == 0
    assert snap["tenants"]["bulk"]["shed_frames"] == 2


def test_snapshot_slices_sum_to_globals():
    """After every decision the per-tenant slices sum to the globals,
    reason by reason."""
    adm = EdgeAdmission(IngestConfig(soft_backlog=8, hard_backlog=16, max_frame_sessions=4,
                                     max_frame_bytes=100,
                                     tenants=(("care", 3.0), ("bulk", 1.0))))

    def check():
        snap = adm.snapshot()
        for k in ("admitted_frames", "admitted_sessions", "admitted_bytes", "shed_frames",
                  "shed_sessions", "shed_bytes"):
            assert sum(s[k] for s in snap["tenants"].values()) == snap[k], k
        merged: dict = {}
        for s in snap["tenants"].values():
            for r, c in s["shed_by_reason"].items():
                merged[r] = merged.get(r, 0) + c
        assert merged == snap["shed_by_reason"]

    adm.note_enqueued(4, "bulk")
    for meta, plen, want in [
        ({"s": 2, "wm": 0, "tn": "care"}, 50, None),
        ({"s": 9, "wm": 0, "tn": "care"}, 10, "frame_sessions"),
        ({"s": 2, "wm": 0, "tn": "bulk"}, 500, "frame_bytes"),
        ({"s": 2, "wm": 0, "tn": "bulk"}, 50, "hard_backlog"),
        ({"s": 1, "wm": 10, "tn": "care"}, 30, None),
    ]:
        assert adm.admit(meta, plen) == want
        check()


def _admission_stream(seed, n=400):
    """A seeded stream of admission calls: headers from several tenants
    (and an unknown one), frame sizes around the limits, enqueues,
    retires and backlog resyncs."""
    rng = np.random.default_rng((seed, 0xED6E))
    tenants = ["care", "bulk", "burst", None, "mallory"]
    wm = 0
    ops = []
    for _ in range(n):
        kind = rng.choice(["admit", "admit", "admit", "enq", "ret", "resync"])
        tn = tenants[int(rng.integers(len(tenants)))]
        if kind == "admit":
            wm += int(rng.integers(0, 80))
            meta = {"s": int(rng.integers(1, 12)),
                    "wm": max(0, wm - int(rng.integers(0, 120)))}
            if tn is not None:
                meta["tn"] = tn
            ops.append(("admit", meta, int(rng.integers(10, 5000))))
        elif kind == "enq":
            ops.append(("enq", int(rng.integers(0, 30)), tn))
        elif kind == "ret":
            ops.append(("ret", int(rng.integers(0, 30)), tn))
        else:
            ops.append(("resync", int(rng.integers(0, 60)), None))
    return ops


def _replay(adm, ops, violation):
    out = []
    for op in ops:
        try:
            if op[0] == "admit":
                out.append(("admit", adm.admit(dict(op[1]), op[2])))
            elif op[0] == "enq":
                adm.note_enqueued(op[1], op[2])
            elif op[0] == "ret":
                adm.note_retired(op[1], op[2])
            else:
                adm.resync_backlog(op[1])
        except violation as exc:
            out.append(("violation", str(exc)))
        out.append(("level", adm.level, adm.backlog, adm.latest_wm))
    return out, adm.snapshot()


@pytest.mark.parametrize("tenants", [(), (("care", 3.0), ("bulk", 1.0), ("burst", 0.5))])
@pytest.mark.parametrize("seed", [0, 1])
def test_edge_admission_equals_jax(seed, tenants):
    """Both packages' ``EdgeAdmission`` on one seeded stream: every
    decision, level, backlog, watermark and violation, and the final
    ``snapshot()``, equal."""
    from har_tpu.serve.net.ingest import EdgeAdmission as JaxAdmission
    from har_tpu.serve.net.ingest import IngestConfig as JaxConfig
    from har_tpu.serve.net.ingest import TenantViolation as JaxViolation

    kw = dict(soft_backlog=60, hard_backlog=120, max_frame_sessions=8, max_frame_bytes=4000,
              max_watermark_lag=90, tenants=tenants)
    ops = _admission_stream(seed)
    ours = _replay(EdgeAdmission(IngestConfig(**kw)), ops, TenantViolation)
    theirs = _replay(JaxAdmission(JaxConfig(**kw)), ops, JaxViolation)
    assert ours == theirs
    assert json.dumps(ours[1], sort_keys=True) == json.dumps(theirs[1], sort_keys=True)


# -------------------------------------- header peek / skip mechanics


def _chunk_frame(n_sessions=2, rows=40, **extra):
    items = [(i, np.full((rows, 3), float(i), np.float32)) for i in range(n_sessions)]
    meta, payload = encode_chunk_batch(items)
    meta.update(extra)
    return meta, payload


def test_peek_header_sees_meta_before_payload():
    meta, payload = _chunk_frame(wm=80)
    frame = encode_frame({**meta, "m": "push_many", "id": 1, "cid": "t.0"}, payload)
    buf = FrameBuffer()
    buf.feed(frame[: _HDR.size - 1])
    assert buf.peek_header() is None
    split = len(frame) - len(payload)
    buf.feed(frame[_HDR.size - 1 : split])
    hmeta, plen = buf.peek_header()
    assert hmeta["s"] == 2 and hmeta["wm"] == 80 and plen == len(payload)
    buf.feed(frame[split:])
    got = buf.next_frame()
    assert got is not None and got[1] == payload


def test_skip_frame_drops_in_flight_payload_bytes():
    meta, payload = _chunk_frame()
    refused = encode_frame({**meta, "m": "push_many", "id": 1}, payload)
    after = encode_frame({"m": "heartbeat", "id": 2})
    buf = FrameBuffer()
    split = len(refused) - len(payload) + 7
    buf.feed(refused[:split])
    assert buf.peek_header() is not None
    buf.skip_frame()
    assert len(buf) == 0
    buf.feed(refused[split:] + after)
    got = buf.next_frame()
    assert got is not None and got[0]["m"] == "heartbeat"


def test_peek_header_raises_on_oversized_and_garbled_frames():
    buf = FrameBuffer()
    buf.feed(_HDR.pack(10, MAX_FRAME_BYTES, 0) + b"x" * 10)
    with pytest.raises(FrameError):
        buf.peek_header()
    buf2 = FrameBuffer()
    buf2.feed(_HDR.pack(4, 0, 0) + b"\xff\xfe{!")
    with pytest.raises(FrameError):
        buf2.peek_header()


# ------------------------------- the RpcServer admission hook, live


def test_refused_frame_answers_shed_without_running_the_handler():
    executed = []

    def push_many(meta, payload):
        executed.append(len(payload))
        return {"r": 1}, b""

    adm = EdgeAdmission(IngestConfig(max_frame_sessions=1))
    srv = RpcServer({"push_many": push_many},
                    admission=lambda m, p: adm.admit(m, p) if m.get("m") == "push_many" else None)
    pump = _Pump(srv)
    client = RpcClient(srv.host, srv.port, deadline_s=30.0)
    try:
        meta, payload = _chunk_frame(n_sessions=3)
        resp, _ = client.call("push_many", meta, payload)
        assert resp["shed"] == "frame_sessions" and executed == []
        meta, payload = _chunk_frame(n_sessions=1)
        resp, _ = client.call("push_many", meta, payload)
        assert "shed" not in resp and resp["r"] == 1
        assert executed == [len(payload)]
    finally:
        client.close()
        pump.close()


def _raw_request(sock, srv, frame, *, pieces=1):
    """Send ``frame`` in ``pieces`` sends, stepping the server between
    them; the decoded response."""
    step = max(1, len(frame) // pieces)
    for off in range(0, len(frame), step):
        sock.sendall(frame[off : off + step])
        for _ in range(4):
            srv.step(0.02)
    buf = FrameBuffer()
    sock.settimeout(5.0)
    deadline = time.monotonic() + 30.0
    while True:
        got = buf.next_frame()
        if got is not None:
            return got
        srv.step(0.02)
        if time.monotonic() > deadline:
            raise AssertionError("no response frame")
        try:
            chunk = sock.recv(1 << 16)
        except socket.timeout:
            continue
        if not chunk:
            raise AssertionError("server hung up mid-request")
        buf.feed(chunk)


def test_torn_payload_is_judged_once():
    judged, executed = [], []

    def push_many(meta, payload):
        executed.append(len(payload))
        return {"r": 1}, b""

    srv = RpcServer({"push_many": push_many}, admission=lambda m, p: judged.append(m.get("id")))
    try:
        meta, payload = _chunk_frame(rows=200)
        frame = encode_frame({**meta, "m": "push_many", "id": 1, "cid": "raw.1"}, payload)
        sock = socket.create_connection((srv.host, srv.port))
        try:
            srv.step(0.02)
            resp, _ = _raw_request(sock, srv, frame, pieces=5)
            assert resp["r"] == 1
        finally:
            sock.close()
        assert judged == [1] and executed == [len(payload)]
    finally:
        srv.close()


def test_retried_executed_request_bypasses_admission():
    judged, executed = [], []

    def push_many(meta, payload):
        executed.append(1)
        return {"r": 7}, b""

    def admission(meta, plen):
        judged.append(meta.get("id"))
        return None if len(judged) == 1 else "late"

    srv = RpcServer({"push_many": push_many}, admission=admission)
    try:
        meta, payload = _chunk_frame()
        frame = encode_frame({**meta, "m": "push_many", "id": 9, "cid": "raw.2"}, payload)
        sock = socket.create_connection((srv.host, srv.port))
        try:
            srv.step(0.02)
            r1, _ = _raw_request(sock, srv, frame)
            r2, _ = _raw_request(sock, srv, frame)
        finally:
            sock.close()
        assert r1["r"] == 7 and r2["r"] == 7 and "shed" not in r2
        assert executed == [1] and judged == [9]
    finally:
        srv.close()


# --------------------------------------------- lying clients, edge on


def _gateway_fixture(tmp_path, config=None, *, n_sessions=0):
    cluster = FleetCluster(MODEL, str(tmp_path / "fleet"), workers=2, window=100, hop=50,
                           smoothing="ema",
                           fleet_config=FleetConfig(max_sessions=64, max_delay_ms=0.0),
                           config=ClusterConfig())
    for i in range(n_sessions):
        cluster.add_session(i)
    return cluster, IngestGateway(cluster, config=config)


@pytest.mark.parametrize(
    "name,frame_bytes",
    [
        ("garbage", b"\x00" * 4 + b"not a frame at all" * 4),
        ("oversized", _HDR.pack(2, MAX_FRAME_BYTES, 0) + b"{}"),
        ("bad_meta", _HDR.pack(8, 0, 0) + b"\xff" * 8),
    ],
)
def test_lying_frames_die_at_the_header(tmp_path, name, frame_bytes):
    cluster, gw = _gateway_fixture(tmp_path, n_sessions=2)
    try:
        liar = socket.create_connection((gw.rpc.host, gw.rpc.port))
        try:
            gw.rpc.step(0.02)
            liar.sendall(frame_bytes)
            for _ in range(5):
                gw.rpc.step(0.02)
            liar.settimeout(5.0)
            assert liar.recv(1 << 16) == b""
        finally:
            liar.close()
        assert gw.rounds == 0
        snap = gw.admission.snapshot()
        assert snap["shed_frames"] == 0 and snap["admitted_frames"] == 0
        assert cluster.accounting()["enqueued"] == 0
        pump = _Pump(gw.rpc)
        try:
            honest = GatewayClient(gw.rpc.host, gw.rpc.port)
            honest.push(0, np.zeros((50, 3), np.float32))
            honest.poll(force=True)
            assert honest.frames_sent == 1 and honest.edge_sheds == 0
            honest.close()
        finally:
            pump.stop()
    finally:
        gw.close()
        cluster.close()


def test_torn_frame_then_hangup_leaves_no_trace(tmp_path):
    cluster, gw = _gateway_fixture(tmp_path, n_sessions=1)
    try:
        meta, payload = _chunk_frame()
        frame = encode_frame({**meta, "m": "push_many", "id": 1, "cid": "liar.1"}, payload)
        liar = socket.create_connection((gw.rpc.host, gw.rpc.port))
        gw.rpc.step(0.02)
        liar.sendall(frame[: len(frame) // 2])
        for _ in range(5):
            gw.rpc.step(0.02)
        liar.close()
        for _ in range(5):
            gw.rpc.step(0.02)
        assert gw.rounds == 0 and cluster.accounting()["enqueued"] == 0
    finally:
        gw.close()
        cluster.close()


def test_unidentified_frames_die_with_no_receipt(tmp_path):
    """With a tenant table, a push frame of a missing or unknown tenant
    is a protocol violation: a hangup, no receipt, no ledger trace."""
    adm = EdgeAdmission(IngestConfig(tenants=(("care", 1.0),)))
    with pytest.raises(TenantViolation):
        adm.resolve_tenant({"s": 1, "wm": 0})
    with pytest.raises(TenantViolation):
        adm.admit({"s": 1, "wm": 0, "tn": "mallory"}, 10)
    assert EdgeAdmission().resolve_tenant({}) == "default"
    cluster, gw = _gateway_fixture(tmp_path, IngestConfig(tenants=(("care", 1.0),)),
                                   n_sessions=1)
    try:
        meta, payload = _chunk_frame(n_sessions=1, tn="mallory", wm=40)
        frame = encode_frame({**meta, "m": "push_many", "id": 1, "cid": "liar.tn"}, payload)
        liar = socket.create_connection((gw.rpc.host, gw.rpc.port))
        try:
            gw.rpc.step(0.02)
            liar.sendall(frame)
            for _ in range(5):
                gw.rpc.step(0.02)
            liar.settimeout(5.0)
            assert liar.recv(1 << 16) == b""
        finally:
            liar.close()
        snap = gw.admission.snapshot()
        assert (snap["shed_frames"], snap["admitted_frames"], snap["tenants"]) == (0, 0, {})
        assert gw.rounds == 0 and cluster.accounting()["enqueued"] == 0
    finally:
        gw.close()
        cluster.close()


# ------------------------- declared sheds + conservation at the edge


def test_edge_sheds_are_declared_and_conservation_balances(tmp_path):
    cluster, gw = _gateway_fixture(tmp_path, IngestConfig(max_watermark_lag=0))
    pump = _Pump(gw.rpc)
    rng = np.random.default_rng(5)
    client = GatewayClient(gw.rpc.host, gw.rpc.port, deadline_s=30.0)
    try:
        for i in range(4):
            client.add_session(i)
        chunks = {i: rng.normal(size=(400, 3)).astype(np.float32) for i in range(4)}
        for start in range(0, 400, client.hop):
            for i in range(4):
                client.push(i, chunks[i][start : start + client.hop])
            client.poll(force=True)
        meta, payload = encode_chunk_batch([(i, chunks[i][:50]) for i in range(4)])
        meta["wm"] = 1
        for _ in range(2):
            resp, _ = client._client.call("push_many", meta, payload)
            assert resp["shed"] == "stale"
        drained = client.flush()
        acct = client.accounting()
        stats = client.gateway_stats()
        assert stats["shed_frames"] == 2 and stats["shed_by_reason"] == {"stale": 2}
        assert stats["shed_sessions"] == 8
        assert stats["admitted_frames"] == client.frames_sent
        assert acct["enqueued"] == client.windows_enqueued == acct["scored"]
        assert acct["dropped"] == 0 and acct["balanced"] and acct["pending"] == 0
        assert drained == []
    finally:
        client.close()
        pump.close()
        cluster.close()


def _drive_gateway(client, chunks, rounds, hop):
    events = []
    for r in range(rounds):
        for i, rows in chunks.items():
            client.push(i, rows[r * hop : (r + 1) * hop])
        events.extend(client.poll(force=True))
    events.extend(client.flush())
    return events


def test_gateway_batched_frames_score_bit_identical_to_inprocess(tmp_path):
    """Per-session pushes on a FleetCluster, batched ``push_many`` on
    another, and the gateway's batched frames over a socket: the same
    events."""
    rng = np.random.default_rng(7)
    n, rounds, hop = 6, 8, 50
    chunks = {i: rng.normal(size=(rounds * hop, 3)).astype(np.float32) for i in range(n)}

    def mk(root):
        return FleetCluster(MODEL, str(root), workers=2, window=100, hop=hop, smoothing="ema",
                            fleet_config=FleetConfig(max_sessions=64, max_delay_ms=0.0))

    seq = mk(tmp_path / "a")
    for i in range(n):
        seq.add_session(i)
    ev_seq = []
    for r in range(rounds):
        for i in range(n):
            seq.push(i, chunks[i][r * hop : (r + 1) * hop])
        ev_seq.extend(seq.poll(force=True))
    ev_seq.extend(seq.flush())
    seq.close()
    bat = mk(tmp_path / "b")
    for i in range(n):
        bat.add_session(i)
    ev_bat = []
    for r in range(rounds):
        bat.push_many(list(range(n)), [chunks[i][r * hop : (r + 1) * hop] for i in range(n)])
        ev_bat.extend(bat.poll(force=True))
    ev_bat.extend(bat.flush())
    acct_bat = bat.accounting()
    bat.close()
    gw_cluster = mk(tmp_path / "c")
    gw = IngestGateway(gw_cluster)
    pump = _Pump(gw.rpc)
    client = GatewayClient(gw.rpc.host, gw.rpc.port, deadline_s=30.0)
    try:
        assert client.hop == hop
        for i in range(n):
            client.add_session(i)
        ev_gw = _drive_gateway(client, chunks, rounds, hop)
        stats = client.gateway_stats()
        acct_gw = client.accounting()
    finally:
        client.close()
        pump.close()
        gw.close()
        gw_cluster.close()
    ref = _by_session(ev_seq)
    assert ref and _by_session(ev_bat) == ref and _by_session(ev_gw) == ref
    assert stats["admitted_frames"] == rounds and stats["shed_frames"] == 0
    assert acct_gw["enqueued"] == acct_bat["enqueued"]
    assert acct_gw["balanced"] and acct_gw["pending"] == 0


def test_replayed_rows_below_watermark_trim_idempotently(tmp_path):
    """A reconnect-style replay of a whole stream from offset 0: rows
    below the workers' watermark are trimmed (``dd``), the rest land
    once, and the events equal an unbroken run's."""
    rng = np.random.default_rng(11)
    rows = rng.normal(size=(150, 3)).astype(np.float32)
    ref_cluster, ref_gw = _gateway_fixture(tmp_path / "ref")
    ref_pump = _Pump(ref_gw.rpc)
    ref = GatewayClient(ref_gw.rpc.host, ref_gw.rpc.port, deadline_s=30.0)
    try:
        ref.add_session(0)
        ref_events = []
        for start in range(0, 150, 50):
            ref.push(0, rows[start : start + 50])
            ref_events.extend(ref.poll(force=True))
        ref_events.extend(ref.flush())
    finally:
        ref.close()
        ref_pump.close()
        ref_cluster.close()
    cluster, gw = _gateway_fixture(tmp_path / "re")
    pump = _Pump(gw.rpc)
    client = GatewayClient(gw.rpc.host, gw.rpc.port, deadline_s=30.0)
    try:
        client.add_session(0)
        events = []
        for start in range(0, 100, 50):
            client.push(0, rows[start : start + 50])
            events.extend(client.poll(force=True))
        assert client.watermark(0) == 100
        meta, payload = encode_chunk_batch([(0, rows)], offsets=[0])
        meta["wm"] = 150
        resp, _ = client._client.call("push_many", meta, payload)
        assert "shed" not in resp and resp["dd"] == 100 and resp["r"] == 1
        events.extend(client.poll(force=True))
        events.extend(client.flush())
        acct = client.accounting()
    finally:
        client.close()
        pump.close()
        cluster.close()
    assert _by_session(ref_events) == _by_session(events)
    assert len(ref_events) == 2 and acct["enqueued"] == 2
    assert acct["balanced"] and acct["pending"] == 0


def test_client_offsets_roll_back_on_shed(tmp_path):
    """A shed frame's rows never took delivery positions: the client
    rolls its offsets back."""
    cluster, gw = _gateway_fixture(tmp_path, IngestConfig(max_frame_bytes=2048))
    pump = _Pump(gw.rpc)
    client = GatewayClient(gw.rpc.host, gw.rpc.port, deadline_s=30.0)
    try:
        client.add_session(0)
        client.push(0, np.zeros((300, 3), np.float32))
        client.poll(force=True)
        assert client.shed_by_reason == {"frame_bytes": 1} and client.shed_samples == 300
        assert client._off[0] == 0
        client.push(0, np.ones((100, 3), np.float32))
        client.poll(force=True)
        client.flush()
        assert client._off[0] == 100 and client.windows_enqueued == 1
        assert client.deduped_samples == 0 and client.watermark(0) == 100
        acct = client.accounting()
        assert acct["balanced"] and acct["enqueued"] == 1
    finally:
        client.close()
        pump.close()
        cluster.close()


# -------------------------------------------------- against har_tpu


class _Recording:
    """Record every (method, meta, payload) a client sends, answered by
    the real transport."""

    def __init__(self, client):
        self.frames = []
        real = client._call

        def call(method, meta=None, payload=b""):
            self.frames.append((method, dict(meta or {}), bytes(payload)))
            return real(method, meta, payload)

        client._call = call


@pytest.mark.parametrize("pairing", ["port_client_jax_gateway", "jax_client_port_gateway"])
def test_gateway_frames_and_events_equal_jax(tmp_path, pairing):
    """Each package's ``GatewayClient`` against the other's gateway (an
    ``IngestGateway`` on a thread over an in-process cluster of its
    package), two tenants' worth of sessions: the frames the two
    clients send are equal, meta, payload and encoded bytes, and the
    events equal the port-only run's."""
    from har_tpu.serve.cluster import FleetCluster as JaxCluster
    from har_tpu.serve.engine import FleetConfig as JaxFleetConfig
    from har_tpu.serve.loadgen import AnalyticDemoModel as JaxModel
    from har_tpu.serve.net.gateway import GatewayClient as JaxClient
    from har_tpu.serve.net.gateway import IngestGateway as JaxGateway
    from har_tpu.serve.net.wire import encode_frame as jax_encode_frame

    rng = np.random.default_rng(21)
    n, rounds, hop = 5, 6, 50
    chunks = {i: rng.normal(size=(rounds * hop, 3)).astype(np.float32) for i in range(n)}

    def run(cluster_cls, config_cls, model, gateway_cls, client_cls, root):
        cluster = cluster_cls(model, str(root), workers=2, window=100, hop=hop, smoothing="ema",
                              fleet_config=config_cls(max_sessions=64, max_delay_ms=0.0))
        gw = gateway_cls(cluster)
        pump = _Pump(gw.rpc)
        client = client_cls(gw.rpc.host, gw.rpc.port, deadline_s=30.0, tenant=None)
        rec = _Recording(client)
        try:
            for i in range(n):
                client.add_session(i)
            events = _drive_gateway(client, chunks, rounds, hop)
            acct = client.accounting()
        finally:
            client.close()
            pump.close()
            gw.close()
            cluster.close()
        return events, acct, rec.frames

    ref_events, ref_acct, ref_frames = run(FleetCluster, FleetConfig, MODEL, IngestGateway,
                                           GatewayClient, tmp_path / "ref")
    if pairing == "port_client_jax_gateway":
        events, acct, frames = run(JaxCluster, JaxFleetConfig, JaxModel(), JaxGateway,
                                   GatewayClient, tmp_path / "mix")
    else:
        events, acct, frames = run(FleetCluster, FleetConfig, MODEL, IngestGateway, JaxClient,
                                   tmp_path / "mix")
    assert _by_session(events) == _by_session(ref_events)
    assert acct == ref_acct
    assert [(m, json.dumps(meta, sort_keys=True), p) for m, meta, p in frames] == [
        (m, json.dumps(meta, sort_keys=True), p) for m, meta, p in ref_frames]
    for (m, meta, p), (_, jmeta, jp) in zip(frames, ref_frames):
        envelope = {**meta, "m": m, "id": 1, "cid": "c.0"}
        assert encode_frame(envelope, p) == jax_encode_frame({**jmeta, "m": m, "id": 1,
                                                               "cid": "c.0"}, jp)


# ----------------------------------------------------- lease release


def test_lease_release_is_fenced_and_immediate():
    clock = {"t": 1000.0}
    with tempfile.TemporaryDirectory() as root:
        lease = LeaderLease(root, lease_s=10.0, wall=lambda: clock["t"])
        gen_a = lease.campaign("A")
        assert gen_a == 1 and lease.holder() == "A"
        assert not lease.release("B", gen_a)
        assert lease.holder() == "A"
        assert lease.release("A", gen_a)
        assert lease.holder() is None
        gen_b = lease.campaign("B")
        assert gen_b == 2 and lease.holder() == "B"
        assert not lease.release("A", gen_a)
        assert lease.holder() == "B"
        assert lease.renew("B", gen_b)


def test_lease_files_equal_jax(tmp_path):
    """The same campaign, renew, release and takeover sequence on both
    packages' ``LeaderLease`` under one injected wall clock: the lease
    file after every step is byte-equal, and each package reads the
    other's file the same way."""
    from har_tpu.serve.net.election import LeaderLease as JaxLease

    clock = {"t": 5000.0}
    for name in ("ours", "theirs"):
        (tmp_path / name).mkdir()

    def wall():
        return clock["t"]

    ours = LeaderLease(str(tmp_path / "ours"), lease_s=2.0, wall=wall)
    theirs = JaxLease(str(tmp_path / "theirs"), lease_s=2.0, wall=wall)
    for step in [("campaign", "A"), ("renew", "A", 1), ("tick", 3.0), ("campaign", "B"),
                 ("renew", "A", 1), ("release", "B", 2), ("campaign", "A"), ("tick", 0.5),
                 ("renew", "A", 3)]:
        if step[0] == "tick":
            clock["t"] += step[1]
            continue
        a = getattr(ours, step[0])(*step[1:])
        b = getattr(theirs, step[0])(*step[1:])
        assert a == b, step
        with open(os.path.join(ours.root, "leader.json"), "rb") as f1, \
                open(os.path.join(theirs.root, "leader.json"), "rb") as f2:
            assert f1.read() == f2.read(), step
        assert JaxLease(ours.root, lease_s=2.0, wall=wall).read() == ours.read()
        assert LeaderLease(theirs.root, lease_s=2.0, wall=wall).holder() == theirs.holder()


# ------------------------------------------- HA client, scripted wire


class _ScriptedRpc:
    """Answers from a script of responses and exceptions, recording the
    client's dials."""

    def __init__(self):
        self.script: list = []
        self.dials: list = []

    def call(self, method, meta=None, payload=b""):
        if self.script:
            item = self.script.pop(0)
            if isinstance(item, Exception):
                raise item
            return dict(item), b""
        return {"id": 0, "r": 0, "hop": 50}, b""

    def close(self):
        pass


class _FakeHAClient(HAGatewayClient):
    """HAGatewayClient over the scripted transport, sleeps swallowed."""

    def __init__(self, fake, **kw):
        self._fake = fake
        kw.setdefault("sleep", lambda s: None)
        super().__init__(["a:1", "b:2"], **kw)

    def _dial(self, host, port):
        self._fake.dials.append((host, int(port)))
        self._client = self._fake


def test_redial_backoff_paces_capped_exponential_and_resets():
    fake = _ScriptedRpc()
    c = _FakeHAClient(fake, reconnect=BackoffPolicy(base_ms=10.0, cap_ms=40.0, factor=2.0,
                                                    jitter=0.0))
    fake.script = [RpcConnectionRefused("down")] * 5
    c._call("push_many", {"s": 1})
    assert c.redial_delays_ms == [10.0, 20.0, 40.0, 40.0, 40.0]
    assert c.reconnects == 5 and c.failover_episodes == 1
    fake.script = [RpcConnectionRefused("down")] * 2
    c._call("push_many", {"s": 1})
    assert c.redial_delays_ms[5:] == [10.0, 20.0]
    assert c.failover_episodes == 2
    assert {h for h, _ in fake.dials[1:]} == {"a", "b"}


def test_redial_stays_capped_past_a_thousand_failures():
    """A gateway pair down for thousands of redials: the delays stay at
    the cap (the port's ``utils/backoff`` never raises the exponent past
    it) instead of overflowing."""
    fake = _ScriptedRpc()
    c = _FakeHAClient(fake, reconnect=BackoffPolicy(base_ms=10.0, cap_ms=40.0, factor=2.0,
                                                    jitter=0.0), max_attempts=5000)
    fake.script = [RpcConnectionRefused("down")] * 3000
    c._call("push_many", {"s": 1})
    assert c.redial_delays_ms[:3] == [10.0, 20.0, 40.0]
    assert set(c.redial_delays_ms[2:]) == {40.0}


@pytest.mark.parametrize("seed", [0, 7])
def test_redial_jitter_rides_utils_backoff_verbatim(seed):
    """The jittered redial schedule is ``utils/backoff``'s, and equals
    the JAX client's for the same seed."""
    from har_tpu.serve.net.client import HAGatewayClient as JaxHA
    from har_tpu.serve.net.rpc import RpcConnectionRefused as JaxRefused
    from har_tpu.utils.backoff import BackoffPolicy as JaxPolicy

    policy = BackoffPolicy(base_ms=10.0, cap_ms=500.0, factor=2.0, jitter=0.25)
    fake = _ScriptedRpc()
    c = _FakeHAClient(fake, reconnect=policy, seed=seed)
    fake.script = [RpcConnectionRefused("down")] * 6
    c._call("push_many", {"s": 1})
    expect = Backoff(policy, seed=seed)
    assert c.redial_delays_ms == [expect.next_ms() for _ in range(6)]

    class _FakeJax(JaxHA):
        def __init__(self, fake, **kw):
            self._fake = fake
            super().__init__(["a:1", "b:2"], sleep=lambda s: None, **kw)

        def _dial(self, host, port):
            self._client = self._fake

    jfake = _ScriptedRpc()
    j = _FakeJax(jfake, reconnect=JaxPolicy(base_ms=10.0, cap_ms=500.0, factor=2.0,
                                            jitter=0.25), seed=seed)
    jfake.script = [JaxRefused("down")] * 6
    j._call("push_many", {"s": 1})
    assert c.redial_delays_ms == j.redial_delays_ms


def test_moved_receipt_retargets_without_a_backoff_sleep():
    fake = _ScriptedRpc()
    c = _FakeHAClient(fake)
    fake.script = [{"moved": "b:2"}]
    c._call("push_many", {"s": 1})
    assert c.moved_receipts == 1 and c.redial_delays_ms == []
    assert fake.dials[-1] == ("b", 2) and c.failover_episodes == 1
    fake.script = [{"moved": None}]
    c._call("push_many", {"s": 1})
    assert c.moved_receipts == 2 and len(c.redial_delays_ms) == 1


def test_stale_generation_ack_is_rejected_and_redelivered():
    fake = _ScriptedRpc()
    c = _FakeHAClient(fake)
    fake.script = [{"id": 0, "r": 1, "gen": 2}]
    c._call("push_many", {"s": 1})
    assert c.gen == 2
    fake.script = [{"id": 0, "r": 1, "gen": 1}, {"id": 0, "r": 1, "gen": 2}]
    resp, _ = c._call("push_many", {"s": 1})
    assert resp["gen"] == 2 and c.stale_acks_rejected == 1 and c.gen == 2


def test_ha_client_gives_up_after_max_attempts():
    fake = _ScriptedRpc()
    c = _FakeHAClient(fake, max_attempts=3)
    fake.script = [RpcConnectionRefused("down")] * 10
    with pytest.raises(RpcConnectionRefused):
        c._call("push_many", {"s": 1})
    assert c.reconnects == 3


# ------------------------------------------------- the failover matrix


@pytest.fixture(scope="module")
def wire_cells():
    """The gateway kill matrix, its drain cell and the two smokes over
    real processes, a few at a time; beside each result, the events its
    clients received."""
    seen: dict = {}

    def spy(real):
        def wrapper(self, *args, **kwargs):
            events = real(self, *args, **kwargs)
            seen.setdefault(current_cell(), []).extend(events)
            return events
        return wrapper

    cells = {point: (lambda p=point: run_gateway_kill_point(p))
             for point in GATEWAY_KILL_POINTS + ("drain",)}
    cells["wire_ingest_smoke"] = lambda: wire_ingest_smoke()
    cells["gateway_ha_smoke"] = lambda: gateway_ha_smoke()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(GatewayClient, "poll", spy(GatewayClient.poll))
        mp.setattr(GatewayClient, "flush", spy(GatewayClient.flush))
        results = run_cells(cells, max_workers=3)
    return results, seen


@pytest.fixture(scope="module")
def jax_events():
    """The JAX package's un-killed in-process run of the gateway
    matrix's schedule (run_gateway_kill_point's defaults)."""
    return event_fields(jax_reference(sessions=6, n_samples=600, workers=2))


@pytest.mark.parametrize("point", GATEWAY_KILL_POINTS + ("drain",))
def test_gateway_kill_matrix(wire_cells, jax_events, point):
    """The active gateway of a subprocess pair dies at each stage
    boundary mid-delivery (``drain`` restarts it gracefully): the
    standby takes the lease, the HA client resumes from the workers'
    watermarks, nothing is lost and the events equal the un-killed
    in-process run's, and, session for session, the JAX package's
    in-process run of the same schedule on the same recordings."""
    results, seen = wire_cells
    out = cell(results, point)
    assert out["ok"], (point, out["why"])
    assert out["windows_lost"] == 0
    assert out["gateways"] == 2 and out["lease_gen"] >= 2
    assert out["resumed_sessions"] >= 1
    assert out["reconnects"] + out["moved_receipts"] >= 1
    assert out["gateway_exit"] == (0 if point == "drain" else 137)
    assert event_fields(seen[point]) == jax_events


def test_wire_ingest_smoke_green(wire_cells):
    out = cell(wire_cells[0], "wire_ingest_smoke")
    assert out["ok"], out["why"]
    assert out["windows_lost"] == 0 and out["frames"] > 0
    assert out["ack_records_coalesced"] > 0
    assert out["ack_coalesce_ratio"] < 1.0
    json.dumps(out)


def test_gateway_ha_smoke_green(wire_cells):
    out = cell(wire_cells[0], "gateway_ha_smoke")
    assert out["ok"], out["why"]
    assert out["windows_lost"] == 0 and out["gateways"] == 2
    assert out["resumed_sessions"] >= 1
    assert out["tenant_sheds"].get("care", 0) == 0
    assert out["tenant_sheds"].get("bulk", 0) >= 1
    json.dumps(out)
