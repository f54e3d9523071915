"""Continuous journal replication on the port (har_tpu_torch.serve.net.tail
and har_tpu_torch.serve.replica): warm standbys and zero-transfer
failover.

The JAX package's contracts (tests/test_tail.py) on the port: a standby
tails a live worker's journal and keeps a warm replica; a source
rotation re-manifests and re-founds the replica; a caught-up failover
ships 0 bytes and restores as the in-place restore does; a partial tail
finalizes by pulling only the missing suffix; a cold-ship log and a
tailed directory finish under either client; warm placement steers the
hand-offs to the standby's neighbour; a broken standby falls back to the
cold path; the tail kill matrix and the cluster kill matrix with a warm
standby end with nothing lost and a zero-byte failover path.  Then,
against ``har_tpu`` on the same recordings: the tail kill matrix's
verdicts, and the warm-standby cluster kill matrix's delivered events,
equal the JAX package's run of the same cell.

Everything here is in-process (``LocalShipSource`` or an agent on a
thread); no test starts a process.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from har_tpu_torch.serve.chaos import (
    TAIL_KILL_POINTS,
    _DEFAULT_AT,
    run_cluster_kill_point,
    run_tail_kill_point,
)
from har_tpu_torch.serve.cluster import ClusterConfig, FleetCluster
from har_tpu_torch.serve.engine import FleetConfig, FleetServer
from har_tpu_torch.serve.faults import FakeClock
from har_tpu_torch.serve.journal import (
    SHIP_DONE,
    SHIP_LOG,
    FleetJournal,
    JournalConfig,
    JournalError,
    read_segment_from,
)
from har_tpu_torch.serve.loadgen import AnalyticDemoModel, synthetic_sessions
from har_tpu_torch.serve.net.ship import (
    ShipAgent,
    ShipClient,
    ShipError,
    ShipFaults,
    ShipTorn,
    fetch_journal,
    journal_manifest,
)
from har_tpu_torch.serve.net.tail import LocalShipSource, finalize_tail, tail_once
from har_tpu_torch.serve.replica import StandbyAgent, StandbyHost
from har_tpu_torch.serve.stats import FleetStats

torch.set_num_threads(1)

MODEL = AnalyticDemoModel()
_TIMING = ("failover_ms", "recovery_ms", "migration_ms")


# ------------------------------------------------------------ fixtures


def _live_fleet(jdir, *, sessions=4, snapshot_every=0, flush_every=8):
    """A journaled fleet left alive: the moving target a standby tails.
    ``snapshot_every=0`` keeps the attach-time snapshot as the only base
    (no rotation), so byte counts are exact."""
    server = FleetServer(
        MODEL, window=100, hop=50, channels=3, smoothing="ema",
        config=FleetConfig(max_sessions=sessions),
        journal=FleetJournal(str(jdir), JournalConfig(flush_every=flush_every,
                                                      snapshot_every=snapshot_every)),
    )
    for i in range(sessions):
        server.add_session(i)
    return server


def _push_rounds(server, rng, rounds, *, sessions=4):
    events = []
    for _ in range(rounds):
        for i in range(sessions):
            server.push(i, rng.normal(size=(50, 3)).astype(np.float32))
        events.extend(server.poll(force=True))
    return events


def _standby_over(host_root, sb_root, *, wid="w0", **kw):
    return StandbyAgent(str(sb_root), {wid: LocalShipSource(str(host_root))},
                        loader=MODEL, chunk_bytes=1024, **kw)


class _AgentThread:
    """An in-process ship agent on a background thread."""

    def __init__(self, root):
        self.agent = ShipAgent(str(root))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            self.agent.rpc.step(0.02)

    def client(self, **kw) -> ShipClient:
        return ShipClient(self.agent.rpc.host, self.agent.rpc.port, **kw)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
        self.agent.close()


def _fast_cluster(root, n, clock):
    return FleetCluster(
        MODEL, str(root), workers=3, window=200, hop=200, smoothing="ema",
        fleet_config=FleetConfig(max_sessions=n, max_delay_ms=0.0),
        config=ClusterConfig(lease_s=0.2, probe_retries=2, probe_base_ms=10.0,
                             probe_cap_ms=50.0),
        clock=clock,
    )


# ------------------------------------------------- matrix declaration


def test_tail_kill_points_declared_and_calibrated():
    assert TAIL_KILL_POINTS == ("mid_tail_recv", "mid_tail_remanifest", "post_tail_verify")
    assert {p: _DEFAULT_AT[p] for p in TAIL_KILL_POINTS} == {
        "mid_tail_recv": 2, "mid_tail_remanifest": 1, "post_tail_verify": 1}


# ------------------------------------------------------- live tailing


def test_tail_warms_a_live_replica_and_catches_up(tmp_path):
    """The replica is warm while the source keeps scoring; a tailing
    directory is not restorable before its finalize; once the source is
    quiet the lag gauges drain to zero."""
    host_root = tmp_path / "host"
    server = _live_fleet(host_root / "w0")
    sb = _standby_over(host_root, tmp_path / "sb")
    rng = np.random.default_rng(0)
    try:
        for _ in range(4):
            _push_rounds(server, rng, 2)
            sb.cycle()
        replica = sb.replicas["w0"]
        assert replica.server is not None and replica.applied_records > 0
        assert sb.stats.shipped_bytes > 0
        assert os.path.exists(os.path.join(sb.dest("w0"), SHIP_LOG))
        assert not os.path.exists(os.path.join(sb.dest("w0"), SHIP_DONE))
        with pytest.raises(JournalError):
            FleetServer.restore(sb.dest("w0"), MODEL)
        server.journal.kill()
        sb.cycle()
        sb.cycle()
        assert sb.stats.replication_lag_bytes["w0"] == 0
        assert sb.stats.replication_lag_records["w0"] == 0
        status = sb.status()["replication"]["w0"]
        assert status["ready"] is True and status["parked"] is None
        assert status["applied_records"] == replica.applied_records
        assert status["base"] == replica.base
    finally:
        sb.close()


def test_rotation_remanifests_and_rebuilds_the_replica(tmp_path):
    """A source snapshot rotates the base under the tail: a durable
    ``ship_remanifest`` lands and the replica re-founds on the newest
    snapshot."""
    host_root = tmp_path / "host"
    server = _live_fleet(host_root / "w0", snapshot_every=20)
    sb = _standby_over(host_root, tmp_path / "sb")
    rng = np.random.default_rng(1)
    try:
        base0 = None
        for _ in range(6):
            _push_rounds(server, rng, 2)
            sb.cycle()
            if base0 is None and "w0" in sb.replicas:
                base0 = sb.replicas["w0"].base
        server.journal.kill()
        sb.cycle()
        sb.cycle()
        replica = sb.replicas["w0"]
        assert replica.base > base0 and replica.rebuilds >= 2
        records, _ = read_segment_from(os.path.join(sb.dest("w0"), SHIP_LOG), 0)
        assert any(rec["t"] == "ship_remanifest" for rec, _ in records)
        assert sb.stats.replication_lag_bytes["w0"] == 0
    finally:
        sb.close()


def test_caught_up_failover_ships_zero_bytes(tmp_path):
    """With the tail caught up when the worker dies, finalize verifies
    the digests of local bytes and pulls nothing; the restore equals the
    in-place restore of the dead worker's own directory."""
    host_root = tmp_path / "host"
    jdir = host_root / "w0"
    server = _live_fleet(jdir)
    sb = _standby_over(host_root, tmp_path / "sb")
    rng = np.random.default_rng(2)
    try:
        for _ in range(3):
            _push_rounds(server, rng, 2)
            sb.cycle()
        server.journal.kill()
        sb.cycle()
        fin = sb.finalize("w0")
        assert fin["bytes"] == 0 and fin["files"] > 0, fin
        assert os.path.exists(os.path.join(sb.dest("w0"), SHIP_DONE))
        assert sb.stats.shipped_bytes == sum(e["size"] for e in journal_manifest(str(jdir)))
        restored = FleetServer.restore(sb.dest("w0"), MODEL)
        in_place = FleetServer.restore(str(jdir), MODEL)
        assert set(restored._sessions) == set(in_place._sessions)
        for sid, live in in_place._sessions.items():
            twin = restored._sessions[sid]
            assert twin.n_scored == live.n_scored
            np.testing.assert_array_equal(twin.asm._ring, live.asm._ring)
            np.testing.assert_array_equal(twin.smoother._ema, live.smoother._ema)
        assert restored.stats.accounting() == in_place.stats.accounting()
    finally:
        sb.close()


def test_finalize_drains_a_partial_tail(tmp_path):
    """A standby that fell behind pays only the missing suffix."""
    host_root = tmp_path / "host"
    jdir = host_root / "w0"
    server = _live_fleet(jdir)
    sb = _standby_over(host_root, tmp_path / "sb")
    rng = np.random.default_rng(3)
    try:
        _push_rounds(server, rng, 2)
        sb.cycle()
        pulled = sb.stats.shipped_bytes
        assert pulled > 0
        _push_rounds(server, rng, 4)
        server.journal.kill()
        fin = sb.finalize("w0")
        total = sum(e["size"] for e in journal_manifest(str(jdir)))
        assert 0 < fin["bytes"] < total
        assert pulled + fin["bytes"] == total
        assert FleetServer.restore(sb.dest("w0"), MODEL).stats.accounting()["balanced"]
    finally:
        sb.close()


def test_tail_staging_equals_jax(tmp_path):
    """The same live journal tailed by both packages' ``tail_once`` and
    finalized by their ``finalize_tail``: ship logs, done markers and
    staged files equal byte for byte, and the counters agree."""
    from har_tpu.serve.net.tail import LocalShipSource as JaxSource
    from har_tpu.serve.net.tail import finalize_tail as jax_finalize
    from har_tpu.serve.net.tail import tail_once as jax_tail

    host_root = tmp_path / "host"
    server = _live_fleet(host_root / "w0", snapshot_every=20)
    rng = np.random.default_rng(6)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    for _ in range(5):
        _push_rounds(server, rng, 2)
        a = tail_once(LocalShipSource(str(host_root)), "w0", ours, chunk_bytes=600)
        b = jax_tail(JaxSource(str(host_root)), "w0", theirs, chunk_bytes=600)
        assert a == b
    server.journal.kill()
    a = finalize_tail(LocalShipSource(str(host_root)), "w0", ours, chunk_bytes=600)
    b = jax_finalize(JaxSource(str(host_root)), "w0", theirs, chunk_bytes=600)
    assert a == b
    names = sorted(n for n in os.listdir(ours))
    assert names == sorted(os.listdir(theirs))
    for rel in [e["f"] for e in journal_manifest(ours)] + [SHIP_LOG, SHIP_DONE]:
        with open(os.path.join(ours, rel), "rb") as f1, open(os.path.join(theirs, rel), "rb") as f2:
            assert f1.read() == f2.read(), rel


# --------------------------------------- cold-ship log compatibility


def test_cold_ship_log_finalizes_under_the_tail_client(tmp_path):
    """A transfer started by ``fetch_journal`` and torn mid-ship is
    completed by ``finalize_tail`` over the same agent: a resume."""
    host_root = tmp_path / "host"
    jdir = host_root / "w0"
    server = _live_fleet(jdir)
    _push_rounds(server, np.random.default_rng(4), 4)
    server.journal.kill()
    srv = _AgentThread(host_root)
    client = srv.client()
    dest = str(tmp_path / "staged")
    try:
        with pytest.raises(ShipTorn):
            fetch_journal(client, "w0", dest, chunk_bytes=512, faults=ShipFaults("torn", at=3))
        fin = finalize_tail(client, "w0", dest, chunk_bytes=512, stats=FleetStats())
        assert fin["resumes"] == 1
        total = sum(e["size"] for e in journal_manifest(str(jdir)))
        assert 0 < fin["bytes"] < total
        assert os.path.exists(os.path.join(dest, SHIP_DONE))
        assert FleetServer.restore(dest, MODEL).stats.accounting()["balanced"]
    finally:
        client.close()
        srv.close()


def test_tail_started_dir_completes_under_fetch_journal(tmp_path):
    """A directory a standby began tailing, interrupted mid-pull, is a
    resume point for the cold ship at failover."""
    from har_tpu_torch.serve.chaos import KillPlan, SimulatedCrash

    host_root = tmp_path / "host"
    jdir = host_root / "w0"
    server = _live_fleet(jdir)
    _push_rounds(server, np.random.default_rng(5), 4)
    server.journal.kill()
    dest = str(tmp_path / "staged")
    with pytest.raises(SimulatedCrash):
        tail_once(LocalShipSource(str(host_root)), "w0", dest, chunk_bytes=512,
                  chaos=KillPlan("mid_tail_recv", 3))
    srv = _AgentThread(host_root)
    client = srv.client()
    try:
        out = fetch_journal(client, "w0", dest, chunk_bytes=512)
        assert out["resumes"] == 1
        total = sum(e["size"] for e in journal_manifest(str(jdir)))
        assert 0 < out["bytes"] < total
        assert FleetServer.restore(dest, MODEL).stats.accounting()["balanced"]
    finally:
        client.close()
        srv.close()


# ------------------------------------------------- standby lifecycle


def test_standby_parks_on_missing_source_then_recovers(tmp_path):
    """A missing source parks (visible in the status) and warms on the
    first cycle after it appears."""
    host_root = tmp_path / "host"
    os.makedirs(host_root)
    sb = _standby_over(host_root, tmp_path / "sb")
    try:
        sb.cycle()
        assert "w0" in sb.parked
        assert sb.status()["replication"]["w0"]["parked"] is not None
        assert not sb.holds("w0")
        server = _live_fleet(host_root / "w0")
        _push_rounds(server, np.random.default_rng(7), 2)
        server.journal.kill()
        sb.cycle()
        sb.cycle()
        assert "w0" not in sb.parked and sb.holds("w0")
        status = sb.status()
        assert status["sources"] == ["w0"]
        section = status["replication"]["w0"]
        assert section["ready"] is True and section["lag_bytes"] == 0
        assert set(section) == {"lag_records", "lag_bytes", "base", "applied_records",
                                "rebuilds", "ready", "parked"}
    finally:
        sb.close()


def test_replication_gauges_ephemeral_and_snapshotted():
    """The lag gauges are in every stats snapshot and never in the
    journal's durable state."""
    stats = FleetStats()
    stats.replication_lag_records["w0"] = 7
    stats.replication_lag_bytes["w0"] = 4096
    snap = stats.snapshot()
    assert snap["replication_lag_records"] == {"w0": 7}
    assert snap["replication_lag_bytes"] == {"w0": 4096}
    state = stats.state()
    assert "replication_lag_records" not in json.dumps(state)
    fresh = FleetStats()
    fresh.load_state(state)
    assert fresh.replication_lag_records == {} and fresh.replication_lag_bytes == {}
    assert fresh.unknown_state_keys == 0


def test_standby_host_registers_status_rpc(tmp_path):
    """``serve-agent --follow``: a ship agent, standby cycles and the
    ``standby_status`` RPC on one socket."""
    host = StandbyHost(str(tmp_path / "sb"), {}, port=0, loader=MODEL)
    try:
        assert "standby_status" in host.agent.rpc.handlers
        body, blob = host.agent.rpc.handlers["standby_status"]({}, b"")
        assert body["replication"] == {} and blob == b""
    finally:
        host.close()


def test_parse_follow_specs():
    from har_tpu_torch.serve.net.ship import _parse_follow

    assert _parse_follow(["w0=127.0.0.1:7001", "w1=host:80"]) == {
        "w0": ("127.0.0.1", 7001), "w1": ("host", 80)}
    for bad in (["w0=nohost"], ["justaname"]):
        with pytest.raises(SystemExit):
            _parse_follow(bad)


# --------------------------------------------- controller integration


def test_warm_placement_prefers_the_standby_adjacent_worker(tmp_path):
    """Failover hand-offs go to the worker registered next to the
    standby's replica, ahead of the ring owner, and the partition comes
    from the standby at zero transfer."""
    from har_tpu_torch.serve.chaos import _drive_cluster

    n = 9
    recordings, _ = synthetic_sessions(n, windows_per_session=2, seed=11)
    clock = FakeClock()
    cluster = _fast_cluster(tmp_path / "fleet", n, clock)
    for i in range(n):
        cluster.add_session(i)
    victim = cluster.worker_of(0)
    prefer = next(w for w in cluster.workers if w != victim)
    sb = StandbyAgent(str(tmp_path / "replica"),
                      {victim: LocalShipSource(str(tmp_path / "fleet"))}, loader=MODEL)
    cluster.register_standby(sb, prefer=prefer)
    killed = {"done": False}

    def on_round(c):
        if not killed["done"]:
            c._workers[victim].kill()
            killed["done"] = True

    events, cursors = [], [0] * n
    _drive_cluster(cluster, recordings, cursors, 200, 200, clock, events, on_round)
    stats = cluster.cluster_stats()
    assert (stats["failovers"], stats["standbys"], stats["standby_fetches"],
            stats["failover_path_bytes"]) == (1, 1, 1, 0)
    assert cluster.migration_log
    for entry in cluster.migration_log:
        assert (entry["from"], entry["to"]) == (victim, prefer)
    acct = cluster.accounting()
    assert acct["balanced"] and acct["pending"] == 0
    cluster.close()


def test_broken_standby_falls_back_to_the_cold_path(tmp_path):
    """A standby that claims the partition but cannot finalize: the
    failover falls back to the dead worker's own journal and lands."""

    class _BrokenStandby:
        def __init__(self):
            self.stats = FleetStats()
            self.finalizes = 0

        def holds(self, wid):
            return True

        def cycle(self):
            return {"sources": {}, "lag_records": 0, "lag_bytes": 0}

        def finalize(self, wid):
            self.finalizes += 1
            raise ShipError("simulated broken standby")

        def dest(self, wid):
            return str(tmp_path / "nowhere")

        def close(self):
            pass

    from har_tpu_torch.serve.chaos import _drive_cluster

    n = 6
    recordings, _ = synthetic_sessions(n, windows_per_session=2, seed=12)
    clock = FakeClock()
    cluster = _fast_cluster(tmp_path / "fleet", n, clock)
    for i in range(n):
        cluster.add_session(i)
    broken = _BrokenStandby()
    cluster.register_standby(broken)
    victim = cluster.worker_of(0)
    killed = {"done": False}

    def on_round(c):
        if not killed["done"]:
            c._workers[victim].kill()
            killed["done"] = True

    events, cursors = [], [0] * n
    _drive_cluster(cluster, recordings, cursors, 200, 200, clock, events, on_round)
    stats = cluster.cluster_stats()
    assert stats["failovers"] == 1 and broken.finalizes >= 1
    assert stats["standby_fetches"] == 0 and stats["failover_path_bytes"] == 0
    acct = cluster.accounting()
    assert acct["balanced"] and acct["pending"] == 0
    cluster.close()


# ------------------------------------------------------- chaos matrix


@pytest.mark.parametrize("point", TAIL_KILL_POINTS)
def test_tail_kill_matrix(point):
    """The standby killed mid-pull (its replacement resumes with zero
    re-pulled bytes), at the re-manifest boundary, or the finalize
    killed after its verify over a partial tail: streams equal to the
    unkilled schedule, nothing lost; the verdict equals the JAX
    package's for the same cell (timings aside)."""
    from har_tpu.serve.chaos import run_tail_kill_point as jax_run

    out = run_tail_kill_point(point, sessions=6, seed=0)
    assert out["ok"], f"{point}: {out['why']}"
    assert out["windows_lost"] == 0
    if point == "post_tail_verify":
        assert out["failover_path_bytes"] > 0
    else:
        assert out["failover_path_bytes"] == 0
    theirs = jax_run(point, sessions=6, seed=0)
    assert set(out) == set(theirs)
    assert {k: v for k, v in out.items() if k not in _TIMING} == {
        k: v for k, v in theirs.items() if k not in _TIMING}


def _captured_events(chaos_module, monkeypatch):
    """Record the delivered events a cluster kill cell hands its
    verdict."""
    seen = []
    real = chaos_module._cluster_verdict

    def spy(point, ref_events, events, *args, **kwargs):
        seen.append(list(events))
        return real(point, ref_events, events, *args, **kwargs)

    monkeypatch.setattr(chaos_module, "_cluster_verdict", spy)
    return seen


def _fields(events):
    out = {}
    for fe in events:
        ev = fe.event
        out.setdefault(fe.session_id, []).append(
            (ev.t_index, ev.label, ev.raw_label, ev.drift, ev.probability.tobytes()))
    return out


@pytest.mark.parametrize("point", ("mid_dispatch", "mid_handoff", "mid_migration"))
def test_cluster_kill_matrix_with_warm_standby(point, monkeypatch):
    """The worker-axis matrix with a registered warm standby: the same
    verdicts, the partition restored from the standby at zero
    failover-path bytes, and the delivered events, session for session,
    equal to the JAX package's run of the same cell on the same
    recordings."""
    import har_tpu.serve.chaos as jax_chaos

    import har_tpu_torch.serve.chaos as chaos

    ours_seen = _captured_events(chaos, monkeypatch)
    theirs_seen = _captured_events(jax_chaos, monkeypatch)
    out = run_cluster_kill_point(point, sessions=12, workers=3, seed=0, standby=True)
    assert out["ok"], f"{point}: {out['why']}"
    assert out["windows_lost"] == 0
    assert out["standby_fetches"] >= 1 and out["failover_path_bytes"] == 0
    theirs = jax_chaos.run_cluster_kill_point(point, sessions=12, workers=3, seed=0,
                                              standby=True)
    assert theirs["ok"], theirs["why"]
    assert {k: v for k, v in out.items() if k not in _TIMING} == {
        k: v for k, v in theirs.items() if k not in _TIMING}
    assert len(ours_seen) == len(theirs_seen) == 1
    assert _fields(ours_seen[0]) == _fields(theirs_seen[0])
