"""The fleet cluster's control plane (har_tpu_torch.serve.cluster) on the
CPU: routing, lease-based failure detection, journal hand-off migration,
failover, and the cross-worker conservation law.

The JAX package's tests/test_cluster.py on the port (imports renamed,
the CLI case run in-process with ``--device cpu``), then the port
against ``har_tpu`` on the same inputs:

  - router placements equal for 10,000 ids over 1-8 workers;
  - ``Membership``'s decisions equal on one FakeClock schedule;
  - a 3-worker cluster's events, accounting and control-plane stats
    equal ``har_tpu.serve.cluster.FleetCluster``'s on the same schedule,
    with and without a worker kill: decision fields exact with the
    analytic demo model, and probabilities within 1e-5 for the CLI
    transformer (2 layers, float32, flax's parameters carried over);
  - ``run_cluster_kill_point``'s verdicts equal for both control-plane
    kill points.
"""

import json

import numpy as np
import pytest
import torch

from har_tpu_torch import cli
from har_tpu_torch.serve import FakeClock, FleetConfig, FleetServer
from har_tpu_torch.serve.chaos import (
    CLUSTER_KILL_POINTS,
    KILL_POINTS,
    KillPlan,
    SimulatedCrash,
    run_cluster_kill_point,
)
from har_tpu_torch.serve.cluster import (
    ClusterConfig,
    ClusterError,
    ConsistentHashRouter,
    FleetCluster,
    LeaseConfig,
    Membership,
    WorkerUnavailable,
    broadcast,
    cluster_failover_smoke,
    map_fn,
    reduce_mean,
    reduce_sum,
    stable_hash,
)
from har_tpu_torch.serve.loadgen import (
    AnalyticDemoModel,
    drive_fleet,
    synthetic_sessions,
)

torch.set_num_threads(1)

MODEL = AnalyticDemoModel()


def _decision_fields(fe):
    ev = fe.event
    return (ev.t_index, ev.label, ev.raw_label, ev.drift,
            ev.probability.tobytes())


def _by_session(events):
    out = {}
    for e in events:
        out.setdefault(e.session_id, []).append(_decision_fields(e))
    return out


def _mk_cluster(root, clock, n_sessions, *, workers=3, hop=200,
                **cluster_kw):
    cluster = FleetCluster(
        MODEL,
        str(root),
        workers=workers,
        window=200,
        hop=hop,
        smoothing="ema",
        fleet_config=FleetConfig(
            max_sessions=n_sessions, max_delay_ms=0.0
        ),
        config=ClusterConfig(
            lease_s=0.2, probe_retries=2, probe_base_ms=10.0,
            probe_cap_ms=50.0,
        ),
        clock=clock,
        **cluster_kw,
    )
    for i in range(n_sessions):
        cluster.add_session(i)
    return cluster


# ------------------------------------------------------------- router


def test_router_deterministic_and_covers_all_workers():
    r1 = ConsistentHashRouter()
    r2 = ConsistentHashRouter()
    for w in ("w0", "w1", "w2"):
        r1.add_worker(w)
        r2.add_worker(w)
    sids = list(range(200))
    assert [r1.owner(s) for s in sids] == [r2.owner(s) for s in sids]
    part = r1.partition(sids)
    assert set(part) == {"w0", "w1", "w2"}
    # virtual nodes keep the split reasonably even
    assert all(len(v) > 20 for v in part.values())


def test_router_removal_moves_only_the_dead_workers_sessions():
    r = ConsistentHashRouter()
    for w in ("w0", "w1", "w2"):
        r.add_worker(w)
    sids = list(range(300))
    before = {s: r.owner(s) for s in sids}
    r.remove_worker("w1")
    after = {s: r.owner(s) for s in sids}
    for s in sids:
        if before[s] != "w1":
            # consistent hashing: survivors' sessions never reshuffle
            assert after[s] == before[s]
        else:
            assert after[s] in ("w0", "w2")
    with pytest.raises(ValueError):
        r.remove_worker("w1")
    with pytest.raises(ValueError):
        r.add_worker("w0")


@pytest.mark.parametrize("workers", range(1, 9))
def test_router_placements_equal_jax(workers):
    """The same ring as ``har_tpu``'s: 10,000 session ids (ints and
    strings) land on the same worker over 1-8 workers, and removing a
    worker moves the same sessions."""
    from har_tpu.serve.cluster import ConsistentHashRouter as JaxRouter
    from har_tpu.serve.cluster import stable_hash as jax_hash

    sids = list(range(5000)) + [f"s{i}" for i in range(5000)]
    assert [stable_hash(s) for s in sids[::97]] == [jax_hash(s) for s in sids[::97]]
    ours, theirs = ConsistentHashRouter(), JaxRouter()
    for i in range(workers):
        ours.add_worker(f"w{i}")
        theirs.add_worker(f"w{i}")
    assert [ours.owner(s) for s in sids] == [theirs.owner(s) for s in sids]
    if workers > 1:
        ours.remove_worker("w0")
        theirs.remove_worker("w0")
        assert ours.partition(sids) == theirs.partition(sids)


# --------------------------------------------------------- membership


def test_membership_death_needs_lease_expiry_and_probe_budget():
    clock = FakeClock()
    m = Membership(
        LeaseConfig(lease_s=1.0, probe_retries=3, probe_base_ms=10.0,
                    probe_cap_ms=40.0),
        clock=clock,
    )
    m.add("w0")
    # failures alone do not declare death while the lease holds
    for _ in range(5):
        m.note_failure("w0")
    assert m.expired() == ()
    # lease expiry alone (no probe failures) does not either
    m.add("w1")
    clock.advance(2.0)
    declared = m.expired()
    # w1's lease expired too, but with zero failed probes it stays;
    # w0 met BOTH conditions and is declared in the same sweep
    assert declared == ("w0",)
    assert m.dead == ("w0",)
    assert "w0" not in m.alive() and "w1" in m.alive()


def test_membership_probes_pace_by_capped_backoff():
    clock = FakeClock()
    m = Membership(
        LeaseConfig(lease_s=10.0, probe_retries=2, probe_base_ms=10.0,
                    probe_cap_ms=20.0),
        clock=clock,
    )
    m.add("w0")
    assert m.probe_due("w0")  # healthy: always probe-due
    m.note_failure("w0")
    assert not m.probe_due("w0")  # suspected: wait out the backoff
    clock.advance(0.05)  # > cap, certainly past the first delay
    assert m.probe_due("w0")
    # a success clears suspicion and re-arms immediate probing
    m.note_failure("w0")
    m.note_ok("w0")
    assert m.probe_due("w0")


def test_membership_decisions_equal_jax():
    """One seeded schedule of successes, refusals, timeouts and clock
    steps over four workers: every probe-due, suspicion and death
    decision equals ``har_tpu``'s (the same backoff draws)."""
    from har_tpu.serve.cluster import LeaseConfig as JaxLease
    from har_tpu.serve.cluster import Membership as JaxMembership
    from har_tpu.serve.faults import FakeClock as JaxClock

    cfg = dict(lease_s=0.3, probe_retries=3, probe_base_ms=20.0,
               probe_cap_ms=120.0, seed=7)
    ours_clock, jax_clock = FakeClock(), JaxClock()
    ours = Membership(LeaseConfig(**cfg), clock=ours_clock)
    theirs = JaxMembership(JaxLease(**cfg), clock=jax_clock)
    wids = ["w0", "w1", "w2", "w3"]
    for w in wids:
        ours.add(w)
        theirs.add(w)
    rng = np.random.default_rng(3)
    log_ours, log_theirs = [], []
    for step in range(400):
        wid = wids[int(rng.integers(len(wids)))]
        kind = ("ok", "failure", "timeout", "advance")[int(rng.integers(4))]
        for m, clock, log in ((ours, ours_clock, log_ours),
                              (theirs, jax_clock, log_theirs)):
            if kind == "advance":
                clock.advance(0.01 * (1 + step % 7))
            else:
                getattr(m, f"note_{kind}")(wid)
            log.append((
                m.expired(), m.alive(), m.dead,
                tuple(m.probe_due(w) for w in wids),
                tuple(m.suspected(w) for w in wids),
            ))
    assert log_ours == log_theirs
    assert ours.dead  # the schedule declared at least one death


# --------------------------------------------------------- primitives


def test_drjax_primitives_reduce_shapes():
    ws = ["a", "b", "c"]
    assert broadcast(7, ws) == [7, 7, 7]
    assert map_fn(str.upper, ws) == ["A", "B", "C"]
    assert reduce_sum([1, 2, 3]) == 6
    assert reduce_mean([1.0, 3.0]) == 2.0
    np.testing.assert_array_equal(
        reduce_sum([np.ones(2), np.ones(2)]), np.full(2, 2.0)
    )
    # dict-recursive over the union of keys; bools AND (the global
    # conservation law's summation shape)
    out = reduce_sum(
        [
            {"enqueued": 3, "balanced": True, "inner": {"x": 1}},
            {"enqueued": 4, "balanced": True, "inner": {"x": 2},
             "extra": 5},
        ]
    )
    assert out == {
        "enqueued": 7, "balanced": True, "inner": {"x": 3}, "extra": 5
    }
    assert reduce_sum([{"balanced": True}, {"balanced": False}])[
        "balanced"
    ] is False


# ------------------------------------------------- cluster equivalence


def test_cluster_events_bit_identical_to_single_server(tmp_path):
    """Partitioning is invisible: the same load through a 3-worker
    cluster and through one FleetServer emits bit-identical per-session
    event streams (decision fields), and the global accounting equals
    the single server's."""
    n = 24
    recordings, _ = synthetic_sessions(n, windows_per_session=3, seed=5)
    clock = FakeClock()
    cluster = _mk_cluster(tmp_path / "c", clock, n)
    cluster_events, _ = drive_fleet(cluster, recordings, seed=5)

    single = FleetServer(
        MODEL, window=200, hop=200, smoothing="ema",
        config=FleetConfig(max_sessions=n, max_delay_ms=0.0),
        clock=FakeClock(),
    )
    for i in range(n):
        single.add_session(i)
    single_events, _ = drive_fleet(single, recordings, seed=5)

    assert _by_session(cluster_events) == _by_session(single_events)
    acct = cluster.accounting()
    sacct = single.stats.accounting()
    for key in ("enqueued", "scored", "dropped", "pending"):
        assert acct[key] == sacct[key]
    assert acct["balanced"] and acct["pending"] == 0
    assert acct["workers"] == 3
    # every worker actually served a share
    stats = cluster.cluster_stats()
    assert all(v > 0 for v in stats["per_worker_sessions"].values())
    cluster.close()


def test_planned_migration_invisible_and_counted(tmp_path):
    """Live rebalancing: drain → hand-off → resume moves a session
    between workers with a bit-identical event stream, carried
    counters, and the migration observables incremented."""
    n = 8
    recordings, _ = synthetic_sessions(n, windows_per_session=4, seed=2)
    halves = [np.array_split(r, 2) for r in recordings]

    def run(migrate):
        clock = FakeClock()
        root = tmp_path / ("mig" if migrate else "ref")
        cluster = _mk_cluster(root, clock, n)
        events = []
        for i in range(n):
            cluster.push(i, halves[i][0])
        events.extend(cluster.flush())
        moved = None
        if migrate:
            src = cluster.worker_of(0)
            target = next(
                w for w in cluster.workers if w != src
            )
            cluster.migrate_session(0, target)
            moved = (src, target)
        for i in range(n):
            cluster.push(i, halves[i][1])
        events.extend(cluster.flush())
        return cluster, events, moved

    ref_cluster, ref_events, _ = run(False)
    cluster, events, (src, target) = run(True)
    assert _by_session(events) == _by_session(ref_events)
    assert cluster.worker_of(0) == target
    tstats = cluster._workers[target].server.stats
    assert tstats.migrations == 1
    assert tstats.migration_ms > 0
    assert cluster.migration_log == [
        {"sid": 0, "from": src, "to": target}
    ]
    # the session's history moved with it (per-session continuity)
    sess = cluster._workers[target].server._sessions[0]
    assert sess.handoffs == 1
    assert sess.n_scored == 4
    acct = cluster.accounting()
    assert acct["balanced"] and acct["pending"] == 0
    ref_cluster.close()
    cluster.close()


def test_export_refuses_live_windows_and_duplicate_adopt(tmp_path):
    from har_tpu_torch.serve import AdmissionError

    clock = FakeClock()
    cluster = _mk_cluster(tmp_path, clock, 4)
    wid = cluster.worker_of(1)
    server = cluster._workers[wid].server
    rng = np.random.default_rng(0)
    # a full window queued but not yet scored: hand-off must refuse
    server.push(1, rng.normal(size=(200, 3)).astype(np.float32))
    with pytest.raises(AdmissionError, match="live window"):
        server.export_session(1)
    server.flush()
    export = server.export_session(1)
    other = next(w for w in cluster.workers if w != wid)
    cluster._workers[other].server.adopt_session(export)
    with pytest.raises(AdmissionError, match="already admitted"):
        cluster._workers[other].server.adopt_session(export)
    cluster.close()


def test_adopt_and_handoff_records_replay_on_worker_crash(tmp_path):
    """The journal side of the hand-off protocol: after a migration,
    killing the TARGET recovers the adopted session (adopt record
    replay — ring, smoother, counters, generation), and killing the
    SOURCE recovers its eviction (handoff record replay)."""
    n = 6
    recordings, _ = synthetic_sessions(n, windows_per_session=4, seed=9)
    clock = FakeClock()
    cluster = _mk_cluster(tmp_path, clock, n)
    for i in range(n):
        cluster.push(i, recordings[i][:400])
    cluster.flush()
    src = cluster.worker_of(0)
    target = next(w for w in cluster.workers if w != src)
    cluster.migrate_session(0, target)
    live = cluster._workers[target].server._sessions[0]
    # SIGKILL both sides; their journals must reconstruct the move
    src_dir = cluster._workers[src].journal_dir
    target_dir = cluster._workers[target].journal_dir
    for w in cluster._workers.values():
        w.kill()

    restored_t = FleetServer.restore(target_dir, MODEL)
    assert 0 in restored_t._sessions
    adopted = restored_t._sessions[0]
    assert adopted.handoffs == 1
    assert adopted.n_scored == live.n_scored == 2
    assert adopted.raw_seen == live.raw_seen == 400
    np.testing.assert_array_equal(
        adopted.asm._ring, live.asm._ring
    )
    np.testing.assert_array_equal(
        adopted.smoother._ema, live.smoother._ema
    )
    assert restored_t.stats.migrations == 1

    restored_s = FleetServer.restore(src_dir, MODEL)
    assert 0 not in restored_s._sessions  # handoff replayed
    acct = restored_s.stats.accounting()
    assert acct["balanced"]


# ----------------------------------------------------------- failover


def test_worker_kill_failover_192_sessions_pin():
    """192 sessions across 3 workers under FakeClock + DispatchFaults,
    one worker SIGKILLed mid-dispatch — all of its sessions resume on
    survivors from their watermarks, the global conservation law holds
    in every post-failover snapshot, zero events are scored twice, and
    every migrated session's stream is bit-identical to the same load
    run without the kill."""
    out = run_cluster_kill_point(
        "mid_dispatch", sessions=192, workers=3, seed=0
    )
    assert out["ok"], out["why"]
    assert out["failovers"] == 1
    assert out["migrated_sessions"] > 0
    assert out["windows_lost"] == 0
    assert out["workers"] == 2  # the victim retired
    assert out["accounting"]["balanced"]
    assert out["accounting"]["pending"] == 0


@pytest.mark.parametrize("point", KILL_POINTS + CLUSTER_KILL_POINTS)
def test_cluster_kill_matrix(point):
    """The worker-axis chaos matrix: each engine stage boundary killed
    INSIDE one worker of a live cluster, plus the two control-plane
    points (controller killed mid-migration / mid-hand-off, surviving
    workers taken over) — every point must end with zero double-scored
    events, bit-identical migrated streams and global conservation."""
    out = run_cluster_kill_point(point, sessions=12, workers=3, seed=0)
    assert out["ok"], f"{point}: {out['why']}"
    assert out["windows_lost"] == 0


def test_whole_node_resume_continues_all_partitions(tmp_path):
    """Total node loss: every worker's journal killed mid-run, then
    ``FleetCluster.resume`` rebuilds the whole cluster from the
    directories and the transport re-delivers from the recovered
    watermarks — combined streams bit-identical to an uninterrupted
    cluster run."""
    n = 9
    recordings, _ = synthetic_sessions(n, windows_per_session=4, seed=4)

    clock = FakeClock()
    cluster = _mk_cluster(tmp_path / "j", clock, n)
    events = []
    for i in range(n):
        cluster.push(i, recordings[i][:400])
    events.extend(cluster.flush())
    for w in cluster._workers.values():
        w.kill()  # the node dies

    resumed = FleetCluster.resume(
        MODEL, str(tmp_path / "j"), clock=FakeClock(clock.t),
        config=cluster.config,
    )
    assert sorted(resumed.sessions) == list(range(n))
    events.extend(resumed.poll(force=True))
    for i in range(n):
        rest = recordings[i][resumed.watermark(i):]
        if len(rest):
            resumed.push(i, rest)
    events.extend(resumed.flush())

    ref = _mk_cluster(tmp_path / "ref", FakeClock(), n)
    ref_events = []
    for i in range(n):
        ref.push(i, recordings[i][:400])
    ref_events.extend(ref.flush())
    for i in range(n):
        ref.push(i, recordings[i][400:])
    ref_events.extend(ref.flush())
    assert _by_session(events) == _by_session(ref_events)
    keys = [(e.session_id, e.event.t_index) for e in events]
    assert len(keys) == len(set(keys))
    acct = resumed.accounting()
    assert acct["balanced"] and acct["pending"] == 0
    ref.close()
    resumed.close()


def test_mid_handoff_takeover_resolves_dual_ownership(tmp_path):
    """A controller crash between the target's durable adopt and the
    source's eviction leaves the session on BOTH journals (and both
    live workers).  The takeover controller must resolve to the
    adopted copy (higher ``handoffs`` generation), evict the stale one
    with a journaled hand-off, and keep the stream bit-identical."""
    n = 6
    recordings, _ = synthetic_sessions(n, windows_per_session=4, seed=7)

    def run(crash):
        clock = FakeClock()
        root = tmp_path / ("crash" if crash else "ref")
        cluster = _mk_cluster(root, clock, n)
        events = []
        for i in range(n):
            cluster.push(i, recordings[i][:400])
        events.extend(cluster.flush())
        src = cluster.worker_of(0)
        target = next(w for w in cluster.workers if w != src)
        if crash:
            cluster.chaos = KillPlan("mid_handoff", 1)
            with pytest.raises(SimulatedCrash):
                cluster.migrate_session(0, target)
            # both live workers own session 0 now
            assert cluster._workers[src].owns(0)
            assert cluster._workers[target].owns(0)
            survivors = list(cluster._workers.values())
            cluster = FleetCluster.takeover(
                MODEL, str(root), survivors,
                config=cluster.config, clock=clock,
            )
            # dual ownership resolved to the adopter
            assert cluster.worker_of(0) == target
            assert not cluster._workers[src].owns(0)
            assert cluster._workers[target].server._sessions[
                0
            ].handoffs == 1
        else:
            cluster.migrate_session(0, target)
        for i in range(n):
            cluster.push(i, recordings[i][400:])
        events.extend(cluster.flush())
        acct = cluster.accounting()
        assert acct["balanced"] and acct["pending"] == 0
        cluster.close()
        return events

    assert _by_session(run(True)) == _by_session(run(False))


def test_failover_falls_past_a_full_target_worker(tmp_path):
    """A capacity refusal is not a failure: when a dead worker's
    sessions hash to a survivor already at ``max_sessions``, the
    hand-off must fall through to the next live worker instead of
    aborting the failover."""
    n = 6
    clock = FakeClock()
    cluster = FleetCluster(
        MODEL, str(tmp_path), workers=3, window=200, hop=200,
        smoothing="ema",
        fleet_config=FleetConfig(max_sessions=6, max_delay_ms=0.0),
        config=ClusterConfig(
            lease_s=0.2, probe_retries=2, probe_base_ms=10.0,
            probe_cap_ms=50.0,
        ),
        clock=clock,
    )
    for i in range(n):
        cluster.add_session(i)
    victim = cluster.worker_of(0)
    survivors = [w for w in cluster.workers if w != victim]
    # fill the survivor the victim's sessions will hash to (the ring
    # without the victim), so the failover MUST take the fallback
    scratch = ConsistentHashRouter(cluster.config.replicas)
    for w in survivors:
        scratch.add_worker(w)
    victim_sids = [i for i in range(n) if cluster.worker_of(i) == victim]
    primaries = {scratch.owner(s) for s in victim_sids}
    assert len(primaries) == 1, (
        "test setup: victim sessions hash to several survivors; "
        "adjust the seed"
    )
    full_wid = primaries.pop()
    open_wid = next(w for w in survivors if w != full_wid)
    full = cluster._workers[full_wid].server
    k = 0
    while len(full.sessions) < 6:
        full.add_session(f"filler{k}")
        k += 1
    recordings, _ = synthetic_sessions(n, windows_per_session=1, seed=1)
    from har_tpu_torch.serve.chaos import _drive_cluster

    events = []
    cursors = [0] * n
    killed = {"done": False}

    def on_round(c):
        if not killed["done"]:
            c._workers[victim].kill()
            killed["done"] = True

    _drive_cluster(
        cluster, recordings, cursors, 200, 200, clock, events, on_round
    )
    # every victim session landed — and none on the full worker
    victim_sids = [
        e["sid"] for e in cluster.migration_log
    ]
    assert victim_sids  # the victim owned at least one session
    for sid in victim_sids:
        assert cluster.worker_of(sid) == open_wid
    acct = cluster.accounting()
    assert acct["balanced"] and acct["pending"] == 0
    assert acct["scored"] == n
    cluster.close()


# ------------------------------------------------- scale up / down


def test_retire_worker_and_add_worker_rebalance(tmp_path):
    n = 12
    recordings, _ = synthetic_sessions(n, windows_per_session=2, seed=3)
    clock = FakeClock()
    cluster = _mk_cluster(tmp_path, clock, n)
    for i in range(n):
        cluster.push(i, recordings[i][:200])
    cluster.flush()
    # scale down: every session of the retired worker moves, nothing
    # is dropped, the ledger carries its accounting
    victim = cluster.worker_of(0)
    n_victim = len(cluster._workers[victim].server.sessions)
    moved = cluster.retire_worker(victim)
    assert moved == n_victim
    assert victim not in cluster.workers
    assert cluster.cluster_stats()["retired"] == [victim]
    assert sorted(cluster.sessions) == list(range(n))
    with pytest.raises(ClusterError, match="unknown worker"):
        cluster.retire_worker(victim)
    # scale up with rebalance: the ring's new arcs migrate over
    new_wid = cluster.add_worker(rebalance=True)
    assert new_wid in cluster.workers
    assert all(
        cluster.worker_of(i) == cluster._router.owner(i) for i in range(n)
    )
    for i in range(n):
        cluster.push(i, recordings[i][200:])
    cluster.flush()
    acct = cluster.accounting()
    assert acct["balanced"] and acct["pending"] == 0
    assert acct["enqueued"] == 2 * n
    assert acct["scored"] == 2 * n
    cluster.close()


# ------------------------------------------- fleet-global drift trigger


def test_retrain_trigger_fires_across_workers_not_within_one(tmp_path):
    """K sessions drifting on a common channel escalate when observed
    ACROSS the cluster (``RetrainTrigger.observe_workers``) even though
    no single worker's partition reaches ``min_sessions`` on its own."""
    from har_tpu_torch.adapt.trigger import RetrainTrigger, TriggerConfig
    from har_tpu_torch.monitoring import DriftMonitor

    n = 8
    clock = FakeClock()
    cluster = FleetCluster(
        MODEL, str(tmp_path), workers=2, window=100, hop=100,
        channels=3, smoothing="none",
        fleet_config=FleetConfig(max_sessions=n, max_delay_ms=0.0),
        clock=clock,
    )
    rng = np.random.default_rng(11)
    for i in range(n):
        cluster.add_session(
            i,
            monitor=DriftMonitor(
                np.zeros(3), np.ones(3), halflife=50.0, patience=2
            ),
        )
    counts = [len(s.sessions) for s in cluster.servers]
    assert all(c > 0 for c in counts) and max(counts) < n
    for rnd in range(6):
        for i in range(n):
            chunk = rng.normal(size=(100, 3)).astype(np.float32)
            if rnd >= 2:
                chunk = chunk + 25.0  # population-wide re-mount
            cluster.push(i, chunk)
        cluster.poll(force=True)
        clock.advance(1.0)

    min_sessions = max(counts) + 1  # out of any one partition's reach
    cfg = TriggerConfig(
        min_sessions=min_sessions, window_s=1e9, cooldown_s=1e9,
        recovery_patience=1,
    )
    # per-worker triggers never fire: each partition is too small
    for server in cluster.servers:
        solo = RetrainTrigger(cfg, clock=clock)
        solo.observe_server(server)
        assert solo.poll() is None
    # the fleet-global trigger aggregates across workers and fires
    fleet_trigger = RetrainTrigger(cfg, clock=clock)
    cluster.observe_drift(fleet_trigger)
    job = fleet_trigger.poll()
    assert job is not None
    assert len(job.session_ids) == n
    cluster.close()


# ----------------------------------------------------------- CLI e2e


def test_cli_serve_workers_kill_worker(tmp_path, capsys):
    """``serve --workers 3 --kill-worker w1``: the CLI cluster drive
    survives a mid-run worker SIGKILL — failover migrates the
    partition, the summary's global accounting balances with zero
    pending, and every window is scored despite the kill."""
    assert cli.main([
        "serve", "--device", "cpu", "--workers", "3", "--sessions", "24",
        "--kill-worker", "w1", "--journal", str(tmp_path / "cluster"),
    ]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["killed_worker"] == "w1"
    assert out["failovers"] == 1
    assert out["workers"] == 2
    assert out["balanced"] is True
    assert out["pending"] == 0
    assert out["scored"] == out["enqueued"] > 0
    assert out["migrated_sessions"] > 0
    assert out["retired"] == ["w1"]


def test_cli_serve_workers_summary_equals_jax(capsys):
    """Both CLIs on ``serve --workers 3 --kill-worker w1``: the same
    summary keys and the same counts, placements and migrations."""
    from har_tpu.cli import main as jax_main

    argv = ["serve", "--workers", "3", "--sessions", "24", "--kill-worker", "w1"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_main(argv) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(ours) == set(theirs)
    for key in ("sessions", "workers", "n_events", "enqueued", "scored",
                "dropped", "pending", "balanced", "failovers",
                "migrated_sessions", "per_worker_sessions", "retired",
                "killed_worker"):
        assert ours[key] == theirs[key], key


def test_cli_serve_workers_refusals():
    """``har_tpu``'s refusals: ``--net`` needs ``--workers N``, and a
    cluster does not combine with the single-server modes."""
    base = ["serve", "--device", "cpu", "--sessions", "4"]
    with pytest.raises(SystemExit, match="pair it with --workers N"):
        cli.main(base + ["--net"])
    for flags in (["--resume"], ["--adapt"], ["--mesh", "2"],
                  ["--mesh-shape", "1x2"]):
        with pytest.raises(SystemExit, match="--workers drives the analytic demo"):
            cli.main(base + ["--workers", "2", *flags])
    for flags in (["--monitor"], ["--tier", "int8"], ["--pipeline-depth", "2"]):
        with pytest.raises(SystemExit, match="--net"):
            cli.main(base + ["--workers", "2", "--net", *flags])
    with pytest.raises(SystemExit, match="cluster workers are"):
        cli.main(base + ["--workers", "2", "--kill-worker", "w7"])


# ------------------------------------------------- the port against JAX


def _both_clusters(tmp_path, jax_model, ours_model, *, n, workers=3,
                   window=200, hop=200):
    from har_tpu.serve import FakeClock as JaxClock
    from har_tpu.serve import FleetConfig as JaxFleetConfig
    from har_tpu.serve.cluster import ClusterConfig as JaxClusterConfig
    from har_tpu.serve.cluster import FleetCluster as JaxCluster

    cfg = dict(lease_s=0.2, probe_retries=2, probe_base_ms=10.0,
               probe_cap_ms=50.0)
    fleet = dict(max_sessions=n, target_batch=8, max_delay_ms=0.0)
    out = []
    for cls, model, clock, fc, cc, name in (
        (JaxCluster, jax_model, JaxClock(), JaxFleetConfig, JaxClusterConfig, "jax"),
        (FleetCluster, ours_model, FakeClock(), FleetConfig, ClusterConfig, "ours"),
    ):
        cluster = cls(model, str(tmp_path / name), workers=workers,
                      window=window, hop=hop, smoothing="ema",
                      fleet_config=fc(**fleet), config=cc(**cfg), clock=clock)
        for i in range(n):
            cluster.add_session(i)
        out.append((cluster, clock))
    return out


def _drive_both(pair, recordings, hop, kill=None):
    from har_tpu.serve.chaos import _drive_cluster as jax_drive

    from har_tpu_torch.serve.chaos import _drive_cluster

    results = []
    for (cluster, clock), drive in zip(pair, (jax_drive, _drive_cluster)):
        events, log = [], []

        def on_round(c):
            if kill is not None and c.accounting()["scored"] > 0 and kill in c._workers:
                c._workers[kill].kill()
            log.append(c.accounting())

        drive(cluster, recordings, [0] * len(recordings),
              max(map(len, recordings)), hop, clock, events, on_round)
        stats = cluster.cluster_stats()
        cluster.close()
        results.append((events, log, stats))
    return results


_TIMING = ("failover_ms", "migration_ms")


@pytest.mark.parametrize("kill", [None, "w1"])
def test_cluster_events_equal_jax_demo(tmp_path, kill):
    """The analytic demo model on both packages' clusters, the same
    schedule, with and without ``w1`` killed once windows are scored:
    every event's decision fields, every per-round accounting snapshot
    and the control-plane stats (timings aside) are equal."""
    from har_tpu.serve.loadgen import AnalyticDemoModel as JaxDemo

    n = 24
    recordings, _ = synthetic_sessions(n, windows_per_session=3, seed=2)
    pair = _both_clusters(tmp_path, JaxDemo(), MODEL, n=n)
    (jax_events, jax_log, jax_stats), (events, log, stats) = _drive_both(
        pair, recordings, 100, kill=kill)
    assert [_decision_fields(e) for e in events] == [
        _decision_fields(e) for e in jax_events]
    assert [e.session_id for e in events] == [e.session_id for e in jax_events]
    assert log == jax_log
    for key in set(stats) | set(jax_stats):
        if key not in _TIMING:
            assert stats[key] == jax_stats[key], key
    assert stats["failovers"] == (0 if kill is None else 1)
    assert stats["accounting"]["balanced"] and stats["accounting"]["pending"] == 0


@pytest.mark.parametrize("kill", [None, "w1"])
def test_cluster_transformer_equals_jax(tmp_path, kill):
    """The CLI transformer (embed 64, 4 heads, 2 layers, T 200) in
    float32 with flax's parameters carried over by the converter: both
    packages' 3-worker clusters on the same schedule give the same
    labels, t_indices and control-plane stats, probabilities within
    1e-5."""
    from tests.test_torch_serving import random_pair

    ours_model, jax_model, _ = random_pair(
        "transformer", window=200, classes=6, seed=3,
        kwargs=dict(embed_dim=64, num_heads=4, num_layers=2),
    )
    n = 6
    recordings, _ = synthetic_sessions(n, windows_per_session=2, seed=1)
    pair = _both_clusters(tmp_path, jax_model, ours_model, n=n)
    (jax_events, _, jax_stats), (events, _, stats) = _drive_both(
        pair, recordings, 200, kill=kill)
    assert len(events) == len(jax_events) == 2 * n
    for ours, theirs in zip(events, jax_events):
        assert (ours.session_id, ours.event.t_index, ours.event.label,
                ours.event.raw_label) == (theirs.session_id, theirs.event.t_index,
                                          theirs.event.label, theirs.event.raw_label)
        np.testing.assert_allclose(ours.event.probability,
                                   theirs.event.probability, rtol=0, atol=1e-5)
    for key in ("workers", "failovers", "migrated_sessions",
                "per_worker_sessions", "accounting", "retired"):
        assert stats[key] == jax_stats[key], key


@pytest.mark.parametrize("point", CLUSTER_KILL_POINTS)
def test_cluster_kill_point_verdicts_equal_jax(point):
    """Both packages' ``run_cluster_kill_point`` on the controller kill
    points: the same verdict, migrations, delivered events and
    accounting (timings aside)."""
    from har_tpu.serve.chaos import run_cluster_kill_point as jax_run

    ours = run_cluster_kill_point(point, sessions=12, workers=3, seed=0)
    theirs = jax_run(point, sessions=12, workers=3, seed=0)
    assert ours["ok"] and theirs["ok"], (ours["why"], theirs["why"])
    assert set(ours) == set(theirs)
    for key in ours:
        if key not in _TIMING:
            assert ours[key] == theirs[key], key


def test_cluster_failover_smoke_equals_jax():
    from har_tpu.serve.cluster import cluster_failover_smoke as jax_smoke

    ours, theirs = cluster_failover_smoke(), jax_smoke()
    assert ours["ok"], ours["why"]
    assert ours["windows_lost"] == 0 and ours["failovers"] == 1
    for key in ours:
        if key not in _TIMING:
            assert ours[key] == theirs[key], key


def test_unported_parts_name_item_15(tmp_path):
    """What once waited for ROADMAP.md Queue 1 item 15 keeps its
    contract: a registered warm standby shows in ``cluster_stats`` and
    serves the failover at zero failover-path bytes, the standby run of
    the kill matrix and the replication-tail kill points pass; and the
    failover bench lane (item 16, ported) measures ``har_tpu``'s rows:
    its keys, one failover a run with the victim's sessions migrated,
    contract_ok."""
    from har_tpu_torch.serve.chaos import TAIL_KILL_POINTS, run_tail_kill_point
    from har_tpu_torch.serve.net.tail import LocalShipSource
    from har_tpu_torch.serve.replica import StandbyAgent

    clock = FakeClock()
    cluster = _mk_cluster(tmp_path / "fleet", clock, 6)
    victim = cluster.worker_of(0)
    cluster.register_standby(
        StandbyAgent(str(tmp_path / "replica"),
                     {victim: LocalShipSource(str(tmp_path / "fleet"))},
                     loader=lambda ver: AnalyticDemoModel()))
    assert cluster.cluster_stats()["standbys"] == 1
    rng = np.random.default_rng(0)
    for i in range(6):
        cluster.push(i, rng.normal(size=(200, 3)).astype(np.float32))
    cluster.poll(force=True)
    cluster._workers[victim].kill()
    for _ in range(40):
        clock.advance(0.1)
        cluster.poll(force=True)
        if cluster.failovers:
            break
    stats = cluster.cluster_stats()
    assert (stats["failovers"], stats["standby_fetches"], stats["failover_path_bytes"]) == (1, 1, 0)
    assert stats["accounting"]["balanced"]
    cluster.close()
    out = run_cluster_kill_point("mid_handoff", standby=True)
    assert out["ok"], out["why"]
    assert out["standby_fetches"] >= 1 and out["failover_path_bytes"] == 0
    for point in TAIL_KILL_POINTS:
        out = run_tail_kill_point(point)
        assert out["ok"] and out["windows_lost"] == 0, (point, out["why"])
    from har_tpu_torch.serve.cluster.smoke import failover_benchmark

    rows = failover_benchmark([24], n_runs=2)
    assert [set(r) for r in rows] == [{
        "n_sessions", "workers", "migrated_sessions", "failover_ms_median",
        "failover_ms_std", "migration_ms_median", "contract_ok"}]
    (row,) = rows
    assert (row["n_sessions"], row["workers"], row["contract_ok"]) == (24, 3, True)
    assert 0 < row["migrated_sessions"] < 24
    assert row["failover_ms_median"] > 0 and row["failover_ms_std"] >= 0


def test_dead_worker_refuses_calls(tmp_path):
    """A killed worker refuses every call with ``WorkerUnavailable``
    (the evidence the failure detector reads) and owns nothing."""
    cluster = _mk_cluster(tmp_path, FakeClock(), 3)
    wid = cluster.worker_of(0)
    worker = cluster._workers[wid]
    worker.kill()
    for call in (worker.heartbeat, lambda: worker.poll(force=True),
                 lambda: worker.watermark(0)):
        with pytest.raises(WorkerUnavailable):
            call()
    assert not worker.owns(0)
    cluster.close()


def test_backoff_past_the_cap_never_overflows():
    """A dead worker's strikes count without bound (a 1,000-session
    fleet fails a push a session a round): past the cap the schedule
    stays at the cap, where the JAX package's ``factor**attempt``
    overflows after ~1,000 attempts; every delay before that equals
    ``har_tpu``'s."""
    from har_tpu.utils.backoff import Backoff as JaxBackoff
    from har_tpu.utils.backoff import BackoffPolicy as JaxPolicy

    from har_tpu_torch.utils.backoff import Backoff, BackoffPolicy

    ours = Backoff(BackoffPolicy(base_ms=20.0, cap_ms=200.0), seed=3)
    theirs = JaxBackoff(JaxPolicy(base_ms=20.0, cap_ms=200.0), seed=3)
    assert [ours.next_ms() for _ in range(500)] == [theirs.next_ms() for _ in range(500)]
    assert all(ours.next_ms() == 200.0 for _ in range(5000))
    flat = Backoff(BackoffPolicy(base_ms=5.0, cap_ms=5.0, factor=1.0, jitter=0.0))
    assert {flat.next_ms() for _ in range(3000)} == {5.0}


def test_cli_serve_workers_default_fleet_survives_a_kill(capsys):
    """``serve --workers 3 --kill-worker w1`` at the default 1,000
    sessions: w1's ~350 sessions are pushed to and refused every round
    until the lease runs out, and the run still balances with every
    window scored once."""
    assert cli.main(["serve", "--device", "cpu", "--workers", "3",
                     "--kill-worker", "w1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["failovers"] == 1 and out["retired"] == ["w1"]
    assert out["balanced"] and out["pending"] == 0 and out["dropped"] == 0
    assert out["scored"] == out["enqueued"] == out["n_events"] == 2000
