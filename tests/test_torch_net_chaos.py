"""Chaos over the wire on the port (har_tpu_torch.serve.net.chaos,
election and smoke).

The JAX package's wire matrices (tests/test_net.py) on the port, over
``serve-worker`` and ``serve-agent`` processes:

  - the wire kill matrix over every point of ``KILL_POINTS +
    CLUSTER_KILL_POINTS + SHIP_KILL_POINTS``: every worker's journal in
    a private host directory with a ship agent beside it, the victim
    killed for real (``os._exit`` at an engine point, SIGKILL before a
    controller or ship point), streams equal to the un-killed
    in-process run, nothing lost or scored twice; each cell's delivered
    events equal to the JAX package's in-process run on the same
    recordings, and each ship cell's verdict (timings aside) equal to
    the JAX package's run of the same cell;
  - the partition matrix (slow link, dropped probe, duplicated delivery,
    split brain) at the JAX package's RPC deadlines: no failover for a
    link fault, one owner a session after the split brain, the events
    equal to the JAX package's in-process run;
  - the lease rules, and a controller replica that completes the
    takeover after its leader dies mid-migration, its events equal to
    the JAX package's in-process run;
  - ``wire_failover_smoke``.

The processes (the JAX package's too) start at ``nice 19`` with one
thread each; the cells run a
few at a time on threads of this process, under the lock the rank
groups of ``tests/_torch_ranks.py`` take.  No assertion reads a
wall-clock time.
"""

import subprocess
import tempfile
import time
import types

import pytest
import torch

from har_tpu_torch.serve.chaos import (
    CLUSTER_KILL_POINTS,
    KILL_POINTS,
    NET_PARTITION_CASES,
    SHIP_KILL_POINTS,
    KillPlan,
    SimulatedCrash,
    _recordings,
)
from har_tpu_torch.serve.loadgen import AnalyticDemoModel
from har_tpu_torch.serve.net.chaos import (
    _drive_net_cluster,
    _net_cluster_config,
    run_net_kill_point,
    run_net_partition,
)
from har_tpu_torch.serve.net.controller import launch_workers
from har_tpu_torch.serve.net.election import ControllerReplica, LeaderLease
from har_tpu_torch.serve.net.smoke import wire_failover_smoke
from tests._torch_ranks import (
    CHILD_NICE,
    _one_at_a_time,
    cell,
    child_hygiene,
    current_cell,
    event_fields,
    jax_reference,
    run_cells,
)

torch.set_num_threads(1)

MODEL = AnalyticDemoModel()
WIRE_POINTS = KILL_POINTS + CLUSTER_KILL_POINTS + SHIP_KILL_POINTS


# the fields of a wire kill verdict that no clock decides
VERDICT_FIELDS = ("ok", "windows_lost", "failovers", "migrated_sessions")


def _niced_popen(cmd, *args, **kwargs):
    return subprocess.Popen(["nice", "-n", str(CHILD_NICE), *cmd], *args, **kwargs)


def _jax_kill_cell(point):
    """The JAX package's run of one wire kill cell."""
    from har_tpu.serve.net.chaos import run_net_kill_point as jax_run

    return jax_run(point)


@pytest.fixture(scope="module")
def wire_cells():
    """Every wire kill cell, every partition case, the smoke and the
    JAX package's ship cells, a few at a time; beside each result, the
    events the port's cell handed its verdict."""
    import har_tpu.serve.net.controller as jax_controller

    import har_tpu_torch.serve.net.chaos as net_chaos

    seen: dict = {}

    def spy(real, at):
        def wrapper(*args, **kwargs):
            seen[current_cell()] = list(args[at])
            return real(*args, **kwargs)
        return wrapper

    cells = {("kill", p): (lambda p=p: run_net_kill_point(p)) for p in WIRE_POINTS}
    cells.update({("partition", c): (lambda c=c: run_net_partition(c))
                  for c in NET_PARTITION_CASES})
    cells["smoke"] = lambda: wire_failover_smoke(sessions=12)
    cells.update({("jax", p): (lambda p=p: _jax_kill_cell(p)) for p in SHIP_KILL_POINTS})
    niced = types.SimpleNamespace(**{**vars(subprocess), "Popen": _niced_popen})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(net_chaos, "_cluster_verdict", spy(net_chaos._cluster_verdict, 2))
        mp.setattr(net_chaos, "_partition_verdict", spy(net_chaos._partition_verdict, 1))
        mp.setattr(jax_controller, "subprocess", niced)
        results = run_cells(cells, max_workers=4)
    return results, seen


@pytest.fixture(scope="module")
def jax_events():
    """The JAX package's un-killed in-process runs of the kill matrix's
    and the partition matrix's schedules (run_net_kill_point's and
    run_net_partition's defaults)."""
    return {
        "kill": event_fields(jax_reference(sessions=12, n_samples=300, workers=3, swap=True)),
        "partition": event_fields(jax_reference(sessions=9, n_samples=200, workers=3)),
    }


@pytest.mark.parametrize("point", WIRE_POINTS)
def test_wire_kill_matrix(wire_cells, jax_events, point):
    """Engine points are a real ``os._exit`` inside the victim; cluster
    points kill the controller mid-migration and a fresh one takes over;
    ship points kill the agent or the controller mid-transfer.  Zero
    double-scored, streams equal to the un-killed in-process run,
    conservation in every observable snapshot, the failover shipped
    over the wire.  The delivered events, session for session, equal
    the JAX package's in-process run of the same schedule on the same
    recordings; a ship cell's verdict equals the JAX package's run of
    the same cell (timings aside)."""
    results, seen = wire_cells
    out = cell(results, ("kill", point))
    assert out["ok"], (point, out["why"])
    assert out["windows_lost"] == 0
    assert out["failovers"] >= 1 and out["migrated_sessions"] >= 1
    assert out["transport"] == "tcp"
    assert out["shipped_bytes"] > 0
    if point in ("mid_ship_send", "mid_ship_recv"):
        assert out["ship_resumes"] >= 1
    assert event_fields(seen[("kill", point)]) == jax_events["kill"]
    if point in SHIP_KILL_POINTS:
        theirs = cell(results, ("jax", point))
        assert {k: out[k] for k in VERDICT_FIELDS} == {k: theirs[k] for k in VERDICT_FIELDS}


@pytest.mark.parametrize("case", NET_PARTITION_CASES)
def test_partition_tolerance_matrix(wire_cells, jax_events, case):
    """Each case ends with one owner a session and nothing lost; the
    link faults cause no failover (a partition is not a death).  The
    delivered events, session for session, equal the JAX package's
    in-process run on the same recordings."""
    results, seen = wire_cells
    out = cell(results, ("partition", case))
    assert out["ok"], (case, out["why"])
    if case == "split_brain":
        assert len(out["dual_owners"]) == 2
    else:
        assert out["failovers"] == 0
    assert event_fields(seen[("partition", case)]) == jax_events["partition"]


def test_slow_link_is_retried_not_failovered_rpc_evidence(wire_cells):
    """The delayed calls show up as retries under the same request id,
    not as a failover."""
    out = cell(wire_cells[0], ("partition", "slow_link"))
    assert out["ok"], out["why"]
    assert out["failovers"] == 0 and out["rpc"]["rpc_retries"] >= 1


def test_duplicated_delivery_is_deduplicated_rpc_evidence(wire_cells):
    out = cell(wire_cells[0], ("partition", "duplicate"))
    assert out["ok"], out["why"]
    acct = out["accounting"]
    assert acct["balanced"] and acct["scored"] == out["delivered"]


def test_wire_failover_smoke_verdict_green(wire_cells):
    out = cell(wire_cells[0], "smoke")
    assert out["ok"], out["why"]
    assert out["transport"] == "tcp" and out["windows_lost"] == 0
    assert out["failover_ms"] >= 0
    for key in ("workers", "transport", "failover_ms", "windows_lost"):
        assert key in out


def test_unknown_points_and_cases_are_refused():
    with pytest.raises(ValueError, match="unknown net kill point"):
        run_net_kill_point("nowhere")
    with pytest.raises(ValueError, match="unknown partition case"):
        run_net_partition("nowhere")


# ----------------------------------------------------------- election


def test_lease_campaign_renew_depose_rules():
    clock = {"t": 1000.0}
    with tempfile.TemporaryDirectory() as root:
        lease = LeaderLease(root, lease_s=10.0, wall=lambda: clock["t"])
        assert lease.holder() is None
        gen_a = lease.campaign("A")
        assert gen_a == 1 and lease.holder() == "A"
        assert lease.campaign("B") is None
        assert lease.renew("A", gen_a)
        clock["t"] += 11.0
        gen_b = lease.campaign("B")
        assert gen_b == 2 and lease.holder() == "B"
        assert not lease.renew("A", gen_a)
        assert lease.renew("B", gen_b)


def test_leader_killed_mid_migration_replica_completes_takeover(tmp_path, jax_events):
    """The leader dies inside a failover's migration (its victim worker
    SIGKILLed, the controller crashed at ``mid_migration``); a standby
    replica campaigns on the expired lease and finishes the orphaned
    failover through ``step()`` alone; the deposed leader resigns and
    the stream completes exactly once across both mandates, session for
    session equal to the JAX package's in-process run on the same
    recordings."""
    sessions, n_samples, window, hop = 9, 200, 100, 50
    with _one_at_a_time(), child_hygiene():
        workers = launch_workers(str(tmp_path), 3, window=window, hop=hop, max_delay_ms=0.0)
        procs = {w.worker_id: w.process for w in workers}
        try:
            addrs = [(w.worker_id, w.host, w.port, w.journal_dir) for w in workers]
            A, B = (ControllerReplica(name, MODEL, str(tmp_path), addrs,
                                      config=_net_cluster_config(), loader=lambda v: MODEL,
                                      lease_s=0.5)
                    for name in ("A", "B"))
            assert A.step() == "leader"
            assert B.step() == "standby"
            recs = _recordings(sessions, n_samples, 3, 0)
            for i in range(sessions):
                A.cluster.add_session(i)
            half = (n_samples // hop // 2) * hop
            _drive_net_cluster(A.cluster, recs, [0] * sessions, half, hop, A.events)
            assert A.events
            procs[A.cluster.worker_of(0)].kill()
            A.cluster.chaos = KillPlan("mid_migration", 1)
            crashed = False
            for _ in range(2000):
                try:
                    A.step()
                except SimulatedCrash:
                    crashed = True
                    break
                time.sleep(0.05)
            assert crashed, "the leader never reached mid_migration"
            for _ in range(2000):
                if B.is_leader:
                    break
                B.step()
                time.sleep(0.1)
            assert B.is_leader and B.takeovers == 1
            assert B.generation > A.generation
            for sid in range(sessions):
                holders = [wid for wid, w in B.cluster._workers.items() if w.owns(sid)]
                assert len(holders) == 1, (sid, holders)
            assert A.step() == "standby" and not A.is_leader
            _drive_net_cluster(B.cluster, recs, [0] * sessions, n_samples, hop, B.events)
            acct = B.cluster.accounting()
            assert acct["balanced"] and acct["pending"] == 0
            keys = {(e.session_id, e.event.t_index) for e in A.events + B.events}
            assert len(keys) == len(A.events) + len(B.events)
            assert len(keys) == sessions * ((n_samples - window) // hop + 1)
            assert event_fields(A.events + B.events) == jax_events["partition"]
            B.cluster.shutdown_workers()
            B.close()
            A.close()
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
