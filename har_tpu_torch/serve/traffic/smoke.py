"""The elastic-traffic check and the elastic run's loss verdict.

``elastic_smoke()`` runs the whole elastic story once, small: the
engine's capacity ladder over a seeded 10x swing (mesh rung included),
then a 2-worker cluster scaling its worker count over churn.

Port of ``har_tpu/serve/traffic/smoke.py``.  ``DECLARED_SHEDS``,
``undeclared_drops`` and ``elastic_smoke`` are copied, with phase 1 on a
``parallel.mesh.ServingMesh`` where the JAX package builds its mesh;
``elastic_traffic_benchmark`` is a bench lane (ROADMAP.md Queue 1 item
16) and raises NotImplementedError.
"""

from __future__ import annotations

import shutil
import tempfile

# shed reasons the SLO ladder / bounded queues DECLARE: a drop under
# one of these is the engine degrading as designed.  Anything else
# (dispatch_failed, session_removed) is a lost window the elastic run
# must not produce.
DECLARED_SHEDS = ("slo_shed", "backpressure", "session_queue")


def undeclared_drops(stats_snapshot: dict) -> int:
    by_reason = stats_snapshot["dropped_by_reason"]
    return sum(
        n for reason, n in by_reason.items()
        if reason not in DECLARED_SHEDS
    )


def elastic_smoke(seed: int = 0, device=None) -> dict:
    """Run the whole elastic story once, small, in two phases, and
    return the ``{swing, resizes, p99_ms, shed_rate, windows_lost}``
    verdict:

      phase 1 (engine)   a seeded 10x diurnal swing with a mid-run
                         overnight-cohort disconnect storm, slow clients
                         and mixed per-session rates, served by the demo
                         MLP on ``device`` (default ``cuda``) while a
                         CapacityController walks the target_batch ->
                         pipeline_depth -> mesh ladder up the swing and
                         back down — a MESH re-shard must land on a
                         2-entry ``ServingMesh`` (two visible cards, or
                         the one device repeated), with the
                         conservation law balanced in every per-round
                         snapshot and zero windows dropped outside the
                         SLO ladder's declared shed reasons;

      phase 2 (cluster)  the same churn against a 2-worker FleetCluster
                         (the host demo model) while the controller
                         scales the worker count: one
                         ``add_worker(rebalance=True)`` at the peak and
                         one drained ``retire_worker`` at the trough,
                         global conservation balanced in every
                         per-round snapshot.

    Everything is seeded and round-indexed (the trace is a replayable
    artifact); the clock only feeds latency histograms."""
    from har_tpu_torch.device import resolve_device
    from har_tpu_torch.parallel.mesh import (
        create_serving_mesh,
        serving_devices,
    )
    from har_tpu_torch.serve.engine import FleetConfig, FleetServer
    from har_tpu_torch.serve.loadgen import AnalyticDemoModel, JitDemoModel
    from har_tpu_torch.serve.traffic.autoscale import (
        AutoscaleConfig,
        CapacityController,
    )
    from har_tpu_torch.serve.traffic.generate import (
        TraceSpec,
        TrafficTrace,
        drive_trace,
    )

    # ---- phase 1: engine ladder over a 10x diurnal swing -----------------
    device = resolve_device("cuda" if device is None else device)
    grid = serving_devices(-1, device)[:2]
    # one card (or the CPU): the device repeated, as a dry-run mesh
    grid = (grid * 2)[:2]
    n_dev = len(grid)
    spec = TraceSpec(
        kind="storm",
        peak_sessions=32,
        swing=10.0,
        rounds=48,
        period=48,
        storms=((30, 0.5),),
        slow_prob=0.05,
        slow_rounds=2,
        rate_mix=(1, 1, 2),
        seed=seed,
    )
    trace = TrafficTrace(spec)
    server = FleetServer(
        JitDemoModel(tunnel_rtt_ms=1.0, device=device),
        window=200,
        hop=200,
        smoothing="ema",
        config=FleetConfig(
            max_sessions=4096, target_batch=8, max_delay_ms=5.0
        ),
    )
    controller = CapacityController(
        server,
        config=AutoscaleConfig(
            min_target_batch=8,
            max_target_batch=32,
            max_depth=2,
            mesh_ladder=tuple(sorted({1, n_dev})),
            queue_high=1.0,
            util_low=0.4,
            up_after=1,
            down_after=2,
            cooldown_s=0.0,
        ),
        mesh_for=lambda d: create_serving_mesh(
            dp=d, tp=1, devices=grid[:d]
        ),
    )
    balance = {"ok": True}
    devices_seen = {"max": 1}

    def on_round(target, r):
        out = controller.on_round(target, r)
        snap = target.stats.accounting()
        balance["ok"] = balance["ok"] and snap["balanced"]
        scorer = target._scorer
        if scorer is not None:
            devices_seen["max"] = max(devices_seen["max"], scorer.devices)
        return out

    events, report = drive_trace(server, trace, on_round=on_round)
    snap = server.stats_snapshot()
    acct = snap["accounting"]
    lost_engine = undeclared_drops(snap)
    shed_rate = (
        round(acct["dropped"] / acct["enqueued"], 4)
        if acct["enqueued"]
        else 0.0
    )
    mesh_ok = devices_seen["max"] > 1

    # ---- phase 2: cluster worker scaling over churn ----------------------
    from har_tpu_torch.serve.cluster.controller import FleetCluster
    from har_tpu_torch.serve.faults import FakeClock

    root = tempfile.mkdtemp(prefix="har_elastic_smoke_")
    try:
        clock = FakeClock()
        cluster = FleetCluster(
            AnalyticDemoModel(),
            root,
            workers=2,
            window=200,
            hop=200,
            smoothing="ema",
            fleet_config=FleetConfig(max_sessions=4096, target_batch=16),
            clock=clock,
        )
        cspec = TraceSpec(
            kind="diurnal",
            peak_sessions=24,
            swing=6.0,
            rounds=36,
            period=36,
            seed=seed + 1,
        )
        ccontroller = CapacityController(
            cluster=cluster,
            config=AutoscaleConfig(
                sessions_per_worker_high=9,
                sessions_per_worker_low=2,
                min_workers=2,
                max_workers=3,
                up_after=1,
                down_after=2,
                cooldown_s=0.0,
            ),
            clock=clock,
        )
        cbalance = {"ok": True}

        def c_on_round(target, r):
            out = ccontroller.on_round(target, r)
            acct = target.accounting()
            cbalance["ok"] = cbalance["ok"] and acct["balanced"]
            return out

        c_events, c_report = drive_trace(
            cluster, TrafficTrace(cspec), clock=clock, on_round=c_on_round
        )
        c_acct = cluster.accounting()
        lost_cluster = sum(
            undeclared_drops(w.server.stats.snapshot())
            for w in cluster._workers.values()
        )
        c_stats = cluster.cluster_stats()
        cluster.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    windows_lost = lost_engine + lost_cluster
    p99 = snap["stages"]["event_ms"].get("p99_ms")
    ok = bool(
        server.stats.resizes >= 2
        and server.stats.scale_ups >= 1
        # the advertised contract is up the swing AND back down — a
        # dead scale-down path (capacity stuck at the ceiling after
        # the trough returns) must go red here
        and server.stats.scale_downs >= 1
        and mesh_ok
        and report.storm_disconnects > 0
        and balance["ok"]
        and acct["balanced"]
        and acct["pending"] == 0
        and ccontroller.worker_adds >= 1
        and ccontroller.worker_retires >= 1
        and cbalance["ok"]
        and c_acct["balanced"]
        and c_acct["pending"] == 0
        and windows_lost == 0
    )
    return {
        "ok": ok,
        "swing": round(
            report.peak_active / max(report.trough_active, 1), 1
        ),
        "resizes": server.stats.resizes,
        "scale_ups": server.stats.scale_ups,
        "scale_downs": server.stats.scale_downs,
        "mesh_devices": devices_seen["max"],
        "p99_ms": p99,
        "shed_rate": shed_rate,
        "windows_lost": windows_lost,
        "storm_disconnects": report.storm_disconnects,
        "connects": report.connects,
        "disconnects": report.disconnects,
        "events": len(events),
        "worker_adds": ccontroller.worker_adds,
        "worker_retires": ccontroller.worker_retires,
        "workers": c_stats["workers"],
        "cluster_migrated": c_stats["migrated_sessions"],
        "balanced_every_round": balance["ok"] and cbalance["ok"],
    }


def elastic_traffic_benchmark(
    n_runs: int = 3, smoke: bool = False, seed: int = 0
) -> dict:
    """The JAX package's ``elastic_traffic`` bench lane."""
    raise NotImplementedError(
        "the elastic_traffic bench lane is not ported yet: ROADMAP.md "
        "Queue 1 item 16"
    )
