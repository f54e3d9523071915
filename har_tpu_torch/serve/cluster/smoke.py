"""The cluster-failover check.

Three workers, a real load (FakeClock + DispatchFaults, a mid-run hot
swap in the schedule), one worker SIGKILLed mid-dispatch — the cluster
must detect the death through the lease protocol, fail the partition
over via journal hand-off, and end with global conservation intact,
zero double-scored events and every migrated stream bit-identical to
the un-killed run.  One ``mid_dispatch`` cell of the full worker-axis
chaos matrix (tests/test_torch_cluster.py runs all of it).

``failover_benchmark`` is the same kill measured per fleet size, the
``cluster_failover`` bench lane.

Port of ``har_tpu/serve/cluster/smoke.py`` (copied).
"""

from __future__ import annotations

from har_tpu_torch.serve.chaos import run_cluster_kill_point


def cluster_failover_smoke(
    sessions: int = 24, workers: int = 3, seed: int = 0
) -> dict:
    """Run the ``mid_dispatch`` worker-kill cell and reshape its
    evidence into ``{workers, failovers, migrated_sessions,
    windows_lost, migration_ms}``."""
    out = run_cluster_kill_point(
        "mid_dispatch", sessions=sessions, workers=workers, seed=seed
    )
    return {
        "ok": bool(out["ok"]),
        "why": out["why"],
        "sessions": int(sessions),
        "workers": out.get("workers"),
        "failovers": out.get("failovers"),
        "migrated_sessions": out.get("migrated_sessions"),
        "windows_lost": out.get("windows_lost"),
        "migration_ms": out.get("migration_ms"),
    }


def failover_benchmark(
    session_counts,
    n_runs: int = 3,
    *,
    workers: int = 3,
    seed: int = 0,
    n_samples: int = 300,
) -> list[dict]:
    """THE failover-latency measurement behind ``har_tpu_torch.bench``'s
    ``cluster_failover`` lane: per fleet size, drive an N-worker
    cluster under FakeClock load, SIGKILL one worker once windows are
    flowing, and let the control plane do its job — the row reports
    the failover wall time (restore + drain + hand-offs,
    ``FleetCluster.failover_ms``), the receiver-side migration time,
    and ``contract_ok`` pinning the global conservation law + complete
    delivery on every measured run."""
    import shutil
    import tempfile

    import numpy as np

    from har_tpu_torch.serve.chaos import (
        _build_cluster,
        _drive_cluster,
        _recordings,
    )
    from har_tpu_torch.serve.faults import FakeClock
    from har_tpu_torch.serve.loadgen import AnalyticDemoModel

    model = AnalyticDemoModel()
    rows = []
    for n_sessions in session_counts:
        recordings = _recordings(int(n_sessions), n_samples, 3, seed)
        times, mig_ms, migrated, ok = [], [], 0, True
        for _ in range(int(n_runs)):
            root = tempfile.mkdtemp(prefix="har_cluster_bench_")
            try:
                clock = FakeClock()
                cluster = _build_cluster(
                    root, clock, sessions=int(n_sessions),
                    workers=workers, window=100, hop=50, model=model,
                    flush_every=512, snapshot_every=0,
                    loader=lambda ver: model,
                )
                for i in range(int(n_sessions)):
                    cluster.add_session(i)
                victim = cluster.worker_of(0)
                killed = {"done": False}

                def on_round(c):
                    if (
                        not killed["done"]
                        and c.accounting()["scored"] > 0
                    ):
                        c._workers[victim].kill()
                        killed["done"] = True

                events: list = []
                _drive_cluster(
                    cluster, recordings, [0] * int(n_sessions),
                    n_samples, 50, clock, events, on_round,
                )
                stats = cluster.cluster_stats()
                acct = stats["accounting"]
                times.append(stats["failover_ms"])
                mig_ms.append(stats["migration_ms"])
                migrated = stats["migrated_sessions"]
                keys = {(e.session_id, e.event.t_index) for e in events}
                ok = ok and (
                    acct["balanced"]
                    and acct["pending"] == 0
                    and stats["failovers"] == 1
                    and len(keys) == len(events)  # zero double-scored
                )
                cluster.close()
            finally:
                shutil.rmtree(root, ignore_errors=True)
        rows.append(
            {
                "n_sessions": int(n_sessions),
                "workers": int(workers),
                "migrated_sessions": int(migrated),
                "failover_ms_median": round(float(np.median(times)), 3),
                "failover_ms_std": round(float(np.std(times)), 3),
                "migration_ms_median": round(
                    float(np.median(mig_ms)), 3
                ),
                "contract_ok": ok,
            }
        )
    return rows


if __name__ == "__main__":
    import json

    print(json.dumps(cluster_failover_smoke()))
