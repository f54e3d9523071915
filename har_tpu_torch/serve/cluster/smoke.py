"""The cluster-failover check.

Three workers, a real load (FakeClock + DispatchFaults, a mid-run hot
swap in the schedule), one worker SIGKILLed mid-dispatch — the cluster
must detect the death through the lease protocol, fail the partition
over via journal hand-off, and end with global conservation intact,
zero double-scored events and every migrated stream bit-identical to
the un-killed run.  One ``mid_dispatch`` cell of the full worker-axis
chaos matrix (tests/test_torch_cluster.py runs all of it).

Port of ``har_tpu/serve/cluster/smoke.py``: ``cluster_failover_smoke``
is copied; ``failover_benchmark`` is a bench lane (ROADMAP.md Queue 1
item 16) and raises NotImplementedError.
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


def failover_benchmark(session_counts, n_runs: int = 3, **kwargs) -> list[dict]:
    """The JAX package's ``cluster_failover`` bench lane."""
    raise NotImplementedError(
        "the cluster_failover bench lane is not ported yet: ROADMAP.md "
        "Queue 1 item 16"
    )


if __name__ == "__main__":
    import json

    print(json.dumps(cluster_failover_smoke()))
