"""Chaos over the wire: the CLI's drive of a loopback ``NetCluster``.

Port of the part of ``har_tpu/serve/net/chaos.py`` that
``serve --workers N --net`` runs: the loopback failure-detection
config (``_net_cluster_config``), the ring owner of a session before
the cluster exists (``predicted_owner``) and the real-time delivery
loop (``_drive_net_cluster``).  The JAX package's wire kill matrix
(``run_net_kill_point``, shared-nothing with ship agents in every cell),
its partition matrix (``run_net_partition``) and its gateway kill points
(``run_gateway_kill_point``) wait for ROADMAP.md Queue 1 item 15 and
raise NotImplementedError.
"""

from __future__ import annotations

import time

from har_tpu_torch.serve.cluster.controller import ClusterConfig
from har_tpu_torch.serve.cluster.membership import (
    WorkerTimeout,
    WorkerUnavailable,
)
from har_tpu_torch.serve.cluster.router import ConsistentHashRouter

# the JAX package's partition-tolerance cells (run_net_partition)
NET_PARTITION_CASES = (
    "slow_link",
    "dropped_probe",
    "duplicate",
    "split_brain",
)

# failure detection tuned for a loopback run: a dead process refuses
# instantly, so death lands within ~lease_s of the kill
_NET_CONFIG = dict(
    lease_s=0.4, probe_retries=2, probe_base_ms=20.0, probe_cap_ms=100.0
)

_WAITS = "is not ported yet: ROADMAP.md Queue 1 item 15"


def _net_cluster_config() -> ClusterConfig:
    return ClusterConfig(**_NET_CONFIG)


def predicted_owner(session_id, workers: int, replicas: int | None = None):
    """The ring owner of a session BEFORE the cluster exists — the ring
    is deterministic in (worker ids, replicas), so the chaos victim
    (owner of session 0) is computable at worker-spawn time."""
    router = ConsistentHashRouter(
        replicas or ClusterConfig().replicas
    )
    for i in range(int(workers)):
        router.add_worker(f"w{i}")
    return router.owner(session_id)


def _drive_net_cluster(cluster, recordings, cursors, upto, hop, events,
                       on_round=None, max_rounds=20000, pace_s=0.002):
    """Real-time twin of ``chaos._drive_cluster``: hop-aligned
    round-robin delivery against a NetCluster.  A push that fails
    (refused OR timed out) keeps its cursor; a TIMED-OUT push is
    ambiguous (the worker may have executed it), so the cursor re-syncs
    from the owner's durable watermark before re-delivery — the
    documented transport contract, exercised for real here.  Completed
    migrations rewind their session's cursor to the adopted watermark;
    the loop keeps polling until no session is stranded on a dead
    worker."""
    for i in range(len(recordings)):
        try:
            cursors[i] = cluster.watermark(i)
        except WorkerUnavailable:
            pass  # mid-failover: the migration rewind below lands
    seen_migrations = len(cluster.migration_log)
    resync: set = set()
    for _ in range(max_rounds):
        active = False
        for i, rec in enumerate(recordings):
            stop = min(upto, len(rec))
            if i in resync:
                try:
                    cursors[i] = cluster.watermark(i)
                    resync.discard(i)
                except WorkerUnavailable:
                    continue  # still unreachable; keep the flag
            if cursors[i] >= stop:
                continue
            active = True
            take = hop - (cursors[i] % hop) or hop
            chunk = rec[cursors[i] : min(cursors[i] + take, stop)]
            try:
                cluster.push(i, chunk)
            except WorkerTimeout:
                # ambiguous delivery: the worker may hold these rows —
                # re-sync from its watermark before pushing more
                resync.add(i)
                continue
            except WorkerUnavailable:
                continue  # cursor kept; re-delivered post-failover
            cursors[i] += len(chunk)
        events.extend(cluster.poll(force=True))
        if on_round is not None:
            on_round(cluster)
        while seen_migrations < len(cluster.migration_log):
            sid = cluster.migration_log[seen_migrations]["sid"]
            cursors[sid] = cluster.watermark(sid)
            seen_migrations += 1
        if not active:
            # convergence is judged on the DURABLE watermark, not the
            # cursor: a worker can accept a push and die before its
            # records reach disk, and the controller only learns at
            # detection time (over a real wire there is no synchronous
            # `alive` bit).  An unreachable owner means a failover is
            # pending (keep polling — the polls feed the detector);
            # a watermark short of the schedule means the adopted copy
            # needs re-delivery from there — the documented transport
            # contract, exercised for real
            stranded = rewound = False
            for i in range(len(recordings)):
                stop = min(upto, len(recordings[i]))
                try:
                    w = cluster.watermark(i)
                except WorkerUnavailable:
                    stranded = True
                    continue
                if w < stop:
                    cursors[i] = w
                    rewound = True
            if bool(resync) or stranded or rewound:
                pass  # not settled yet
            else:
                break
        time.sleep(pace_s)  # real time IS the clock here
    else:  # pragma: no cover - harness guard
        raise RuntimeError("net cluster drive did not converge")
    events.extend(cluster.flush())
    if on_round is not None:
        on_round(cluster)


def run_net_kill_point(point: str, **kwargs) -> dict:
    """The JAX package's wire kill matrix (engine, cluster and ship
    points over subprocess workers with journal-ship agents)."""
    raise NotImplementedError(f"run_net_kill_point {_WAITS}")


def run_net_partition(case: str, **kwargs) -> dict:
    """The JAX package's partition-tolerance matrix
    (``NET_PARTITION_CASES``)."""
    raise NotImplementedError(f"run_net_partition {_WAITS}")


def run_gateway_kill_point(point: str, **kwargs) -> dict:
    """The JAX package's ingest-gateway kill points
    (``chaos.GATEWAY_KILL_POINTS``)."""
    raise NotImplementedError(f"run_gateway_kill_point {_WAITS}")
