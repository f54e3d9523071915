"""Multi-worker fleet control plane: consistent-hash routing, heartbeat
failover, journal hand-off session migration, cross-worker conservation.

Public surface:
  FleetCluster / ClusterConfig / ClusterError — the controller
  ConsistentHashRouter / stable_hash         — session partitioning
  Membership / LeaseConfig / WorkerUnavailable — failure detection
  ClusterWorker                              — one FleetServer worker
  broadcast / map_fn / reduce_sum / reduce_mean — DrJAX-style
                                               aggregation primitives
  cluster_failover_smoke                     — the failover check
  failover_benchmark                         — its bench lane

Port of ``har_tpu/serve/cluster`` (the JAX package's docs/multihost.md
describes the lease protocol, the hand-off sequence and the
cross-worker conservation law).  Failover reads a shared disk here, or
ships the journal over the wire (``har_tpu_torch.serve.net``), and
consults a warm standby first (``FleetCluster.register_standby``).
"""

from har_tpu_torch.serve.cluster.controller import (
    RETIRED_MARKER,
    ClusterConfig,
    ClusterError,
    FleetCluster,
)
from har_tpu_torch.serve.cluster.membership import (
    LeaseConfig,
    Membership,
    WorkerTimeout,
    WorkerUnavailable,
)
from har_tpu_torch.serve.cluster.primitives import (
    broadcast,
    map_fn,
    reduce_mean,
    reduce_sum,
)
from har_tpu_torch.serve.cluster.router import ConsistentHashRouter, stable_hash
from har_tpu_torch.serve.cluster.smoke import cluster_failover_smoke, failover_benchmark
from har_tpu_torch.serve.cluster.worker import ClusterWorker

__all__ = [
    "RETIRED_MARKER",
    "ClusterConfig",
    "ClusterError",
    "ClusterWorker",
    "ConsistentHashRouter",
    "FleetCluster",
    "LeaseConfig",
    "Membership",
    "WorkerTimeout",
    "WorkerUnavailable",
    "broadcast",
    "cluster_failover_smoke",
    "failover_benchmark",
    "map_fn",
    "reduce_mean",
    "reduce_sum",
    "stable_hash",
]
