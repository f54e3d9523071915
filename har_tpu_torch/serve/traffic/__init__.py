"""Elastic traffic engine: replayable churn loadgen + load-adaptive
capacity control.

Port of ``har_tpu/serve/traffic`` (the JAX package's
docs/elasticity.md describes it), for one ``FleetServer`` on one
device or a serving mesh, or a ``FleetCluster``.  Public surface:
  TraceSpec / TrafficTrace / TraceReport / drive_trace
      — seeded diurnal/bursty/storm arrival processes driving session
        connect/disconnect churn, overnight-cohort storms, slow-client
        stalls and mixed per-session rates through the fleet engine; a
        trace is a replayable artifact (export/replay by seed+params),
        and its schedule and sample pool equal the JAX package's.
  AutoscaleConfig / CapacityController
      — the hysteresis/cooldown policy loop that resizes target_batch,
        pipeline_depth and the mesh rung online (FleetServer.resize,
        zero-drop at a dispatch boundary) and drives the cluster's
        add_worker / retire_worker from load.
  elastic_smoke — the elastic-traffic check.
  elastic_traffic_benchmark — the ``elastic_traffic`` bench lane: static
        floor, static ceiling and autoscaled runs of one swing under a
        deterministic dispatch-cost model.
  DECLARED_SHEDS / undeclared_drops — the elastic run's loss verdict.
"""

from har_tpu_torch.serve.traffic.autoscale import (
    AutoscaleConfig,
    CapacityController,
)
from har_tpu_torch.serve.traffic.generate import (
    TraceReport,
    TraceSpec,
    TrafficTrace,
    drive_trace,
)
from har_tpu_torch.serve.traffic.smoke import (
    DECLARED_SHEDS,
    elastic_smoke,
    elastic_traffic_benchmark,
    undeclared_drops,
)

__all__ = [
    "AutoscaleConfig",
    "CapacityController",
    "DECLARED_SHEDS",
    "TraceReport",
    "TraceSpec",
    "TrafficTrace",
    "drive_trace",
    "elastic_smoke",
    "elastic_traffic_benchmark",
    "undeclared_drops",
]
