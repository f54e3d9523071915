"""Fleet serving: continuous batching for thousands of concurrent
20 Hz accelerometer streams over one predict path, on one device or a
single-controller serving mesh.

Port of ``har_tpu/serve``'s single-process engine; the model runs on
its own device (``cuda`` unless the caller builds it on the CPU), or
over a ``parallel.mesh.ServingMesh`` (``FleetServer(mesh=...)``).

Public surface:
  FleetServer / FleetConfig / FleetEvent  — the engine (engine.py)
  FleetStats / HostProfile                — observability (stats.py)
  SessionArena / PendingArena             — structure-of-arrays session
                                            + pending-queue estates
                                            (arena.py)
  DispatchTicket / StagingArena / make_scorer — pipelined dispatch
                                            plane (dispatch.py; the
                                            batch-sharded and model-
                                            parallel scorers, and
                                            model_parallel.py's tensor-
                                            parallel forwards)
  DispatchFaults / DeliveryFaults / FakeClock — fault injection
  AnalyticDemoModel / JitDemoModel / synthetic_sessions / drive_fleet
                                          — load generation
  run_pipeline_cell / run_fused_grid_cells / run_pipeline_cell_subprocess
  WideTransformerDemoModel / run_model_parallel_cell /
  run_model_parallel_cell_subprocess / host_plane_benchmark
                                          — the bench cells (loadgen.py)
  FleetJournal / JournalConfig            — durability (journal.py)
  restore_server / recovery_smoke         — crash recovery (recover.py)
  recovery_benchmark / recovery_benchmark_summary
                                          — its bench lane
  KILL_POINTS / ENGINE_KILL_POINTS / run_kill_point
                                          — kill-point chaos (chaos.py;
                                            the engine points drive the
                                            adaptation loop,
                                            har_tpu_torch.adapt)
  CLUSTER_KILL_POINTS / run_cluster_kill_point — worker-axis chaos
  SHIP_KILL_POINTS                        — journal-ship transfer chaos
  TAIL_KILL_POINTS / run_tail_kill_point  — replication-tail chaos
  NET_PARTITION_CASES                     — partition-tolerance matrix
                                            (runners in serve/net/chaos)
  WarmReplica / StandbyAgent / StandbyHost — warm standbys (replica.py)
  fleet_slo_smoke / fleet_pipeline_smoke / model_parallel_smoke
                                          — the serving checks
  har_tpu_torch.serve.traffic             — elastic traffic on one
                                            server (TrafficTrace: diurnal/
                                            bursty/storm churn loadgen;
                                            CapacityController: online
                                            target_batch / depth / mesh
                                            autoscaling, worker
                                            scaling, elastic_smoke)
  har_tpu_torch.serve.cluster             — multi-worker control plane
                                            (FleetCluster: router,
                                            heartbeat failover, journal
                                            hand-off migration)
  har_tpu_torch.serve.net                 — the real transport
                                            (NetCluster over
                                            `serve-worker` subprocesses:
                                            CRC-framed TCP RPCs with
                                            deadlines/retries, NetWorker
                                            proxies, journal-ship
                                            agents, replicated
                                            controller election, the
                                            ingest gateway pair, the
                                            wire chaos + partition
                                            matrices)
"""

from har_tpu_torch.serve.arena import PendingArena, SessionArena
from har_tpu_torch.serve.chaos import (
    CLUSTER_KILL_POINTS,
    ENGINE_KILL_POINTS,
    KILL_POINTS,
    NET_PARTITION_CASES,
    SHIP_KILL_POINTS,
    TAIL_KILL_POINTS,
    KillPlan,
    SimulatedCrash,
    run_cluster_kill_point,
    run_kill_point,
    run_random_kill,
    run_tail_kill_point,
)
from har_tpu_torch.serve.dispatch import (
    DispatchTicket,
    StagingArena,
    make_scorer,
)
from har_tpu_torch.serve.engine import (
    AdmissionError,
    DispatchError,
    FleetConfig,
    FleetEvent,
    FleetServer,
)
from har_tpu_torch.serve.faults import (
    DeliveryFaults,
    DispatchFaults,
    FakeClock,
    InjectedDispatchFailure,
)
from har_tpu_torch.serve.journal import (
    FleetJournal,
    JournalConfig,
    JournalError,
)
from har_tpu_torch.serve.loadgen import (
    AnalyticDemoModel,
    HostPlaneStubModel,
    JitDemoModel,
    LoadReport,
    WideTransformerDemoModel,
    drive_fleet,
    host_plane_benchmark,
    host_plane_summary,
    run_fused_grid_cells,
    run_model_parallel_cell,
    run_model_parallel_cell_subprocess,
    run_pipeline_cell,
    run_pipeline_cell_subprocess,
    synthetic_sessions,
)
from har_tpu_torch.serve.recover import (
    RecoveryError,
    recovery_benchmark,
    recovery_benchmark_summary,
    recovery_smoke,
    restore_server,
)
from har_tpu_torch.serve.replica import StandbyAgent, StandbyHost, WarmReplica
from har_tpu_torch.serve.slo import (
    events_equal,
    fleet_pipeline_smoke,
    fleet_slo_smoke,
    model_parallel_smoke,
)
from har_tpu_torch.serve.stats import FleetStats, HostProfile, StageHistogram
from har_tpu_torch.serve.traffic import (
    AutoscaleConfig,
    CapacityController,
    TraceReport,
    TraceSpec,
    TrafficTrace,
    drive_trace,
    elastic_smoke,
    elastic_traffic_benchmark,
)

__all__ = [
    "AdmissionError",
    "AnalyticDemoModel",
    "AutoscaleConfig",
    "CLUSTER_KILL_POINTS",
    "CapacityController",
    "DeliveryFaults",
    "DispatchError",
    "DispatchFaults",
    "DispatchTicket",
    "ENGINE_KILL_POINTS",
    "FakeClock",
    "FleetConfig",
    "FleetEvent",
    "FleetJournal",
    "FleetServer",
    "FleetStats",
    "HostPlaneStubModel",
    "HostProfile",
    "InjectedDispatchFailure",
    "JitDemoModel",
    "JournalConfig",
    "JournalError",
    "KILL_POINTS",
    "KillPlan",
    "LoadReport",
    "NET_PARTITION_CASES",
    "PendingArena",
    "RecoveryError",
    "SHIP_KILL_POINTS",
    "SessionArena",
    "SimulatedCrash",
    "StageHistogram",
    "StagingArena",
    "StandbyAgent",
    "StandbyHost",
    "TAIL_KILL_POINTS",
    "TraceReport",
    "TraceSpec",
    "TrafficTrace",
    "WarmReplica",
    "WideTransformerDemoModel",
    "drive_fleet",
    "drive_trace",
    "elastic_smoke",
    "elastic_traffic_benchmark",
    "events_equal",
    "fleet_pipeline_smoke",
    "fleet_slo_smoke",
    "host_plane_benchmark",
    "host_plane_summary",
    "make_scorer",
    "model_parallel_smoke",
    "recovery_benchmark",
    "recovery_benchmark_summary",
    "recovery_smoke",
    "restore_server",
    "run_cluster_kill_point",
    "run_fused_grid_cells",
    "run_kill_point",
    "run_model_parallel_cell",
    "run_model_parallel_cell_subprocess",
    "run_pipeline_cell",
    "run_pipeline_cell_subprocess",
    "run_random_kill",
    "run_tail_kill_point",
    "synthetic_sessions",
]
