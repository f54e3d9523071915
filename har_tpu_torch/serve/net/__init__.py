"""Real transport for the fleet cluster: subprocess workers on
loopback TCP behind the ``FleetCluster`` control plane, shared-nothing
failover by journal shipping, warm standbys, controller election and
the ingest front door.

  wire.py       length-prefixed CRC-framed messages over TCP — the SAME
                framing the write-ahead journal uses on disk
                (``journal.encode_record``), plus codecs for the
                payloads that already exist as journal records
                (session exports ride the ``adopt`` record layout,
                events the ``ack`` layout)
  rpc.py        request/response over a socket: deadlines, retry via
                ``utils.backoff``, connection-refused vs
                deadline-exceeded error taxonomy, duplicate-delivery
                dedup, deterministic link-fault injection
  worker.py     ``serve-worker`` — one FleetServer + journal as an OS
                subprocess on a loopback socket, real monotonic clocks;
                its scoring stack is imported and warm before it
                announces itself
  client.py     ``NetWorker`` — the transport-backed twin of
                ``ClusterWorker``: same surface, every call an RPC;
                ``HAGatewayClient`` — the reconnecting client of an
                elected gateway pair
  controller.py ``NetCluster`` — ``FleetCluster`` over NetWorkers
                (hand-offs ride the adopt RPC; with ship agents
                registered, failover is SHARED-NOTHING: the dead
                worker's journal ships over the wire into a private
                staging dir and is digest-verified before restore),
                ``launch_workers`` and ``launch_agents``
  ingest.py     edge admission for the front door: the shed ladder that
                judges a batched push frame from its HEADER (session
                count, byte length, staleness watermark) before any
                payload decode or allocation
  gateway.py    ``serve-gateway`` — the fleet's ingest front door:
                clients speak the wire protocol to ONE gateway process
                which multiplexes batched push frames (one per delivery
                round) onto the workers, shedding at the edge with
                declared receipts
  ship.py       the journal-shipping RPC (``serve-agent``): one agent
                per worker host streams journal dirs as chunked,
                manifest-digested, resumable transfers — the failover
                hand-off currency across a real process boundary
  tail.py       the ship protocol pointed at a MOVING target: resumable
                incremental pulls of a live worker's journal into a
                standby-local mirror (``serve-agent --follow`` rides
                this; see ``har_tpu_torch.serve.replica`` for the warm
                in-memory replica kept on top of the tailed bytes)
  election.py   replicated controller: wall-clock lease file + fenced
                campaign; a replica completes ``takeover`` when the
                leader's lease expires
  chaos.py      the chaos matrix re-run over the wire + the
                partition-tolerance matrix (slow link, dropped probe,
                duplicated delivery, split brain) + the gateway pair's
                kill points, and the real-time delivery loop
                ``serve --workers N --net`` drives
  smoke.py      the wire checks: failover, journal ship, replication,
                ingest and the gateway pair, and the four wire bench
                lanes measured over the same runs

Port of ``har_tpu/serve/net`` (the JAX package's docs/multihost.md,
"Wire protocol", gives the frame layout, the election rules and the
partition-resolution argument): frames, codecs, RPCs, manifests, ship
logs and lease files are byte-compatible with the JAX package's, so a
cluster may mix the two packages' workers and agents.
"""

from har_tpu_torch.serve.net.client import HAGatewayClient, NetWorker
from har_tpu_torch.serve.net.controller import (
    AgentHandle,
    NetCluster,
    launch_agents,
    launch_workers,
)
from har_tpu_torch.serve.net.election import ControllerReplica, LeaderLease
from har_tpu_torch.serve.net.gateway import (
    GatewayClient,
    IngestGateway,
    launch_gateway,
    launch_gateway_pair,
)
from har_tpu_torch.serve.net.ingest import EdgeAdmission, IngestConfig
from har_tpu_torch.serve.net.rpc import (
    LinkFaults,
    RpcClient,
    RpcConnectionRefused,
    RpcDeadlineExceeded,
    RpcError,
    RpcRemoteError,
    RpcServer,
)
from har_tpu_torch.serve.net.ship import (
    ShipAgent,
    ShipClient,
    ShipError,
    ShipUnavailable,
    fetch_journal,
)
from har_tpu_torch.serve.net.smoke import (
    gateway_ha_benchmark,
    gateway_ha_smoke,
    journal_ship_benchmark,
    journal_ship_smoke,
    replication_smoke,
    wire_failover_benchmark,
    wire_failover_smoke,
    wire_ingest_benchmark,
    wire_ingest_smoke,
)
from har_tpu_torch.serve.net.tail import (
    LocalShipSource,
    finalize_tail,
    tail_once,
)
from har_tpu_torch.serve.net.wire import (
    MAX_FRAME_BYTES,
    FrameBuffer,
    FrameError,
    decode_chunk_batch,
    decode_drift_reports,
    decode_events,
    decode_export,
    decode_samples,
    encode_chunk_batch,
    encode_drift_reports,
    encode_events,
    encode_export,
    encode_frame,
    encode_samples,
)
from har_tpu_torch.serve.net.worker import WorkerHost, model_pool

__all__ = [
    "AgentHandle",
    "ControllerReplica",
    "EdgeAdmission",
    "FrameBuffer",
    "FrameError",
    "GatewayClient",
    "HAGatewayClient",
    "IngestConfig",
    "IngestGateway",
    "LeaderLease",
    "LinkFaults",
    "LocalShipSource",
    "MAX_FRAME_BYTES",
    "NetCluster",
    "NetWorker",
    "RpcClient",
    "RpcConnectionRefused",
    "RpcDeadlineExceeded",
    "RpcError",
    "RpcRemoteError",
    "RpcServer",
    "ShipAgent",
    "ShipClient",
    "ShipError",
    "ShipUnavailable",
    "WorkerHost",
    "decode_chunk_batch",
    "decode_drift_reports",
    "decode_events",
    "decode_export",
    "decode_samples",
    "encode_chunk_batch",
    "encode_drift_reports",
    "encode_events",
    "encode_export",
    "encode_frame",
    "encode_samples",
    "fetch_journal",
    "finalize_tail",
    "gateway_ha_benchmark",
    "gateway_ha_smoke",
    "journal_ship_benchmark",
    "journal_ship_smoke",
    "launch_agents",
    "launch_gateway",
    "launch_gateway_pair",
    "launch_workers",
    "model_pool",
    "replication_smoke",
    "tail_once",
    "wire_failover_benchmark",
    "wire_failover_smoke",
    "wire_ingest_benchmark",
    "wire_ingest_smoke",
]
