"""Real transport for the fleet cluster: subprocess workers on
loopback TCP behind the ``FleetCluster`` control plane.

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
                ``ClusterWorker``: same surface, every call an RPC
  controller.py ``NetCluster`` — ``FleetCluster`` over NetWorkers
                (hand-offs ride the adopt RPC; failover restores the
                dead worker's journal from the shared disk) and
                ``launch_workers``
  chaos.py      the real-time delivery loop ``serve --workers N --net``
                drives

Port of ``har_tpu/serve/net`` (the JAX package's docs/multihost.md,
"Wire protocol", gives the frame layout): frames, codecs and RPCs are
byte-compatible with the JAX package's, so a cluster may mix the two
packages' workers.  Not ported yet (ROADMAP.md Queue 1 item 15): the
ingest gateway, journal shipping and its agents, the replication
tail, controller election, the wire kill and partition matrices, the
wire smoke, ``HAGatewayClient``, ``NetCluster(agents=)`` and
``launch_agents``.
"""

from har_tpu_torch.serve.net.client import NetWorker
from har_tpu_torch.serve.net.controller import (
    NetCluster,
    launch_agents,
    launch_workers,
)
from har_tpu_torch.serve.net.rpc import (
    LinkFaults,
    RpcClient,
    RpcConnectionRefused,
    RpcDeadlineExceeded,
    RpcError,
    RpcRemoteError,
    RpcServer,
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
    "FrameBuffer",
    "FrameError",
    "LinkFaults",
    "MAX_FRAME_BYTES",
    "NetCluster",
    "NetWorker",
    "RpcClient",
    "RpcConnectionRefused",
    "RpcDeadlineExceeded",
    "RpcError",
    "RpcRemoteError",
    "RpcServer",
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
    "launch_agents",
    "launch_workers",
    "model_pool",
]
