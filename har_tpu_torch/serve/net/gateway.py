"""``serve-gateway`` — the fleet's wire-rate ingest front door.

Clients do not talk to workers.  They talk to a GATEWAY speaking the
same journal-frame wire protocol the workers do, and the gateway
multiplexes them onto the fleet:

  - a client buffers its per-session ``push`` calls and ships each
    delivery round as ONE batched push frame (``wire.encode_chunk_batch``
    — one frame carrying every session's chunk for the round, in
    delivery order), collapsing a round's N push RPCs into one;

  - admission control and the shed ladder run AT THE EDGE, before the
    frame's payload is even assembled: the RpcServer's admission hook
    judges each push frame from its header alone (session count,
    declared byte length, staleness watermark, tenant identity —
    ``ingest.EdgeAdmission``) and a refused frame is answered
    ``{"shed": reason}`` without a payload decode, a numpy array, or a
    worker RPC.  Refusals are DECLARED — the client counts them against
    its own cursors, so the conservation law extends to the edge: every
    sample a client sends is refused-with-a-receipt or lands in fleet
    accounting;

  - admitted frames decode to zero-copy views over the received
    payload (``wire.decode_chunk_batch``) and route through
    ``FleetCluster.push_many`` — grouped per owning worker, one batched
    RPC per worker, landing in each engine's reserved ``StagingArena``
    slots in delivery order.

HIGH AVAILABILITY is a pair of gateways behind the controller
replicas' lease election (``election.LeaderLease`` on a shared
``ha_root``).  The gateway owns no durable state — no placement, no
membership, no journal — so failover is JUST THE LEASE MOVING:

  - the leader's id IS its dialable ``host:port``, so the lease file
    doubles as the leader directory: a standby answers every data-plane
    frame with a declared ``{"moved": leader_addr}`` receipt (header-
    only, payload skipped — never a silent hangup), and the client
    redials the address in the receipt;
  - every leader response is stamped with the fenced lease generation
    (``gen``); a deposed leader's late ack carries a smaller generation
    than the client has already seen and is REJECTED client-side, then
    re-delivered to the real leader — where dedup-by-watermark makes
    the re-send idempotent instead of double-counted;
  - the winner rebuilds its fleet attachment from actual worker
    ownership (``NetCluster.takeover`` — derived, never trusted across
    generations) and seeds its per-session delivery offsets lazily from
    the workers' ``watermark(sid)``: re-sent chunk rows below the
    watermark are trimmed at the edge (``dd`` in the push receipt), so
    a client's post-reconnect replay lands exactly once and the scored
    event stream stays bit-identical to an unbroken run;
  - a graceful drain (``shutdown {"drain": true}``) finishes in-flight
    frames, answers ``{"moved": ...}`` for new ones, and RELEASES the
    lease early (``LeaderLease.release``) — a planned restart flips the
    pair as fast as a crash failover, minus the detection wait.

Engine-free at import: the heavy imports (engine, cluster controller,
election's controller config) happen inside ``main``/handlers, so the
admission path stays cheap to import and the module is testable
without a model behind it.

Port of ``har_tpu/serve/net/gateway.py`` (copied): frames, receipts and
lease files are the JAX package's byte for byte.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

from har_tpu_torch.serve.net import wire
from har_tpu_torch.serve.net.ingest import EdgeAdmission, IngestConfig
from har_tpu_torch.serve.net.rpc import RpcClient, RpcError, RpcServer


class IngestGateway:
    """One RpcServer fronting a cluster (in-process ``FleetCluster`` or
    a ``NetCluster`` of worker processes — the gateway is transport-
    blind, same seam as the controller itself).

    The admission hook only judges ``push_many`` frames; the control
    surface (add_session, poll, accounting, ...) is never shed — a
    client that cannot deliver data can still drain events and settle.

    Two attachment modes:

      - ``cluster`` (an object): single-gateway mode —
        always leading, no lease;
      - ``cluster_factory`` (+ ``ha_root``): HA-pair mode — the cluster
        attachment is built ON WINNING THE LEASE (the factory runs
        ``NetCluster.takeover``, deriving placement from actual worker
        ownership) and dropped on resigning, so a deposed gateway holds
        no stale attachment and the winner trusts nothing across
        generations.
    """

    def __init__(
        self,
        cluster=None,
        *,
        cluster_factory=None,
        config: IngestConfig | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
        ha_root: str | None = None,
        lease_s: float = 1.0,
        drain_grace_s: float = 0.25,
        wall=None,
        chaos=None,
        stats=None,
    ):
        if cluster is None and cluster_factory is None:
            raise ValueError("need a cluster or a cluster_factory")
        self.cluster = cluster
        self._cluster_factory = cluster_factory
        self.admission = EdgeAdmission(config, stats=stats)
        self.rounds = 0
        self.deduped_samples = 0
        self.lease_wins = 0
        self.lease_s = float(lease_s)
        self.drain_grace_s = float(drain_grace_s)
        self.chaos = chaos
        self._shutdown = False
        self._draining = False
        self._drain_deadline = 0.0
        # per-session delivery offsets (dedup-by-watermark): the end of
        # the last admitted chunk per sid, lazily seeded from the
        # workers' watermark(sid) — cleared on every lease win so a new
        # leader re-derives instead of trusting its own stale view
        self._session_off: dict = {}
        # sid -> tenant id (from add_session), so retired events drain
        # the RIGHT tenant's backlog slice
        self._session_tenant: dict = {}
        self.rpc = RpcServer(
            self._handlers(),
            host=host,
            port=port,
            admission=self._admit,
        )
        # the leader id IS the dialable address — the lease file is
        # thereby also the leader DIRECTORY the moved receipts quote
        self.gateway_id = f"{self.rpc.host}:{self.rpc.port}"
        self.lease = None
        if ha_root is not None:
            from har_tpu_torch.serve.net.election import LeaderLease

            self.lease = LeaderLease(ha_root, lease_s=lease_s, wall=wall)
        self._leading = self.lease is None
        self.generation = 0

    # ----------------------------------------------------------- chaos

    def _chaos(self, point: str) -> None:
        if self.chaos is not None:
            self.chaos(point)

    # ----------------------------------------------------------- lease

    def _leader_addr(self) -> str | None:
        if self.lease is None:
            return None
        return self.lease.holder()

    def step_lease(self) -> str:
        """One lease duty cycle (paced by ``serve_forever``): leader
        renews (resigning on refusal — a larger generation exists and
        fencing forbids serving under a stale mandate), standby
        campaigns, and a winner rebuilds its fleet attachment before it
        serves.  Returns the role after the step."""
        if self.lease is None:
            return "leader"
        if self._leading:
            if not self.lease.renew(self.gateway_id, self.generation):
                self._resign()
                return "standby"
            if self.cluster is None and self._cluster_factory is not None:
                return self._try_attach()
            return "leader"
        gen = self.lease.campaign(self.gateway_id)
        if gen is None:
            return "standby"
        self.generation = gen
        self.lease_wins += 1
        self._leading = True
        self._session_off.clear()
        if self._cluster_factory is not None:
            if self.cluster is not None:
                self._detach_cluster()
            return self._try_attach()
        return "leader"

    def _try_attach(self) -> str:
        """Build the fleet attachment under the held lease; a transient
        failure (slow worker, I/O) keeps the lease and retries next
        step — same mandate-retry stance as ``ControllerReplica``."""
        try:
            self.cluster = self._cluster_factory()
        except Exception:
            return "campaigning"
        return "leader"

    def _resign(self) -> None:
        self._leading = False
        if self._cluster_factory is not None and self.cluster is not None:
            self._detach_cluster()

    def _detach_cluster(self) -> None:
        # fence only this gateway's worker CLIENTS — the worker
        # processes (and their journals) belong to the fleet
        try:
            for w in self.cluster._workers.values():
                w.close()
        except Exception:
            pass
        self.cluster = None

    def _begin_drain(self) -> None:
        """Graceful hand-off: in-flight (already admitted) frames
        finish, new pushes get ``{"moved": ...}``, and the lease is
        released EARLY so the peer's campaign wins immediately — a
        planned restart indistinguishable from a fast failover."""
        if self._draining:
            return
        self._draining = True
        self._drain_deadline = time.monotonic() + self.drain_grace_s
        self._chaos("mid_lease_handoff")
        if self.lease is not None and self._leading:
            self.lease.release(self.gateway_id, self.generation)

    # ------------------------------------------------------- admission

    def _admit(self, meta: dict, payload_len: int):
        # only data-plane push frames face the ladder: shedding a poll
        # would wedge the very drain that lowers the backlog
        if meta.get("m") != "push_many":
            return None
        self._chaos("mid_frame_recv")
        if not self._leading or self._draining or self.cluster is None:
            # the standby's declared refusal: never a silent hangup —
            # the receipt carries the leader's address for the redial
            return {"moved": self._leader_addr()}
        return self.admission.admit(meta, payload_len)

    # ------------------------------------------------------- handlers

    def _retire(self, events) -> None:
        """Drain the backlog estimate, attributed to each event's
        session tenant (events from sessions added without a tenant id
        land on the default slice)."""
        adm = self.admission
        if not self._session_tenant:
            adm.note_retired(len(events))
            return
        counts: dict = {}
        for fe in events:
            t = self._session_tenant.get(fe.session_id)
            counts[t] = counts.get(t, 0) + 1
        for t, n in counts.items():
            adm.note_retired(n, t)

    def _guarded(self, fn):
        """Data/control-plane handler wrapper: a non-leader answers the
        declared ``{"moved": leader_addr}`` receipt, a leader stamps its
        fenced lease generation on every response — the gen a client
        uses to reject a deposed leader's late acks."""

        def wrapped(meta, payload):
            if not self._leading or self.cluster is None:
                return {"moved": self._leader_addr()}, b""
            m, p = fn(meta, payload)
            if self.lease is not None:
                m["gen"] = int(self.generation)
            return m, p

        return wrapped

    def _handlers(self) -> dict:
        adm = self.admission

        def ok(meta=None, payload=b""):
            return dict(meta or {}), payload

        def heartbeat(meta, payload):
            return ok()

        def geometry(meta, payload):
            # the one datum a front-door client needs to chunk its
            # stream: the fleet's hop (frames are sliced client-side)
            return ok({"hop": int(self.cluster.hop)})

        def add_session(meta, payload):
            from har_tpu_torch.serve.journal import monitor_from_state

            self.cluster.add_session(
                meta["sid"],
                monitor=monitor_from_state(meta.get("mon")),
            )
            if meta.get("tn") is not None:
                self._session_tenant[meta["sid"]] = str(meta["tn"])
            return ok()

        def push_many(meta, payload):
            # the admission hook already said yes (header-only); the
            # decode below yields zero-copy views over the payload and
            # the cluster routes them per owning worker in delivery
            # order.  Chunks stamped with a stream offset (``o``) are
            # deduplicated against the session's delivery watermark:
            # rows below it were already delivered (a post-reconnect
            # replay) and are trimmed, idempotently, with a ``dd``
            # receipt — never double-staged.
            tenant = adm.resolve_tenant(meta)
            items = wire.decode_chunk_batch(meta, payload)
            entries = meta.get("chunks") or []
            sids, chunks, deduped = [], [], 0
            for em, (sid, arr) in zip(entries, items):
                # re-learn sid -> tenant from the frame itself: a fresh
                # leader never saw the client's add_session, and retire
                # attribution must follow the session to the new slice
                if tenant is not None:
                    self._session_tenant[sid] = tenant
                off = em.get("o")
                if off is not None:
                    base = self._session_off.get(sid)
                    if base is None:
                        # lazy watermark seed: what the WORKERS durably
                        # saw — the only delivery truth that survives a
                        # gateway failover
                        base = int(self.cluster.watermark(sid))
                    off_i = int(off)
                    n_orig = int(arr.shape[0])
                    skip = base - off_i
                    if skip > 0:
                        k = min(skip, n_orig)
                        deduped += k
                        arr = arr[k:]
                    self._session_off[sid] = max(base, off_i + n_orig)
                if int(arr.shape[0]):
                    sids.append(sid)
                    chunks.append(arr)
            self._chaos("post_accept_pre_forward")
            n = self.cluster.push_many(sids, chunks) if sids else 0
            adm.note_enqueued(n, tenant)
            self.rounds += 1
            self.deduped_samples += deduped
            return ok({"r": int(n), "dd": int(deduped)})

        def poll(meta, payload):
            events = self.cluster.poll(force=bool(meta.get("force")))
            self._retire(events)
            return wire.encode_events(events)

        def disconnect(meta, payload):
            events = self.cluster.disconnect_sessions(meta["sids"])
            self._retire(events)
            for sid in meta["sids"]:
                # a later re-add restarts the session's stream at 0 —
                # a stale offset base would wrongly trim its first rows
                self._session_off.pop(sid, None)
            return wire.encode_events(events)

        def flush(meta, payload):
            events = self.cluster.flush()
            self._retire(events)
            return wire.encode_events(events)

        def watermark(meta, payload):
            return ok({"r": int(self.cluster.watermark(meta["sid"]))})

        def accounting(meta, payload):
            acct = self.cluster.accounting()
            # engine-side declared sheds retire windows the gateway
            # never sees come back as events — pin the ladder's backlog
            # estimate to the fleet's true pending count
            adm.resync_backlog(acct.get("pending", 0))
            return ok({"r": acct})

        def gateway_stats(meta, payload):
            return ok(
                {
                    "r": {
                        **adm.snapshot(),
                        "rounds": self.rounds,
                        "deduped_samples": self.deduped_samples,
                        "lease_wins": self.lease_wins,
                        "gen": int(self.generation),
                    }
                }
            )

        def whois(meta, payload):
            # unguarded on purpose: the one question a standby must
            # answer in its own voice
            role = (
                "draining"
                if self._draining
                else "leader"
                if self._leading
                else "standby"
            )
            return ok(
                {
                    "role": role,
                    "leader": self._leader_addr(),
                    "gen": int(self.generation),
                }
            )

        def shutdown(meta, payload):
            if meta.get("drain"):
                self._begin_drain()
            else:
                self._shutdown = True
            return ok()

        return {
            "heartbeat": heartbeat,
            "geometry": self._guarded(geometry),
            "add_session": self._guarded(add_session),
            "push_many": self._guarded(push_many),
            "poll": self._guarded(poll),
            "disconnect": self._guarded(disconnect),
            "flush": self._guarded(flush),
            "watermark": self._guarded(watermark),
            "accounting": self._guarded(accounting),
            "gateway_stats": gateway_stats,
            "whois": whois,
            "shutdown": shutdown,
        }

    # ----------------------------------------------------------- loop

    def serve_forever(self, *, max_idle_s: float = 0.0) -> int:
        next_lease = 0.0
        try:
            while not self._shutdown:
                self.rpc.step(0.05)
                now = time.monotonic()
                if (
                    self.lease is not None
                    and not self._draining
                    and now >= next_lease
                ):
                    self.step_lease()
                    # renew/campaign well inside the lease term
                    next_lease = now + self.lease_s * 0.3
                if self._draining and now >= self._drain_deadline:
                    return 0
                if max_idle_s:
                    # orphan protection; the standby receives no client
                    # traffic BY DESIGN, so its window is 4x the
                    # leader's — long enough to outlive a slow leader,
                    # short enough not to outlive a dead suite
                    window = (
                        max_idle_s
                        if (self.lease is None or self._leading)
                        else 4.0 * max_idle_s
                    )
                    if now - self.rpc.last_activity > window:
                        return 2
            return 0
        finally:
            self.close()

    def close(self) -> None:
        # the cluster (and its worker processes) belong to whoever
        # built them; a factory-built attachment is this gateway's own
        # and its worker SOCKETS close with it
        if self._cluster_factory is not None and self.cluster is not None:
            self._detach_cluster()
        self.rpc.close()


class GatewayClient:
    """The front-door client — ``drive_trace``-compatible, so every
    traffic harness that drives an engine or a cluster in-process
    drives the gateway over real sockets unchanged.

    ``push`` BUFFERS (returns 0); the round's buffered chunks leave as
    one batched push frame at the next ``poll``/``flush``/``disconnect``
    — the same before-the-poll delivery point the in-process loop has,
    so per-session arrival order (and therefore every scored event) is
    bit-identical to an in-process run.  The frame's header carries the
    client's sample watermark and tenant id; each chunk carries its
    session-stream OFFSET (the delivery-coordinate position of its
    first row) so the gateway can trim already-delivered rows after a
    reconnect replay.  Offsets count DELIVERED samples only: a
    ``{"shed": reason}`` answer rolls the batch's offsets back (shed
    samples never occupied delivery positions), keeping client offsets
    and worker watermarks in the same coordinate system.  Sheds are
    counted against the client's own cursors (``edge_sheds`` /
    ``shed_samples`` / ``shed_by_reason``) — the declared-refusal
    receipt the conservation law at the edge is pinned on.
    """

    def __init__(
        self,
        host: str,
        port: int,
        *,
        deadline_s: float = 10.0,
        retries: int = 2,
        tenant: str | None = None,
    ):
        self.tenant = tenant
        self._deadline_s = float(deadline_s)
        self._retries = int(retries)
        self._client = None
        self._dial(host, port)
        self._pending: list = []  # [(sid, float32 chunk, offset)]
        self._off: dict = {}  # sid -> delivered-sample offset
        self._wm = 0  # samples pushed so far: the frame watermark
        self.windows_enqueued = 0
        self.frames_sent = 0
        self.edge_sheds = 0
        self.shed_sessions = 0
        self.shed_samples = 0
        self.shed_by_reason: dict[str, int] = {}
        self.deduped_samples = 0
        resp, _ = self._call("geometry")
        self.hop = int(resp["hop"])

    # ------------------------------------------------------- transport

    def _dial(self, host: str, port: int) -> None:
        if self._client is not None:
            self._client.close()
        self._client = RpcClient(
            host, port, deadline_s=self._deadline_s, retries=self._retries
        )

    def _call(self, method: str, meta: dict | None = None,
              payload: bytes = b""):
        """One RPC through the pooled connection — the HA subclass
        overrides this seam with redial-and-resume."""
        return self._client.call(method, meta, payload)

    # -------------------------------------------------- the data plane

    def add_session(self, session_id, *, monitor=None) -> None:
        from har_tpu_torch.serve.journal import monitor_state

        meta = {"sid": session_id, "mon": monitor_state(monitor)}
        if self.tenant is not None:
            meta["tn"] = self.tenant
        self._call("add_session", meta)

    def push(self, session_id, samples) -> int:
        """Buffer one session's chunk for this round's batched frame.
        Returns 0 — enqueue receipts arrive with the frame's response
        (``windows_enqueued``); a drive-loop that sums push returns
        reads the true count from gateway accounting instead."""
        arr = np.ascontiguousarray(samples, np.float32)
        off = self._off.get(session_id, 0)
        self._pending.append((session_id, arr, off))
        self._off[session_id] = off + int(arr.shape[0])
        self._wm += int(arr.shape[0])
        return 0

    def _flush_pending(self) -> None:
        if not self._pending:
            return
        batch, self._pending = self._pending, []
        meta, payload = wire.encode_chunk_batch(
            [(sid, arr) for sid, arr, _ in batch],
            offsets=[off for _, _, off in batch],
        )
        meta["wm"] = self._wm
        if self.tenant is not None:
            meta["tn"] = self.tenant
        resp, _ = self._call("push_many", meta, payload)
        self.frames_sent += 1
        if "shed" in resp:
            reason = resp["shed"]
            self.edge_sheds += 1
            self.shed_sessions += len(batch)
            self.shed_samples += sum(
                int(a.shape[0]) for _, a, _ in batch
            )
            self.shed_by_reason[reason] = (
                self.shed_by_reason.get(reason, 0) + 1
            )
            # shed samples never occupied delivery positions: roll the
            # offsets back so the stream's NEXT samples take them —
            # client offsets stay aligned with worker watermarks
            for sid, _, off in batch:
                if off < self._off.get(sid, 0):
                    self._off[sid] = off
        else:
            self.windows_enqueued += int(resp["r"])
            self.deduped_samples += int(resp.get("dd", 0))

    def poll(self, *, force: bool = False) -> list:
        self._flush_pending()
        resp, payload = self._call("poll", {"force": bool(force)})
        return wire.decode_events(resp, payload)

    def disconnect_sessions(self, session_ids) -> list:
        self._flush_pending()
        resp, payload = self._call(
            "disconnect", {"sids": list(session_ids)}
        )
        return wire.decode_events(resp, payload)

    def flush(self) -> list:
        self._flush_pending()
        resp, payload = self._call("flush")
        return wire.decode_events(resp, payload)

    def watermark(self, session_id) -> int:
        resp, _ = self._call("watermark", {"sid": session_id})
        return int(resp["r"])

    # ----------------------------------------------------- observation

    def accounting(self) -> dict:
        resp, _ = self._call("accounting")
        return resp["r"]

    def gateway_stats(self) -> dict:
        resp, _ = self._call("gateway_stats")
        return resp["r"]

    def whois(self) -> dict:
        resp, _ = self._call("whois")
        return resp

    # ------------------------------------------------------- lifecycle

    def shutdown(self, *, drain: bool = False) -> None:
        try:
            self._call("shutdown", {"drain": bool(drain)})
        except Exception:
            pass

    def close(self) -> None:
        self._client.close()


# --------------------------------------------------------- entrypoint


def build_parser() -> argparse.ArgumentParser:
    dflt = IngestConfig()
    ap = argparse.ArgumentParser(
        prog="serve-gateway",
        description=(
            "the fleet's ingest front door (har_tpu_torch.serve.net.gateway) "
            "— one process speaking the journal-frame wire protocol to "
            "clients, multiplexing batched push frames onto already-"
            "running `serve-worker` processes with header-only edge "
            "admission; prints one JSON ready line {host, port, pid}. "
            "Give two processes the same --ha-root and they form an "
            "elected HA pair: the standby answers {'moved': leader} "
            "and takes the lease over when the leader dies or drains"
        ),
    )
    ap.add_argument("--root", required=True,
                    help="cluster root directory (failover staging)")
    ap.add_argument("--workers-json", required=True,
                    help="JSON list of running workers: "
                         '[{"id", "host", "port", "journal"}, ...]')
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral; the ready line reports it")
    ap.add_argument("--model", default="demo")
    ap.add_argument("--deadline-s", type=float, default=2.0,
                    help="per-RPC deadline toward the workers")
    ap.add_argument("--soft-backlog", type=int, default=dflt.soft_backlog)
    ap.add_argument("--hard-backlog", type=int, default=dflt.hard_backlog)
    ap.add_argument("--max-frame-sessions", type=int,
                    default=dflt.max_frame_sessions)
    ap.add_argument("--max-frame-bytes", type=int,
                    default=dflt.max_frame_bytes)
    ap.add_argument("--max-watermark-lag", type=int,
                    default=dflt.max_watermark_lag)
    ap.add_argument("--tenants", default=None,
                    help='JSON tenant table {"tenant": weight, ...}; '
                         "set = identity enforced at the edge (unknown "
                         "tenant is a protocol violation) and the shed "
                         "ladder runs per tenant on weighted shares")
    ap.add_argument("--ha-root", default=None,
                    help="shared lease directory for an elected gateway "
                         "pair; absent = single-gateway mode")
    ap.add_argument("--lease-s", type=float, default=1.0)
    ap.add_argument("--drain-grace-s", type=float, default=0.25)
    ap.add_argument("--max-idle-s", type=float, default=120.0,
                    help="exit when no RPC arrives for this long "
                         "(orphan protection); 0 disables")
    ap.add_argument("--chaos-point", default=None,
                    help="TESTING: os._exit(137) at the Nth hit of this "
                         "gateway stage boundary — a REAL process kill "
                         "at a chosen kill point")
    ap.add_argument("--chaos-at", type=int, default=1)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from har_tpu_torch.serve.net.client import NetWorker
    from har_tpu_torch.serve.net.controller import NetCluster
    from har_tpu_torch.serve.net.worker import _HardKillPlan, model_pool

    models = model_pool(args.model)
    specs = json.loads(args.workers_json)

    def make_workers():
        return [
            NetWorker(
                spec["id"],
                spec["host"],
                int(spec["port"]),
                spec["journal"],
                deadline_s=args.deadline_s,
            )
            for spec in specs
        ]

    tenants = ()
    if args.tenants:
        tenants = tuple(sorted(json.loads(args.tenants).items()))
    config = IngestConfig(
        soft_backlog=args.soft_backlog,
        hard_backlog=args.hard_backlog,
        max_frame_sessions=args.max_frame_sessions,
        max_frame_bytes=args.max_frame_bytes,
        max_watermark_lag=args.max_watermark_lag,
        tenants=tenants,
    )
    chaos = None
    if args.chaos_point:
        chaos = _HardKillPlan(args.chaos_point, args.chaos_at)
    net_workers: list = []
    if args.ha_root:
        # HA pair: the attachment is built on WINNING the lease —
        # NetCluster.takeover derives placement from actual worker
        # ownership, so a mid-run winner adopts the live sessions the
        # old leader was fronting
        def factory():
            ws = make_workers()
            return NetCluster.takeover(
                models["A"],
                args.root,
                ws,
                loader=lambda ver: models.get(ver, models["A"]),
            )

        gw = IngestGateway(
            cluster_factory=factory,
            config=config,
            host=args.host,
            port=args.port,
            ha_root=args.ha_root,
            lease_s=args.lease_s,
            drain_grace_s=args.drain_grace_s,
            chaos=chaos,
        )
    else:
        net_workers = make_workers()
        # the fleet's geometry is the workers' geometry — ask one
        # instead of trusting a default: the client slices its stream
        # by the hop the gateway advertises, and a mismatch would
        # silently starve (or flood) every window assembler behind the
        # front door
        geo = net_workers[0].geometry()
        cluster = NetCluster(
            models["A"],
            args.root,
            window=int(geo["window"]),
            hop=int(geo["hop"]),
            channels=int(geo["channels"]),
            smoothing=geo["smoothing"],
            loader=lambda ver: models.get(ver, models["A"]),
            _workers=net_workers,
        )
        gw = IngestGateway(
            cluster,
            config=config,
            host=args.host,
            port=args.port,
            chaos=chaos,
        )
    print(
        json.dumps(
            {"host": gw.rpc.host, "port": gw.rpc.port, "pid": os.getpid()}
        ),
        flush=True,
    )
    try:
        return gw.serve_forever(max_idle_s=args.max_idle_s)
    finally:
        for w in net_workers:
            w.close()


def launch_gateway(
    root: str,
    workers,
    *,
    model: str = "demo",
    host: str = "127.0.0.1",
    deadline_s: float = 2.0,
    config: IngestConfig | None = None,
    max_idle_s: float = 120.0,
    ready_timeout_s: float = 30.0,
    ha_root: str | None = None,
    lease_s: float = 1.0,
    drain_grace_s: float = 0.25,
    chaos_point: str | None = None,
    chaos_at: int = 1,
    log_name: str = "gateway.stderr.log",
):
    """Spawn one ``serve-gateway`` subprocess fronting already-
    running workers (``NetWorker`` proxies from ``launch_workers``) and
    return ``(proc, host, port)`` once its ready line lands.  Stderr is
    captured to ``<root>/<log_name>`` for post-mortems."""
    from har_tpu_torch.serve.net.controller import (
        _child_env,
        _nice,
        _read_ready_line,
    )

    cfg = config or IngestConfig()
    specs = [
        {
            "id": w.worker_id,
            "host": w.host,
            "port": w.port,
            "journal": w.journal_dir,
        }
        for w in workers
    ]
    os.makedirs(root, exist_ok=True)
    cmd = _nice() + [
        sys.executable, "-m", "har_tpu_torch.cli", "serve-gateway",
        "--root", root,
        "--workers-json", json.dumps(specs),
        "--host", host,
        "--model", model,
        "--deadline-s", str(deadline_s),
        "--soft-backlog", str(cfg.soft_backlog),
        "--hard-backlog", str(cfg.hard_backlog),
        "--max-frame-sessions", str(cfg.max_frame_sessions),
        "--max-frame-bytes", str(cfg.max_frame_bytes),
        "--max-watermark-lag", str(cfg.max_watermark_lag),
        "--max-idle-s", str(max_idle_s),
    ]
    if cfg.tenants:
        cmd += ["--tenants", json.dumps(dict(cfg.tenants))]
    if ha_root:
        cmd += [
            "--ha-root", ha_root,
            "--lease-s", str(lease_s),
            "--drain-grace-s", str(drain_grace_s),
        ]
    if chaos_point:
        cmd += ["--chaos-point", chaos_point, "--chaos-at", str(chaos_at)]
    err = open(os.path.join(root, log_name), "wb")
    try:
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=err, text=True,
            env=_child_env(),
        )
    finally:
        err.close()
    try:
        ready = _read_ready_line(
            proc, "gateway", root, ready_timeout_s,
            log_name=log_name,
        )
    except BaseException:
        try:
            proc.kill()
        except OSError:
            pass
        raise
    return proc, ready["host"], ready["port"]


def launch_gateway_pair(
    root: str,
    workers,
    *,
    model: str = "demo",
    host: str = "127.0.0.1",
    deadline_s: float = 2.0,
    config: IngestConfig | None = None,
    lease_s: float = 0.4,
    drain_grace_s: float = 0.25,
    max_idle_s: float = 120.0,
    ready_timeout_s: float = 30.0,
    leader_timeout_s: float = 10.0,
    chaos_point: str | None = None,
    chaos_at: int = 1,
):
    """Spawn an elected gateway PAIR over one shared lease directory
    and return ``[(proc, host, port), (proc, host, port)]`` with the
    FIRST entry holding the lease: gateway A launches alone, the
    launcher waits (via ``whois``) until A is leader, then launches B —
    deterministic initial leadership, so a chaos plan installed on A
    (``chaos_point``/``chaos_at``) kills the ACTIVE gateway."""
    ha_root = os.path.join(root, "gateway-ha")
    os.makedirs(ha_root, exist_ok=True)
    a = launch_gateway(
        root, workers, model=model, host=host, deadline_s=deadline_s,
        config=config, max_idle_s=max_idle_s,
        ready_timeout_s=ready_timeout_s, ha_root=ha_root,
        lease_s=lease_s, drain_grace_s=drain_grace_s,
        chaos_point=chaos_point, chaos_at=chaos_at,
        log_name="gateway-a.stderr.log",
    )
    probe = RpcClient(a[1], a[2], deadline_s=1.0, retries=0)
    try:
        deadline = time.monotonic() + leader_timeout_s
        while True:
            try:
                resp, _ = probe.call("whois")
                if resp.get("role") == "leader":
                    break
            except RpcError:
                pass
            if time.monotonic() > deadline:
                try:
                    a[0].kill()
                except OSError:
                    pass
                raise RuntimeError(
                    "gateway A never took the initial lease"
                )
            time.sleep(0.02)
    finally:
        probe.close()
    try:
        b = launch_gateway(
            root, workers, model=model, host=host, deadline_s=deadline_s,
            config=config, max_idle_s=max_idle_s,
            ready_timeout_s=ready_timeout_s, ha_root=ha_root,
            lease_s=lease_s, drain_grace_s=drain_grace_s,
            log_name="gateway-b.stderr.log",
        )
    except BaseException:
        try:
            a[0].kill()
        except OSError:
            pass
        raise
    return [a, b]


if __name__ == "__main__":  # pragma: no cover - subprocess entrypoint
    sys.exit(main(sys.argv[1:]))
