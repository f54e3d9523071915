"""``NetWorker`` — the transport-backed twin of ``ClusterWorker``.

Same surface, every call an RPC: the controller (``FleetCluster`` /
``NetCluster``) cannot tell the two apart, which is the whole design —
every cluster invariant proven against the in-process shim re-proves
over the wire by swapping this class in behind the same seam.

Error mapping is the failure detector's food:

  - ``RpcConnectionRefused``  -> ``WorkerUnavailable``  (death evidence)
  - ``RpcDeadlineExceeded``   -> ``WorkerTimeout``      (slow link:
    probe re-paced, NO strike — see ``Membership.note_timeout``)
  - ``RpcRemoteError``        -> the remote exception re-raised by
    class name where the control plane dispatches on it
    (``AdmissionError`` drives the hand-off's next-candidate fallback)

``kill()`` here is a FENCE, not a kill: the controller-side refusal to
talk to a worker it has declared dead (the in-process stand-in fenced
the same way).  Killing the actual process is the harness's job — or
reality's.

Port of ``har_tpu/serve/net/client.py`` (copied): ``NetWorker`` and
``HAGatewayClient``, the lossless-reconnect client of an elected
ingest-gateway pair (``har_tpu_torch.serve.net.gateway``).
"""

from __future__ import annotations

import os
import time
from typing import Hashable

from har_tpu_torch.serve.cluster.membership import WorkerTimeout, WorkerUnavailable
from har_tpu_torch.serve.engine import AdmissionError
from har_tpu_torch.serve.net import wire
from har_tpu_torch.serve.net.gateway import GatewayClient
from har_tpu_torch.utils.backoff import Backoff, BackoffPolicy
from har_tpu_torch.serve.net.rpc import (
    RpcClient,
    RpcConnectionRefused,
    RpcDeadlineExceeded,
    RpcRemoteError,
)

# remote exception class names re-raised as their local types: the
# hand-off fallback logic dispatches on AdmissionError (capacity
# refusal != failure-detector evidence)
_REMOTE_TYPES = {"AdmissionError": AdmissionError}


class NetWorker:
    """One remote FleetServer worker, addressed over loopback TCP.

    ``journal_dir`` must be the worker's journal directory on a
    filesystem the controller can read — failover restores the dead
    partition from DISK (the journal is the hand-off currency, exactly
    like the in-process design).  ``probe_deadline_s`` bounds the cheap
    heartbeat probe tighter than data-plane calls.
    """

    def __init__(
        self,
        worker_id,
        host: str,
        port: int,
        journal_dir: str,
        *,
        deadline_s: float = 2.0,
        probe_deadline_s: float = 0.25,
        retries: int = 2,
        stats=None,
        faults=None,
        process=None,
        seed: int = 0,
    ):
        self.worker_id = worker_id
        self.host = host
        self.port = int(port)
        # abspath-normalized: the controller's orphan scan compares
        # journal_dir strings against its own abspath'd root
        self.journal_dir = os.path.abspath(journal_dir)
        self.alive = True
        self.probe_deadline_s = float(probe_deadline_s)
        # the subprocess handle when this controller launched the
        # worker (launch_workers) — lifecycle convenience, never
        # consulted for liveness: the PROTOCOL decides liveness
        self.process = process
        self._client = RpcClient(
            host,
            port,
            deadline_s=deadline_s,
            retries=retries,
            stats=stats,
            faults=faults,
            seed=seed,
        )

    def bind_stats(self, stats) -> None:
        """Point the transport counters at the OWNING cluster's
        ``net_stats`` — rebinding on adoption, so a takeover
        controller's counters describe its own mandate."""
        self._client.stats = stats

    # ------------------------------------------------------------ call

    def _call(self, method, meta=None, payload=b"", **kw):
        if not self.alive:
            raise WorkerUnavailable(
                f"worker {self.worker_id!r} is fenced"
            )
        try:
            return self._client.call(method, meta, payload, **kw)
        except RpcDeadlineExceeded as exc:
            raise WorkerTimeout(
                f"worker {self.worker_id!r}: {exc}"
            ) from exc
        except RpcConnectionRefused as exc:
            raise WorkerUnavailable(
                f"worker {self.worker_id!r}: {exc}"
            ) from exc
        except RpcRemoteError as exc:
            local = _REMOTE_TYPES.get(exc.kind)
            if local is not None:
                raise local(str(exc)) from exc
            raise

    # ----------------------------------------------------- the RPCs

    def heartbeat(self) -> bool:
        self._call(
            "heartbeat", deadline_s=self.probe_deadline_s, retries=0
        )
        return True

    def push(self, session_id: Hashable, samples) -> int:
        meta, payload = wire.encode_samples(samples)
        meta["sid"] = session_id
        resp, _ = self._call("push", meta, payload)
        return int(resp["r"])

    def push_many(self, session_ids, chunks) -> int:
        """One batched push frame for a whole delivery round
        (``FleetServer.push_many``'s signature) — the pairs ride the
        chunk-batch codec in delivery order, one RPC instead of one
        per session.  The per-session ``push`` above stays
        (single-session compat, test-pinned equivalent)."""
        meta, payload = wire.encode_chunk_batch(
            zip(session_ids, chunks)
        )
        resp, _ = self._call("push_many", meta, payload)
        return int(resp["r"])

    def poll(self, *, force: bool = False) -> list:
        resp, payload = self._call("poll", {"force": bool(force)})
        return wire.decode_events(resp, payload)

    def add_session(self, session_id: Hashable, *, monitor=None) -> None:
        from har_tpu_torch.serve.journal import monitor_state

        self._call(
            "add_session",
            {"sid": session_id, "mon": monitor_state(monitor)},
        )

    def disconnect_session(self, session_id: Hashable) -> list:
        return self.disconnect_sessions((session_id,))

    def disconnect_sessions(self, session_ids) -> list:
        resp, payload = self._call(
            "disconnect", {"sids": list(session_ids)}
        )
        return wire.decode_events(resp, payload)

    def adopt(self, export: dict) -> None:
        meta, payload = wire.encode_export(export)
        self._call("adopt", meta, payload)

    def owns(self, session_id: Hashable) -> bool:
        if not self.alive:
            return False
        try:
            resp, _ = self._call("owns", {"sid": session_id})
        except WorkerTimeout:
            # UNKNOWN is not "no": the hand-off's ownership pre-scan
            # exists to find a prior crashed attempt's durable adopt —
            # answering False for a merely-slow worker could mint a
            # second live copy.  Propagate; the caller retries later.
            raise
        except WorkerUnavailable:
            return False
        return bool(resp["r"])

    def watermark(self, session_id: Hashable) -> int:
        resp, _ = self._call("watermark", {"sid": session_id})
        return int(resp["r"])

    # ------------------------------------------- control-plane surface

    def export_session(self, session_id: Hashable) -> dict:
        resp, payload = self._call("export", {"sid": session_id})
        return wire.decode_export(resp, payload)

    def evict_session(self, session_id: Hashable) -> None:
        self._call("evict", {"sid": session_id})

    def sessions(self) -> tuple:
        resp, _ = self._call("sessions")
        return tuple(resp["r"])

    def session_count(self) -> int:
        resp, _ = self._call("control_stats")
        return int(resp["sessions"])

    def generation(self, session_id: Hashable) -> int:
        resp, _ = self._call("generation", {"sid": session_id})
        return int(resp["r"])

    def undrained(self) -> list:
        resp, _ = self._call("undrained")
        return list(resp["r"])

    def model_version(self) -> str:
        resp, _ = self._call("model_version")
        return str(resp["r"])

    def swap_model(self, model, *, version: str) -> None:
        """Broadcast half of the hot swap: only the VERSION crosses the
        wire — the worker resolves it from its local model pool (models
        are runtime resources, same stance as the journal's swap
        record).  The ``model`` argument keeps the ClusterWorker
        signature; a transport cannot ship a live model object."""
        self._call("swap", {"ver": version})

    def resize(self, target_batch: int) -> int:
        resp, _ = self._call("resize", {"tb": int(target_batch)})
        return int(resp["r"])

    def geometry(self) -> dict:
        resp, _ = self._call("geometry")
        return {k: v for k, v in resp.items() if k != "id"}

    def accounting(self) -> dict:
        resp, _ = self._call("accounting")
        return resp["r"]

    def final_accounting(self) -> dict:
        resp, _ = self._call("final_accounting")
        return {
            "accounting": resp["accounting"],
            "scored_by_version": resp["scored_by_version"],
        }

    def control_stats(self) -> dict:
        resp, _ = self._call("control_stats")
        return {k: v for k, v in resp.items() if k != "id"}

    def drift_reports(self) -> list:
        """Every monitored session's latest DriftReport, float64-exact
        across the wire (``wire.encode_drift_reports``): the aggregator
        sees the same z / log-ratio numbers and the same
        ``(generation, onset)`` episode ids it would in-process, so
        threshold verdicts and episode dedup cannot drift with the
        transport."""
        resp, payload = self._call("drift_reports")
        return wire.decode_drift_reports(resp, payload)

    def note_failover_absorbed(self) -> None:
        self._call("note_failover_absorbed")

    def note_migration_ms(self, ms: float) -> None:
        self._call("note_migration_ms", {"ms": float(ms)})

    def stats_snapshot(self) -> dict:
        resp, _ = self._call("stats_snapshot")
        return resp["r"]

    # ----------------------------------------------------- lifecycle

    def kill(self) -> None:
        """Fence: refuse all further calls from THIS controller.  The
        remote process (if still running) is untouched — fencing is a
        controller-side decision, the worker's own death is the
        process's (or the harness's) business."""
        self.alive = False
        self._client.close()

    def shutdown(self) -> None:
        """Ask the worker process to exit cleanly (journal closed)."""
        try:
            self._call("shutdown")
        except WorkerUnavailable:
            pass

    def close(self) -> None:
        self.alive = False
        self._client.close()


class HAGatewayClient(GatewayClient):
    """Front-door client for an ELECTED gateway pair — the lossless
    reconnect half of edge HA.

    Wraps every RPC (``_call``) in a redial-and-resume loop:

      - a dead connection (``RpcConnectionRefused`` — the gateway
        process is gone — or a deadline past the base client's own
        retry budget) re-resolves the leader by rotating through the
        configured addresses UNDER the shared ``utils/backoff.Backoff``
        policy (capped exponential, seeded jitter): the whole client
        population re-dials at a decaying, de-synchronized rate instead
        of stampeding the survivor at the lease flip.  A successful
        frame ``reset()``s the schedule — the next episode starts at
        the base delay;
      - a ``{"moved": leader_addr}`` receipt (the standby's declared
        refusal) redials the quoted address IMMEDIATELY — the receipt
        is a resolution, not a failure;
      - every leader response carries the fenced lease generation
        (``gen``); a response whose generation is BELOW the largest
        this client has seen is a deposed leader's late ack — rejected
        (``stale_acks_rejected``) and the call re-delivered to the real
        leader, where the gateway's dedup-by-watermark trims the replay
        idempotently (never double-counted);
      - the retried call re-sends the SAME frame (same buffered chunks,
        same per-chunk stream offsets), so the resumed delivery starts
        exactly where the workers' ``watermark(sid)`` says it should:
        rows below it are trimmed at the edge, rows above it land once
        — bit-identical to an unbroken run.

    Failover observability rides the client: ``reconnects``,
    ``moved_receipts``, ``redial_delays_ms`` (the pinnable backoff
    schedule), ``last_failover_ms`` (first disconnect to first
    successful call) and ``resumed`` (sessions whose delivery resumed
    after at least one reconnect).
    """

    def __init__(
        self,
        addrs,
        *,
        tenant: str | None = None,
        deadline_s: float = 10.0,
        retries: int = 2,
        reconnect: BackoffPolicy | None = None,
        seed: int = 0,
        sleep=None,
        max_attempts: int = 240,
    ):
        parsed = []
        for a in addrs:
            if isinstance(a, str):
                host, _, port = a.rpartition(":")
                parsed.append((host, int(port)))
            else:
                parsed.append((a[0], int(a[1])))
        if not parsed:
            raise ValueError("need at least one gateway address")
        self.addrs = parsed
        self._addr_i = 0
        self._reconnect = Backoff(
            reconnect
            or BackoffPolicy(base_ms=10.0, cap_ms=500.0, factor=2.0,
                             jitter=0.25),
            seed=seed,
        )
        self._sleep_fn = sleep if sleep is not None else time.sleep
        self._max_attempts = int(max_attempts)
        self.gen = 0
        self.reconnects = 0
        self.moved_receipts = 0
        self.stale_acks_rejected = 0
        self.failover_episodes = 0
        self.redial_delays_ms: list = []
        self.resumed: set = set()
        self.last_failover_ms: float | None = None
        self._episode_t0: float | None = None
        self._episodes_settled = 0
        host, port = parsed[0]
        super().__init__(
            host, port, tenant=tenant, deadline_s=deadline_s,
            retries=retries,
        )

    # ------------------------------------------------------- transport

    def _disconnected(self) -> None:
        """One failed dial/call: start (or continue) a failover
        episode, wait out the next backoff delay, rotate to the next
        configured address and re-dial."""
        self.reconnects += 1
        if self._episode_t0 is None:
            self._episode_t0 = time.monotonic()
        delay_ms = self._reconnect.next_ms()
        self.redial_delays_ms.append(delay_ms)
        self._sleep_fn(delay_ms / 1e3)
        self._addr_i = (self._addr_i + 1) % len(self.addrs)
        host, port = self.addrs[self._addr_i]
        self._dial(host, port)

    def _retarget(self, addr) -> None:
        """Follow a ``{"moved": leader_addr}`` receipt.  A receipt with
        no address (election still in flight) degrades to the rotate-
        under-backoff path."""
        if self._episode_t0 is None:
            self._episode_t0 = time.monotonic()
        if not addr:
            self._disconnected()
            return
        host, _, port = str(addr).rpartition(":")
        for i, (h, p) in enumerate(self.addrs):
            if h == host and p == int(port):
                self._addr_i = i
                break
        self._dial(host, int(port))

    def _call(self, method: str, meta: dict | None = None,
              payload: bytes = b""):
        attempts = 0
        while True:
            try:
                resp, p = self._client.call(method, meta, payload)
            except (RpcConnectionRefused, RpcDeadlineExceeded):
                attempts += 1
                if attempts > self._max_attempts:
                    raise
                self._disconnected()
                continue
            if isinstance(resp, dict) and "moved" in resp:
                self.moved_receipts += 1
                attempts += 1
                if attempts > self._max_attempts:
                    raise RpcConnectionRefused(
                        "no gateway leader after "
                        f"{self._max_attempts} attempts"
                    )
                self._retarget(resp.get("moved"))
                continue
            g = resp.get("gen") if isinstance(resp, dict) else None
            if g is not None:
                g = int(g)
                if g < self.gen:
                    # a deposed leader's late ack: its mandate is
                    # fenced out — reject the receipt and re-deliver
                    # to the real leader (edge dedup-by-watermark
                    # makes the replay idempotent)
                    self.stale_acks_rejected += 1
                    attempts += 1
                    if attempts > self._max_attempts:
                        raise RpcConnectionRefused(
                            "only stale gateway generations answered"
                        )
                    self._disconnected()
                    continue
                self.gen = g
            # a successful frame ends the episode: backoff restarts at
            # the base delay (no thundering herd carried forward)
            self._reconnect.reset()
            if self._episode_t0 is not None:
                self.last_failover_ms = (
                    time.monotonic() - self._episode_t0
                ) * 1e3
                self._episode_t0 = None
                self.failover_episodes += 1
            return resp, p

    # ------------------------------------------------- resume tracking

    def _flush_pending(self) -> None:
        sids = [sid for sid, _, _ in self._pending]
        super()._flush_pending()
        if self.failover_episodes > self._episodes_settled:
            # this frame is the first to land after a failover episode
            # (socket loss OR a moved-receipt retarget): its sessions
            # RESUMED across the lease flip
            self.resumed.update(sids)
            self._episodes_settled = self.failover_episodes
