"""Request/response RPC over TCP for the fleet control plane.

Deliberately small: one frame out, one frame back, over a pooled
connection.  What it adds over a bare socket is exactly the failure
surface the cluster invariants must be re-proven against:

  - DEADLINES — every call carries a real wall deadline (the transport
    layer's one legitimate use of real clocks; harlint HL004's
    ``serve/net/`` allowlist).  A peer that answers late is
    ``RpcDeadlineExceeded``;
  - ERROR TAXONOMY — ``RpcConnectionRefused`` (nobody listening: the
    strongest cheap evidence a worker PROCESS is dead) is distinct
    from ``RpcDeadlineExceeded`` (a slow link or a busy worker — NOT
    death evidence; the membership prober must not spend a probe
    strike on it, see ``Membership.note_timeout``);
  - RETRIES — deadline-exceeded calls retry through the shared
    ``utils.backoff`` policy with the SAME request id, so a retry of a
    request the peer already executed is deduplicated server-side
    (exactly-once per request id), never re-executed;
  - DUPLICATE DELIVERY — the server answers every frame it receives;
    a duplicated request (retry or ``LinkFaults`` injection) is
    answered from a bounded response cache.  The client discards
    responses whose id is not the one in flight (a late answer to a
    timed-out earlier request must not be misread as the current one);
  - REMOTE ERRORS — a handler exception crosses back as
    ``RpcRemoteError`` carrying the exception class name, so the
    caller can re-raise domain errors (``AdmissionError``) that the
    control plane's hand-off fallback logic dispatches on.

``LinkFaults`` is the partition-tolerance matrix's deterministic link
impairment: delay (deadline blows, peer still executed), drop (frame
never sent) or duplicate (frame sent twice) the first N matching
calls — no RNG, so a chaos run replays exactly.

Port of ``har_tpu/serve/net/rpc.py`` (stdlib, copied): requests,
responses and the dedup key are the JAX package's, so either package's
client talks to either package's server.
"""

from __future__ import annotations

import itertools
import os
import socket
import time

from har_tpu_torch.serve.net.wire import (
    FrameBuffer,
    FrameError,
    encode_frame,
)
from har_tpu_torch.utils.backoff import Backoff, BackoffPolicy


class RpcError(RuntimeError):
    """Transport-level RPC failure."""


class RpcConnectionRefused(RpcError):
    """Nobody is listening at the peer address (or the connection was
    reset mid-call): the worker PROCESS is gone — death evidence."""


class RpcDeadlineExceeded(RpcError):
    """The peer did not answer inside the deadline: slow link or busy
    worker — retry evidence, never death evidence on its own."""


class RpcRemoteError(RpcError):
    """The remote handler raised: ``kind`` is the exception class name,
    the message its text.  The call REACHED a live worker — remote
    errors renew the lease like any successful round trip."""

    def __init__(self, kind: str, message: str):
        super().__init__(f"{kind}: {message}")
        self.kind = kind


class LinkFaults:
    """Deterministic link impairment for the partition matrix.

    Applies ``action`` to the first ``times`` client calls whose method
    name starts with ``method`` (empty = all):

      ``delay``  the request is sent, then the client sleeps past its
                 own deadline before reading — the peer EXECUTED the
                 call but the answer is late (the retry-dedup case);
      ``drop``   the request frame is never sent — a blackholed link
                 (the dropped-probe case);
      ``dup``    the request frame is sent twice — duplicated delivery
                 (the server-side dedup case).

    Counter-based, not random: the matrix must replay exactly.
    """

    def __init__(self, action: str, method: str = "", times: int = 1):
        if action not in ("delay", "drop", "dup"):
            raise ValueError(f"unknown link-fault action {action!r}")
        self.action = action
        self.method = method
        self.times = int(times)
        self.fired = 0

    def hit(self, method: str) -> str | None:
        if self.fired >= self.times or not method.startswith(self.method):
            return None
        self.fired += 1
        return self.action


def _recv_into(
    sock: socket.socket, buf: FrameBuffer, deadline: float, stats=None
):
    """Feed one recv into ``buf`` honoring the absolute monotonic
    ``deadline``; raises socket.timeout past it, RpcConnectionRefused
    on a peer hangup."""
    remaining = deadline - time.monotonic()
    if remaining <= 0:
        raise socket.timeout("rpc deadline exceeded")
    sock.settimeout(remaining)
    chunk = sock.recv(1 << 16)
    if not chunk:
        raise RpcConnectionRefused("peer closed the connection")
    if stats is not None:
        stats.rpc_bytes_rx += len(chunk)
    buf.feed(chunk)


# process-unique client-id counter: ``id(self)`` is reusable after GC
# (a resurrected controller's fresh client could then be answered from
# a dead client's dedup cache entry) — a monotone counter never is
_CID_COUNTER = itertools.count()


class RpcClient:
    """One pooled connection to one worker address.

    ``stats`` (a ``FleetStats``) receives the transport counters —
    ``rpc_sent`` / ``rpc_retries`` / ``rpc_bytes_tx`` / ``rpc_bytes_rx``
    and the ``rpc_rtt`` histogram; ``faults`` injects link impairments
    (``LinkFaults``).  ``cid`` identifies this client in the server's
    duplicate-dedup cache and defaults to pid+object id — unique per
    live client object, which is all dedup needs.
    """

    def __init__(
        self,
        host: str,
        port: int,
        *,
        deadline_s: float = 2.0,
        retries: int = 2,
        connect_timeout_s: float = 1.0,
        stats=None,
        faults: LinkFaults | None = None,
        seed: int = 0,
    ):
        self.host = host
        self.port = int(port)
        self.deadline_s = float(deadline_s)
        self.retries = int(retries)
        self.connect_timeout_s = float(connect_timeout_s)
        self.stats = stats
        self.faults = faults
        self._sock: socket.socket | None = None
        self._buf = FrameBuffer()
        self._rid = 0
        self._cid = f"{os.getpid()}.{next(_CID_COUNTER)}"
        self._backoff = Backoff(
            BackoffPolicy(base_ms=20.0, cap_ms=500.0), seed=seed
        )

    # ----------------------------------------------------- connection

    def _connect(self) -> socket.socket:
        if self._sock is not None:
            return self._sock
        try:
            sock = socket.create_connection(
                (self.host, self.port), timeout=self.connect_timeout_s
            )
        except socket.timeout:
            raise RpcDeadlineExceeded(
                f"connect to {self.host}:{self.port} timed out"
            )
        except OSError as exc:
            raise RpcConnectionRefused(
                f"connect to {self.host}:{self.port}: {exc}"
            )
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._buf = FrameBuffer()
        return sock

    def _drop_connection(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._buf = FrameBuffer()

    def close(self) -> None:
        self._drop_connection()

    # ----------------------------------------------------------- call

    def call(
        self,
        method: str,
        meta: dict | None = None,
        payload: bytes = b"",
        *,
        deadline_s: float | None = None,
        retries: int | None = None,
    ) -> tuple[dict, bytes]:
        """One request/response round trip.  Deadline-exceeded attempts
        retry (same request id — the peer's dedup makes an executed-
        but-unanswered attempt exactly-once); connection-refused fails
        fast: that evidence belongs to the failure detector, not a
        retry loop."""
        deadline_s = self.deadline_s if deadline_s is None else deadline_s
        budget = self.retries if retries is None else int(retries)
        self._rid += 1
        rid = self._rid
        request = dict(meta or {})
        request["m"] = method
        request["id"] = rid
        request["cid"] = self._cid
        frame = encode_frame(request, payload)
        attempt = 0
        while True:
            try:
                out = self._attempt(method, rid, frame, deadline_s)
                # a success ends the retry episode: the next failure
                # starts at the base delay, not wherever an earlier
                # episode left the schedule (Backoff's own contract)
                self._backoff.reset()
                return out
            except RpcDeadlineExceeded:
                # the in-flight request is ambiguous (executed or not);
                # drop the connection so a late answer can never be
                # misread, and retry with the SAME id — dedup upgrades
                # "ambiguous" to "exactly once"
                self._drop_connection()
                attempt += 1
                if attempt > budget:
                    raise
                if self.stats is not None:
                    self.stats.rpc_retries += 1
                time.sleep(self._backoff.next_ms() / 1e3)
            except (RpcConnectionRefused, FrameError):
                self._drop_connection()
                raise
        # unreachable

    def _attempt(
        self, method: str, rid: int, frame: bytes, deadline_s: float
    ) -> tuple[dict, bytes]:
        action = self.faults.hit(method) if self.faults is not None else None
        sock = self._connect()
        t0 = time.monotonic()
        deadline = t0 + deadline_s
        try:
            if action != "drop":
                # counters inside the send branch: a dropped frame was
                # never on the wire, a duplicated one was on it twice —
                # the partition matrix reads these as measurements
                sock.sendall(frame)
                if self.stats is not None:
                    self.stats.rpc_sent += 1
                    self.stats.rpc_bytes_tx += len(frame)
                if action == "dup":
                    sock.sendall(frame)
                    if self.stats is not None:
                        self.stats.rpc_bytes_tx += len(frame)
            if action == "delay":
                # the request is on the wire (the peer will execute
                # it); the answer is past our deadline by construction
                time.sleep(deadline_s)
            while True:
                got = self._buf.next_frame()
                while got is None:
                    _recv_into(sock, self._buf, deadline, self.stats)
                    got = self._buf.next_frame()
                resp, rpayload = got
                if resp.get("id") == rid:
                    break
                # a late answer to an earlier timed-out request on a
                # reused connection: discard and keep reading
        except socket.timeout:
            raise RpcDeadlineExceeded(
                f"{method} to {self.host}:{self.port} exceeded "
                f"{deadline_s:.3f}s"
            )
        except (ConnectionError, BrokenPipeError, OSError) as exc:
            if isinstance(exc, RpcError):
                raise
            raise RpcConnectionRefused(
                f"{method} to {self.host}:{self.port}: {exc}"
            )
        if self.stats is not None:
            self.stats.rpc_rtt.record((time.monotonic() - t0) * 1e3)
        if "err" in resp:
            raise RpcRemoteError(resp["err"], resp.get("msg", ""))
        return resp, rpayload


class RpcServer:
    """Frame-at-a-time RPC server over a selectors loop.

    Single-threaded by design: handlers run strictly serialized, so the
    FleetServer behind them needs no locking — the same "one scheduler
    thread" stance the engine itself takes.  Multiple concurrent
    connections are fine (two controllers during a split brain); their
    frames interleave at frame granularity.

    ``handlers`` maps method name -> ``fn(meta, payload) -> (meta,
    payload)``.  Handler exceptions become error responses (class name
    + message), never a dead server.  Responses are cached per
    ``(cid, id)`` in a bounded table so duplicated frames (link retry,
    fault injection) are answered without re-executing the handler.

    ``admission`` is the gateway's edge-shed hook: called with
    ``(meta, payload_len)`` from the frame HEADER as soon as it has
    arrived — before the payload is assembled, CRC-checked or decoded.
    Returning a reason string refuses the frame: its payload bytes are
    discarded as they arrive (``FrameBuffer.skip_frame``) and the
    client is answered ``{"shed": reason}`` addressed to its request
    id.  Frames whose ``(cid, id)`` already sits in the dedup cache
    bypass admission and are re-answered from the cache — a RETRY of
    an executed request must never be re-judged into a shed (the
    client would re-deliver what the fleet already holds).
    """

    DEDUP_CAP = 512

    def __init__(
        self,
        handlers: dict,
        host: str = "127.0.0.1",
        port: int = 0,
        stats=None,
        admission=None,
    ):
        import selectors

        self.handlers = dict(handlers)
        self.admission = admission
        # worker-side transport counters (FleetStats): requests are
        # bytes_rx, responses are sent/bytes_tx — the mirror of the
        # controller-side client's view
        self.stats = stats
        self._sel = selectors.DefaultSelector()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(
            socket.SOL_SOCKET, socket.SO_REUSEADDR, 1
        )
        self._listener.bind((host, port))
        self._listener.listen(16)
        self._listener.setblocking(False)
        self._sel.register(self._listener, selectors.EVENT_READ, None)
        self.host, self.port = self._listener.getsockname()
        self._bufs: dict = {}
        # connections whose HEAD frame already passed admission but is
        # still assembling its payload (torn across recvs) — judged
        # once, not once per recv
        self._admitted: dict = {}
        # (cid, rid) -> encoded response frame, insertion-ordered so
        # eviction drops the oldest (dict preserves insertion order)
        self._dedup: dict = {}
        self.requests_served = 0
        self.last_activity = time.monotonic()
        self._closed = False

    # ------------------------------------------------------------ loop

    def step(self, timeout: float = 0.05) -> int:
        """Service ready sockets once; returns frames handled."""
        import selectors

        handled = 0
        for key, _ in self._sel.select(timeout):
            sock = key.fileobj
            if sock is self._listener:
                try:
                    conn, _ = self._listener.accept()
                except OSError:
                    continue
                conn.setblocking(False)
                conn.setsockopt(
                    socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                )
                self._sel.register(conn, selectors.EVENT_READ, None)
                self._bufs[conn] = FrameBuffer()
                continue
            handled += self._service(sock)
        if handled:
            self.last_activity = time.monotonic()
        return handled

    def _service(self, sock) -> int:
        buf = self._bufs.get(sock)
        if buf is None:
            return 0
        try:
            chunk = sock.recv(1 << 16)
        except (BlockingIOError, InterruptedError):
            return 0
        except OSError:
            self._hangup(sock)
            return 0
        if not chunk:
            self._hangup(sock)
            return 0
        if self.stats is not None:
            self.stats.rpc_bytes_rx += len(chunk)
        buf.feed(chunk)
        handled = 0
        try:
            while True:
                if self.admission is not None and not self._admitted.get(
                    sock
                ):
                    # the edge: judge the frame from its HEADER, before
                    # the payload exists as anything but socket bytes
                    head = buf.peek_header()
                    if head is None:
                        break
                    hmeta, plen = head
                    key = (hmeta.get("cid"), hmeta.get("id"))
                    cached = self._dedup.get(key)
                    if cached is not None and key[0] is not None:
                        # a retried frame the fleet already executed:
                        # answered from the cache, payload discarded —
                        # never re-judged into a shed
                        buf.skip_frame()
                        self._send(sock, cached)
                        handled += 1
                        continue
                    reason = self.admission(hmeta, plen)
                    if reason is not None:
                        buf.skip_frame()
                        if isinstance(reason, dict):
                            # a structured refusal (the gateway
                            # standby's {"moved": leader} receipt):
                            # sent verbatim, addressed to the request
                            resp = dict(reason)
                            resp["id"] = hmeta.get("id")
                        else:
                            resp = {"id": hmeta.get("id"), "shed": reason}
                        frame = encode_frame(resp)
                        self.requests_served += 1
                        if key[0] is not None and key[1] is not None:
                            self._dedup[key] = frame
                            while len(self._dedup) > self.DEDUP_CAP:
                                self._dedup.pop(next(iter(self._dedup)))
                        self._send(sock, frame)
                        handled += 1
                        continue
                    # admitted: remember it so a torn payload arriving
                    # over several recvs is never judged twice
                    self._admitted[sock] = True
                got = buf.next_frame()
                if got is None:
                    break
                self._admitted.pop(sock, None)
                self._dispatch(sock, *got)
                handled += 1
        except FrameError:
            # CRC mismatch / oversize / garbage: protocol violation —
            # this connection is dead; the peer reconnects clean
            self._hangup(sock)
        return handled

    def _hangup(self, sock) -> None:
        try:
            self._sel.unregister(sock)
        except (KeyError, ValueError):
            pass
        self._bufs.pop(sock, None)
        self._admitted.pop(sock, None)
        try:
            sock.close()
        except OSError:
            pass

    def _dispatch(self, sock, meta: dict, payload: bytes) -> None:
        rid = meta.get("id")
        key = (meta.get("cid"), rid)
        cached = self._dedup.get(key)
        if cached is not None:
            self._send(sock, cached)
            return
        method = meta.get("m", "")
        fn = self.handlers.get(method)
        if fn is None:
            frame = encode_frame(
                {"id": rid, "err": "UnknownMethod", "msg": method}
            )
        else:
            try:
                rmeta, rpayload = fn(meta, payload)
                resp = dict(rmeta or {})
                resp["id"] = rid
                frame = encode_frame(resp, rpayload)
            except SystemExit:
                raise
            except BaseException as exc:
                frame = encode_frame(
                    {
                        "id": rid,
                        "err": type(exc).__name__,
                        "msg": str(exc),
                    }
                )
        self.requests_served += 1
        if key[0] is not None and rid is not None:
            self._dedup[key] = frame
            while len(self._dedup) > self.DEDUP_CAP:
                self._dedup.pop(next(iter(self._dedup)))
        self._send(sock, frame)

    def _send(self, sock, frame: bytes) -> None:
        if self.stats is not None:
            self.stats.rpc_sent += 1
            self.stats.rpc_bytes_tx += len(frame)
        try:
            sock.setblocking(True)
            sock.sendall(frame)
            sock.setblocking(False)
        except OSError:
            self._hangup(sock)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for sock in list(self._bufs):
            self._hangup(sock)
        try:
            self._sel.unregister(self._listener)
        except (KeyError, ValueError):
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        self._sel.close()
