"""Heartbeat/lease failure detection for cluster workers.

A worker is alive while it keeps renewing its lease; a worker that
stops answering is SUSPECTED, probed at a capped-exponential-backoff
cadence (``har_tpu_torch.utils.backoff`` — the same policy the dispatch
retry loop uses), and declared DEAD only when BOTH hold:

  - its lease expired (``lease_s`` without a successful heartbeat), and
  - ``probe_retries`` consecutive probes failed.

The two-condition rule is deliberate: a lease alone declares death on
one slow poll; probes alone declare it on a transient burst of refused
connections.  Requiring both bounds the false-positive rate (a false
death triggers a full partition migration — expensive to be wrong
about) while the backoff bounds the probe traffic (the Spark-ML perf
study's point that coordination overhead, not compute, dominates
distributed ML: a dead worker must not be hammered at line rate).

No wall clocks (harlint HL004): every deadline reads the injected
clock, so the whole failure detector runs deterministically under a
``FakeClock`` in the chaos harness.

Port of ``har_tpu/serve/cluster/membership.py`` (stdlib, copied, on the
port's ``utils/backoff.py``): the same evidence on the same clock gives
the JAX package's decisions.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

from har_tpu_torch.utils.backoff import Backoff, BackoffPolicy


class WorkerUnavailable(RuntimeError):
    """A routed call reached a dead or unreachable worker."""


class WorkerTimeout(WorkerUnavailable):
    """The worker did not answer inside the call deadline — a SLOW LINK
    or a busy worker, not death evidence.  Subclasses WorkerUnavailable
    so every existing "worker did not serve this call" path still
    catches it; the failure detector routes it to ``note_timeout``
    (re-paced probe, NO strike) instead of ``note_failure`` — a
    congested-but-alive worker must never be failovered spuriously
    (test-pinned both paths)."""


@dataclasses.dataclass(frozen=True)
class LeaseConfig:
    """Failure-detection knobs."""

    # seconds a worker stays trusted after its last successful
    # heartbeat; expiry alone does NOT declare death (see probes)
    lease_s: float = 2.0
    # consecutive failed probes (after lease expiry) before death
    probe_retries: int = 3
    # probe pacing: capped exponential backoff with seeded jitter
    probe_base_ms: float = 50.0
    probe_cap_ms: float = 1000.0
    seed: int = 0

    def __post_init__(self):
        if self.lease_s <= 0 or self.probe_retries < 1:
            raise ValueError("need lease_s > 0 and probe_retries >= 1")


class _WorkerHealth:
    __slots__ = ("lease_until", "failures", "next_probe", "backoff")

    def __init__(self, now: float, lease_s: float, backoff: Backoff):
        self.lease_until = now + lease_s
        self.failures = 0
        self.next_probe = now
        self.backoff = backoff


class Membership:
    """Lease table + probe scheduler over a set of worker ids."""

    def __init__(
        self,
        config: LeaseConfig | None = None,
        *,
        clock: Callable[[], float] | None = None,
    ):
        self.config = config or LeaseConfig()
        self._clock = clock or time.monotonic
        self._health: dict = {}
        self._dead: list = []

    # ------------------------------------------------------ membership

    def add(self, worker_id) -> None:
        cfg = self.config
        self._health[worker_id] = _WorkerHealth(
            self._clock(),
            cfg.lease_s,
            Backoff(
                BackoffPolicy(
                    base_ms=cfg.probe_base_ms, cap_ms=cfg.probe_cap_ms
                ),
                seed=cfg.seed,
            ),
        )

    def remove(self, worker_id) -> None:
        self._health.pop(worker_id, None)

    def alive(self) -> tuple:
        return tuple(self._health)

    @property
    def dead(self) -> tuple:
        """Workers declared dead, in declaration order."""
        return tuple(self._dead)

    # ------------------------------------------------------- evidence

    def note_ok(self, worker_id) -> None:
        """A successful heartbeat/call: renew the lease, clear the
        suspicion state and restart the probe backoff schedule."""
        h = self._health.get(worker_id)
        if h is None:
            return
        h.lease_until = self._clock() + self.config.lease_s
        h.failures = 0
        h.next_probe = self._clock()
        h.backoff.reset()

    def note_failure(self, worker_id) -> None:
        """A failed heartbeat/call: count it and push the next probe
        out by the backoff schedule (capped — a long-dead worker is
        probed at the cap rate until the lease math declares it)."""
        h = self._health.get(worker_id)
        if h is None:
            return
        h.failures += 1
        h.next_probe = self._clock() + h.backoff.next_ms() / 1e3

    def note_timeout(self, worker_id) -> None:
        """A DEADLINE-EXCEEDED call (``WorkerTimeout``): the link is
        slow or the worker busy — re-pace the next probe by the same
        backoff schedule but consume NO probe strike and renew nothing.
        Connection-refused is death evidence (nobody listening);
        a late answer is congestion evidence, and a worker whose lease
        expires on congestion alone still needs ``probe_retries``
        REFUSED probes before the detector declares it — the
        slow-link partition case resolves with zero failovers."""
        h = self._health.get(worker_id)
        if h is None:
            return
        h.next_probe = self._clock() + h.backoff.next_ms() / 1e3

    def probe_due(self, worker_id) -> bool:
        """Should the controller spend a probe on this worker now?
        Healthy workers are always probe-due (the probe IS the
        heartbeat); suspected ones wait out their backoff."""
        h = self._health.get(worker_id)
        return h is not None and self._clock() >= h.next_probe

    def suspected(self, worker_id) -> bool:
        """True while the worker has unresolved probe failures — the
        controller probes these with the cheap ``heartbeat()`` RPC
        before spending a full poll on them."""
        h = self._health.get(worker_id)
        return h is not None and h.failures > 0

    def expired(self) -> tuple:
        """Workers whose lease ran out AND whose probe budget is spent
        — the death declarations.  Declared workers move to ``dead``
        and leave the health table (the controller removes them from
        the ring and starts the failover)."""
        now = self._clock()
        cfg = self.config
        newly = [
            wid
            for wid, h in self._health.items()
            if now >= h.lease_until and h.failures >= cfg.probe_retries
        ]
        for wid in newly:
            del self._health[wid]
            self._dead.append(wid)
        return tuple(newly)
