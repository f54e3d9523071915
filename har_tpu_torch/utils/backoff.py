"""Capped exponential backoff with deterministic seeded jitter — THE
retry-pacing policy shared by the fleet stack.

Two call sites need the same policy and must not drift:

  - the fleet engine's per-dispatch retry loop (``FleetServer``
    launch/retire re-attempts): the dispatch hot path never sleeps —
    retries are immediate — but the attempt counting and the give-up
    cap are this module's ``retry_call``;
  - the cluster control plane's router→worker heartbeat probes and
    hand-off retries (``har_tpu.serve.cluster``): the failure detector
    consumes ``next_ms()`` to SCHEDULE its next probe against the
    injected clock (no sleeping — the poll loop simply skips the
    worker until the delay has passed), and hand-off retries pass a
    clock-advancing ``sleep`` when the clock supports it — either way
    a flapping worker is retried at a decaying rate instead of
    hammered: the Spark-ML perf study's warning (arXiv 1612.01437)
    that coordination overhead dominates distributed ML, applied to
    our failure detector.

Determinism is a requirement, not a nicety (harlint HL004): the jitter
draw is seeded, so the same seed produces the same delay schedule and a
chaos run replays byte-identically.  ``reset()`` restarts BOTH the
exponent and the jitter stream — after a success the next failure sees
the exact schedule a fresh instance would.

Port of ``har_tpu/utils/backoff.py`` (numpy, copied).  One change: past
the cap the exponent is no longer raised, so a sequence of thousands of
failures keeps returning the cap where the JAX package's
``factor**attempt`` overflows (``OverflowError`` after ~1,000 attempts
at factor 2); every delay before that is the same.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Delay-schedule knobs: ``base_ms * factor**attempt`` capped at
    ``cap_ms``, plus a seeded uniform jitter of up to ``jitter`` times
    the un-jittered delay (the cap applies after jitter too — the cap
    is a promise, not a suggestion)."""

    base_ms: float = 50.0
    cap_ms: float = 2000.0
    factor: float = 2.0
    jitter: float = 0.25

    def __post_init__(self):
        if self.base_ms <= 0 or self.cap_ms < self.base_ms:
            raise ValueError("need 0 < base_ms <= cap_ms")
        if self.factor < 1.0 or not (0.0 <= self.jitter <= 1.0):
            raise ValueError("need factor >= 1 and jitter in [0, 1]")


class Backoff:
    """One retry sequence: ``next_ms()`` per failed attempt, ``reset()``
    on success.  Seeded: two instances with the same (policy, seed)
    produce the same delay sequence, and ``reset()`` restarts it."""

    def __init__(self, policy: BackoffPolicy | None = None, seed: int = 0):
        self.policy = policy or BackoffPolicy()
        self._seed = int(seed)
        self.attempt = 0
        self._rng = np.random.default_rng((self._seed, 0xB0FF))

    def next_ms(self) -> float:
        """Delay before the next attempt (milliseconds), advancing the
        schedule: base * factor^attempt + seeded jitter, capped."""
        p = self.policy
        if self.attempt * math.log(p.factor) > math.log(p.cap_ms / p.base_ms):
            # past the cap: the power itself would overflow a float after
            # ~1,000 attempts (a dead worker's strikes count without bound)
            raw = p.cap_ms
        else:
            raw = min(p.cap_ms, p.base_ms * p.factor**self.attempt)
        self.attempt += 1
        delay = raw + raw * p.jitter * float(self._rng.random())
        return min(p.cap_ms, delay)

    def reset(self) -> None:
        """Back to attempt 0 AND the start of the jitter stream — the
        schedule after a success is the schedule of a fresh instance.
        A no-op while already fresh: ``retry_call`` resets on every
        success, and the dispatch hot path must not pay a Generator
        rebuild per successfully launched batch."""
        if self.attempt == 0:
            return
        self.attempt = 0
        self._rng = np.random.default_rng((self._seed, 0xB0FF))


def retry_call(
    fn: Callable,
    *,
    retries: int,
    backoff: Backoff | None = None,
    sleep: Callable[[float], None] | None = None,
    on_retry: Callable[[int, Exception], None] | None = None,
):
    """Call ``fn()`` with up to ``retries`` transparent re-attempts.

    Returns ``fn()``'s value; re-raises the last exception once the
    budget is spent.  ``on_retry(attempt, exc)`` fires before each
    re-attempt (accounting hook — the fleet engine counts
    ``dispatch_retries`` here).  ``backoff.next_ms()`` is consumed per
    re-attempt and ``backoff.reset()`` runs on success; the wait itself
    happens only when ``sleep`` (seconds) is given — the fleet dispatch
    hot path passes ``sleep=None`` (it must never block; the schedule
    still advances so shared-backoff callers see the failures), while
    the cluster's hand-off retries pass the injected clock's
    ``advance`` so simulated time moves with each re-attempt.
    """
    if retries < 0:
        raise ValueError("retries must be >= 0")
    attempt = 0
    while True:
        try:
            out = fn()
        except Exception as exc:
            attempt += 1
            if attempt > retries:
                raise
            if on_retry is not None:
                on_retry(attempt, exc)
            if backoff is not None:
                delay_ms = backoff.next_ms()
                if sleep is not None:
                    sleep(delay_ms / 1e3)
        else:
            if backoff is not None:
                backoff.reset()
            return out
