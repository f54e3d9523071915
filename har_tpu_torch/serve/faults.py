"""Fault injection for the fleet serving engine — prove the degradation
paths, don't hope at them.

Two fault surfaces, matching the two places a deployed fleet actually
breaks:

  ``DispatchFaults`` — a ``FleetServer(fault_hook=...)`` callable that
    simulates the chip/tunnel side: periodic dispatch stalls (SLO
    breach → smoothing shed → scoring shed ladder) and transient
    dispatch failures (retry path, then drop-batch path).  Stalls can
    either really sleep or advance an injected fake clock, so scheduler
    tests run deterministically in microseconds.

  ``DeliveryFaults`` — transport-side sample-delivery faults applied by
    the load generator (har_tpu_torch.serve.loadgen): dropped chunks (samples
    lost in transport), delayed chunks (held and delivered with the
    next round — which is exactly a catch-up burst), and forced bursts.
    Per-session in-order delivery is preserved — reordering within one
    sensor's TCP-like stream is not a fault mode worth simulating.

Everything is seeded: the same spec produces the same fault schedule.

Port of ``har_tpu/serve/faults.py`` (copied).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np


class InjectedDispatchFailure(RuntimeError):
    """Raised by DispatchFaults to simulate a failed dispatch."""


@dataclasses.dataclass
class DispatchFaults:
    """Callable fault hook for FleetServer's dispatch path.

    stall_every / stall_ms:
        every Nth dispatch attempt stalls by stall_ms (0 = never).
    fail_every:
        every Nth dispatch attempt raises InjectedDispatchFailure
        (0 = never); with FleetConfig.retries >= 1 a lone failure is
        absorbed by the retry path.
    fake_clock:
        a ``FakeClock`` (or anything with ``advance(seconds)``): stalls
        advance it instead of sleeping, keeping tests instant.
    """

    stall_every: int = 0
    stall_ms: float = 0.0
    fail_every: int = 0
    fake_clock: object = None
    attempts: int = 0

    def __call__(self, windows: np.ndarray) -> None:
        self.attempts += 1
        if self.stall_every and self.attempts % self.stall_every == 0:
            if self.fake_clock is not None:
                self.fake_clock.advance(self.stall_ms / 1e3)
            else:
                time.sleep(self.stall_ms / 1e3)
        if self.fail_every and self.attempts % self.fail_every == 0:
            raise InjectedDispatchFailure(
                f"injected failure at dispatch attempt {self.attempts}"
            )


class FakeClock:
    """Deterministic monotonic clock for scheduler tests: pass
    ``clock=fake`` to FleetServer and ``fake_clock=fake`` to
    DispatchFaults; advance it explicitly to cross deadlines."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, seconds: float) -> float:
        self.t += float(seconds)
        return self.t


class JournalFaults:
    """Deterministic storage faults for the FleetJournal fault hook
    (``FleetJournal.fault``): raise an OSError at the Nth occurrence of
    the chosen journal operation — ``"write"`` (the segment append),
    ``"fsync"`` (durability sync), or ``"snapshot"`` (the atomic
    snapshot write).  ``times`` consecutive occurrences fail from that
    point (a disk that stays full), then the hook goes quiet (space
    freed) — counter-based, no RNG, so a containment test replays
    exactly.  ``errno_code`` defaults to ENOSPC; pass ``errno.EIO`` for
    the dying-disk flavor."""

    def __init__(self, op: str, at: int = 1, times: int = 1,
                 errno_code: int | None = None):
        import errno

        if op not in ("write", "fsync", "snapshot"):
            raise ValueError(f"unknown journal fault op {op!r}")
        self.op = op
        self.at = int(at)
        self.times = int(times)
        self.errno_code = (
            errno.ENOSPC if errno_code is None else int(errno_code)
        )
        self.hits = 0
        self.fired = 0

    def __call__(self, op: str) -> None:
        if op != self.op:
            return
        self.hits += 1
        if self.at <= self.hits < self.at + self.times:
            self.fired += 1
            raise OSError(
                self.errno_code,
                f"injected journal {op} fault "
                f"(occurrence {self.hits})",
            )


@dataclasses.dataclass(frozen=True)
class DeliveryFaults:
    """Transport-side fault probabilities for the load generator.

    drop_prob:   a delivery chunk is lost (its samples never arrive —
                 downstream windows shift, exactly like a real sensor
                 outage).
    delay_prob:  a chunk is held one delivery round and prepended to the
                 session's next delivery (a catch-up burst).
    burst_prob:  a session delivers its next several rounds at once
                 (burst_rounds chunks in one push).
    burst_rounds: chunks per forced burst.
    """

    drop_prob: float = 0.0
    delay_prob: float = 0.0
    burst_prob: float = 0.0
    burst_rounds: int = 4

    def any(self) -> bool:
        return bool(self.drop_prob or self.delay_prob or self.burst_prob)
