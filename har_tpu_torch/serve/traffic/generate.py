"""Elastic traffic generation: diurnal / bursty / storm arrival
processes driving session churn through the fleet engine.

The steady load generator (``har_tpu_torch.serve.loadgen.drive_fleet``) holds N
sessions flat from the first round to the last — the steady state a
24/7 monitoring service never actually sees.  Real cohorts connect in
the morning, disconnect overnight, burst on alarms, and stall behind
slow uplinks.  This module models that load as a REPLAYABLE ARTIFACT:

  ``TraceSpec``     — the seed+params record.  Everything about a trace
                      (arrival shape, swing, storms, slow-client and
                      rate-mix draws) is a pure function of the spec, so
                      ``TrafficTrace.from_spec(trace.spec())`` rebuilds
                      the exact same schedule on any host — export a
                      trace from an incident, replay it in a test.

  ``TrafficTrace``  — the materialized schedule: per delivery round, the
                      sessions that connect and the sessions that
                      disconnect, plus each session's delivery rate.
                      Session churn uses the engine's GRACEFUL
                      disconnect (``FleetServer.disconnect_sessions``,
                      one batch per round): the assembler's partial
                      window flushes and the pending queue settles
                      before the eviction — churn never silently drops
                      accepted data.

  ``drive_trace``   — the drive loop: delivers hop-sized chunks per active
                      session per round (scaled by its rate), applies
                      slow-client stalls (chunks held for a few rounds,
                      then delivered as one catch-up burst — exactly the
                      delivery shape ``DeliveryFaults.delay_prob``
                      models, but seeded per session from the trace),
                      polls the engine, and advances the injected clock.
                      Works against a ``FleetServer`` or a
                      ``FleetCluster`` (both speak add / disconnect /
                      push / poll / flush).

Determinism stance (HL004-clean by construction): every draw comes from
``np.random.default_rng`` seeded off the spec, the drive loop reads only
the injected clock (``FakeClock`` in tests; a real monotonic clock in
the bench lane, where latency must be wall time), and no set is ever
iterated.  The schedule itself never depends on the clock at all —
round indices are the only time base, which is what makes a trace
replayable across hosts of different speeds.

Port of ``har_tpu/serve/traffic/generate.py``, numpy only and copied:
the schedule and the sample pool (the port's ``synthetic_raw_stream``,
bit-equal to the JAX package's) are the same for the same spec, so
both packages drive the same sessions with the same samples.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np

from har_tpu_torch.data.raw_windows import synthetic_raw_stream


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Seed + parameters of one traffic trace — the replayable record.

    kind:
        ``diurnal``  — sinusoidal active-session target: trough at round
                       0 (overnight), peak mid-period, back to trough.
        ``bursty``   — the diurnal base plus seeded Poisson-modulated
                       connect bursts (alarm fan-ins).
        ``storm``    — the diurnal base with the ``storms`` steps
                       applied (mass overnight-cohort disconnects).
        (``storms`` apply to every kind; ``storm`` just names a trace
        whose headline event they are.)
    peak_sessions / swing:
        peak concurrent sessions, and the peak/trough ratio — a
        ``swing`` of 10 means the trough holds peak/10 sessions.
    rounds / period:
        delivery rounds to run, and rounds per diurnal cycle.
    storms:
        ``((round, fraction), ...)`` — at each round, that fraction of
        the currently active cohort disconnects AT ONCE, oldest
        sessions first (the morning cohort leaves in the evening).
    burst_prob / burst_size:
        bursty kind: per-round probability of a connect burst, and its
        Poisson mean size.
    slow_prob / slow_rounds:
        per-(session, round) probability a delivery stalls, and for how
        many rounds the stalled chunks are held before arriving as one
        catch-up burst.
    rate_mix:
        cycled per-session delivery-rate multipliers: a session with
        rate r delivers ``r * hop`` samples per round (mixed cohorts —
        20/40 Hz sensors through the same assembler).
    """

    kind: str = "diurnal"
    peak_sessions: int = 64
    swing: float = 10.0
    rounds: int = 120
    period: int = 120
    storms: tuple = ()
    burst_prob: float = 0.0
    burst_size: int = 8
    slow_prob: float = 0.0
    slow_rounds: int = 3
    rate_mix: tuple = (1,)
    seed: int = 0

    def __post_init__(self):
        if self.kind not in ("diurnal", "bursty", "storm"):
            raise ValueError(f"unknown trace kind {self.kind!r}")
        if self.peak_sessions < 1 or self.rounds < 1 or self.period < 2:
            raise ValueError(
                "peak_sessions/rounds must be >= 1, period >= 2"
            )
        if self.swing < 1.0:
            raise ValueError("swing is peak/trough and must be >= 1")
        if not self.rate_mix or any(r < 1 for r in self.rate_mix):
            raise ValueError("rate_mix entries must be >= 1")


class TrafficTrace:
    """A materialized churn schedule: ``schedule[r]`` holds the session
    ids that connect and disconnect at round r, and ``rate_of[sid]``
    each session's delivery-rate multiplier.  Pure function of the
    spec; ``spec()``/``from_spec`` are the export/replay pair."""

    def __init__(self, spec: TraceSpec):
        self._spec = spec
        rng = np.random.default_rng((spec.seed, 0x7AF1C))
        trough = max(1, int(round(spec.peak_sessions / spec.swing)))
        storms = {int(r): float(f) for r, f in spec.storms}
        schedule: list[dict] = []
        active: list[int] = []  # connect order — oldest first
        self.rate_of: dict[int, int] = {}
        next_sid = 0
        peak_active = 0
        trough_active = None
        storm_disconnects = 0
        for r in range(spec.rounds):
            # diurnal target: trough at r=0, peak at r=period/2
            phase = 2.0 * math.pi * (r % spec.period) / spec.period
            target = trough + (spec.peak_sessions - trough) * 0.5 * (
                1.0 - math.cos(phase)
            )
            target = int(round(target))
            if spec.kind == "bursty" and spec.burst_prob:
                if rng.random() < spec.burst_prob:
                    target += int(rng.poisson(spec.burst_size))
            connects: list[int] = []
            disconnects: list[int] = []
            storm = storms.get(r)
            if storm is not None:
                n_out = int(len(active) * storm)
                disconnects.extend(active[:n_out])  # oldest cohort
                active = active[n_out:]
                storm_disconnects += n_out
            while len(active) < target:
                sid = next_sid
                next_sid += 1
                self.rate_of[sid] = int(
                    spec.rate_mix[sid % len(spec.rate_mix)]
                )
                active.append(sid)
                connects.append(sid)
            while len(active) > target:
                disconnects.append(active.pop(0))  # oldest first
            schedule.append(
                {"connect": connects, "disconnect": disconnects}
            )
            peak_active = max(peak_active, len(active))
            trough_active = (
                len(active)
                if trough_active is None
                else min(trough_active, len(active))
            )
        self.schedule = schedule
        self.total_sessions = next_sid
        self.peak_active = peak_active
        self.trough_active = trough_active or 0
        self.storm_disconnects = storm_disconnects

    def spec(self) -> dict:
        """The replayable export: JSON-ready seed+params."""
        d = dataclasses.asdict(self._spec)
        d["storms"] = [list(s) for s in d["storms"]]
        d["rate_mix"] = list(d["rate_mix"])
        return d

    @classmethod
    def from_spec(cls, spec) -> "TrafficTrace":
        """Replay: rebuild the identical schedule from an exported
        spec (a TraceSpec or its ``spec()`` dict)."""
        if isinstance(spec, TraceSpec):
            return cls(spec)
        spec = dict(spec)
        spec["storms"] = tuple(tuple(s) for s in spec.get("storms") or ())
        spec["rate_mix"] = tuple(spec.get("rate_mix") or (1,))
        return cls(TraceSpec(**spec))


@dataclasses.dataclass(frozen=True)
class TraceReport:
    """What the traffic drive actually did."""

    rounds: int
    connects: int
    disconnects: int
    storm_disconnects: int
    peak_active: int
    trough_active: int
    slow_stalls: int
    samples_delivered: int
    windows_enqueued: int
    duration_s: float


class _SessionFeed:
    """Per-session sample source + slow-client hold buffer.  Samples
    come from one shared seeded synthetic pool, each session reading a
    distinct stride-offset slice with wraparound — thousands of
    connects never re-generate data."""

    __slots__ = ("offset", "cursor", "rate", "held", "stall_left")

    def __init__(self, offset: int, rate: int):
        self.offset = offset
        self.cursor = 0
        self.rate = rate
        self.held: list[np.ndarray] = []
        self.stall_left = 0


def _pool(spec: TraceSpec, window: int) -> np.ndarray:
    """The shared sample pool every session slices (wraparound)."""
    stream = synthetic_raw_stream(
        n_windows=max(64, 2 * spec.peak_sessions),
        seed=spec.seed,
        window=window,
    )
    return stream.windows.reshape(-1, stream.windows.shape[-1])


def drive_trace(
    target,
    trace: TrafficTrace,
    *,
    clock=None,
    round_dt: float = 0.01,
    monitor_for=None,
    on_round=None,
    events: list | None = None,
) -> tuple[list, TraceReport]:
    """Run one traffic trace against a FleetServer or FleetCluster.

    Per round: apply the schedule's connects, deliver ``rate × hop``
    samples for every active session (slow clients hold theirs and
    catch up in one burst), poll, apply the graceful disconnects as
    ONE batch (``disconnect_sessions``: the leavers' partial windows
    flush and settle through a single forced poll — after the regular
    poll, so the settle's forced drain can never break the round's
    batch coalescing), then advance the injected clock by ``round_dt``
    (``clock`` defaults to real time: no advance, wall latency — the
    bench lane's mode; pass the server's FakeClock for deterministic
    tests).

    ``on_round(target, round_index)`` fires after each round's
    deliveries, BEFORE the poll and the disconnect settle — the
    capacity controller's hook (``CapacityController.on_round``): it
    reads the true backlog there (a disconnect settle running first
    would drain the very signal it scales on), and a resize it stages
    applies to this very poll's dispatches.  Any event list it returns
    (a controller drain before a worker add/retire) is folded into the
    returned events.

    Returns ``(events, TraceReport)``.  Sessions still connected when
    the trace ends stay connected (the fleet keeps serving); their
    queued windows are drained by the final flush.
    """
    spec = trace._spec
    hop = int(target.hop)
    pool = _pool(spec, hop)
    n_pool = len(pool)
    rng = np.random.default_rng((spec.seed, 0xD21F))
    feeds: dict[int, _SessionFeed] = {}
    order: list[int] = []  # active sids, connect order
    events = [] if events is None else events
    connects = disconnects = slow_stalls = 0
    delivered = enqueued = 0
    t0 = time.perf_counter()
    for r, step in enumerate(trace.schedule):
        for sid in step["connect"]:
            target.add_session(
                sid,
                monitor=(
                    monitor_for(sid) if monitor_for is not None else None
                ),
            )
            # stride-offset into the shared pool: sessions see distinct
            # (wrapped) slices without per-connect generation
            feeds[sid] = _SessionFeed(
                offset=(sid * 131 * hop) % n_pool, rate=trace.rate_of[sid]
            )
            order.append(sid)
            connects += 1
        for sid in order:
            feed = feeds[sid]
            n = feed.rate * hop
            start = (feed.offset + feed.cursor) % n_pool
            chunk = pool[start : start + n]
            if len(chunk) < n:  # wraparound
                chunk = np.concatenate([chunk, pool[: n - len(chunk)]])
            feed.cursor += n
            if feed.stall_left > 0:
                feed.stall_left -= 1
                feed.held.append(chunk)
                continue
            if spec.slow_prob and rng.random() < spec.slow_prob:
                # slow client: this and the next slow_rounds-1 chunks
                # are held, then delivered as ONE catch-up burst — a
                # stalled uplink flushing its buffer
                feed.stall_left = max(0, spec.slow_rounds - 1)
                feed.held.append(chunk)
                slow_stalls += 1
                continue
            if feed.held:
                chunk = np.concatenate([*feed.held, chunk])
                feed.held = []
            enqueued += target.push(sid, chunk)
            delivered += len(chunk)
        for sid in step["disconnect"]:
            feed = feeds.pop(sid)
            if feed.held:
                # the uplink flushes on hangup: held chunks arrive
                # before the goodbye, never silently vanish
                payload = np.concatenate(feed.held)
                enqueued += target.push(sid, payload)
                delivered += len(payload)
            order.remove(sid)
            disconnects += 1
        if on_round is not None:
            # fired after the round's deliveries but BEFORE the poll
            # and the disconnect settle: a capacity controller reads
            # the true backlog (either would drain it) and its staged
            # resize applies to this very poll's dispatches.  Any
            # events the hook returns (a controller's pre-retire
            # cluster drain) fold in here.
            extra = on_round(target, r)
            if extra:
                events.extend(extra)
        events.extend(target.poll())
        if step["disconnect"]:
            # the goodbyes land AFTER the regular poll, as one batch:
            # the leavers' grid windows scored with normal coalescing
            # above, so the settle's forced poll drains only their
            # flushed partials — one drain per round, not per session
            events.extend(target.disconnect_sessions(step["disconnect"]))
        if clock is not None and hasattr(clock, "advance"):
            clock.advance(round_dt)
    events.extend(target.flush())
    report = TraceReport(
        rounds=len(trace.schedule),
        connects=connects,
        disconnects=disconnects,
        storm_disconnects=trace.storm_disconnects,
        peak_active=trace.peak_active,
        trough_active=trace.trough_active,
        slow_stalls=slow_stalls,
        samples_delivered=delivered,
        windows_enqueued=enqueued,
        duration_s=round(time.perf_counter() - t0, 4),
    )
    return events, report
