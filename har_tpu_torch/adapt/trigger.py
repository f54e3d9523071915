"""Fleet-level drift aggregation → debounced retrain trigger.

Per-session ``DriftMonitor``s (har_tpu_torch.monitoring) answer "is THIS
stream out of distribution" — the wrong altitude for a retrain decision:
one wearer re-mounting a sensor is personalization, not population
drift; K wearers drifting on the SAME channels inside one window is the
signal SparkNet-style periodic refresh should consume.  This module is
that escalation layer:

  ``DriftAggregator`` — consumes per-session ``DriftReport``s (usually
    straight from ``FleetServer.drift_report``), tracks which sessions
    are in an active drift episode and which channels each episode
    implicates.  De-duplication is by ``DriftReport.onset``: one episode
    alerts once, and a monitor ``reset()`` after a model swap re-arms
    cleanly (the new episode gets a new onset).  Hysteresis on recovery:
    a session leaves the drifted set only after ``recovery_patience``
    consecutive clean reports — a flapping monitor cannot strobe the
    trigger.

  ``RetrainTrigger`` — fires a ``RetrainJob`` when >= ``min_sessions``
    sessions share a drifted channel within ``window_s``, then holds a
    ``cooldown_s`` debounce (a retrain in flight must not be re-enqueued
    by the same population event).  The job carries the drifted session
    ids, the implicated channels, and a bounded ``ReplayBuffer`` sample
    of those sessions' recent windows — what the retrainer mixes into
    the seed training set.

Host-side and allocation-light like the rest of the serving stack; the
clock is injectable so every debounce is testable with a FakeClock.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Hashable, Sequence

import numpy as np


class ReplayBuffer:
    """Bounded per-session store of recent raw windows.

    The adaptation engine feeds it from the dispatch tap (every window
    the fleet actually scored is a candidate), and a fired RetrainJob
    samples the DRIFTED sessions' entries — the distribution the
    incumbent is failing on, in the proportion it is arriving.
    """

    def __init__(self, per_session: int = 32):
        if per_session <= 0:
            raise ValueError("per_session must be positive")
        self.per_session = int(per_session)
        self._buf: dict[Hashable, deque] = {}

    def add(self, session_id: Hashable, window: np.ndarray) -> None:
        buf = self._buf.get(session_id)
        if buf is None:
            buf = self._buf[session_id] = deque(maxlen=self.per_session)
        # COPY, never a view: the dispatch tap hands this buffer views
        # of the engine's pooled staging slabs (the fused hot loop
        # recycles a slab as soon as its ticket retires) — storing the
        # view would let a later dispatch overwrite retained replay data
        buf.append(np.array(window, np.float32, copy=True))

    def add_batch(
        self, session_ids: Sequence[Hashable], windows: np.ndarray
    ) -> None:
        for sid, win in zip(session_ids, windows):
            self.add(sid, win)

    def sample(
        self,
        session_ids: Sequence[Hashable] | None = None,
        max_windows: int = 512,
    ) -> np.ndarray | None:
        """Windows from the named sessions (all sessions when None),
        capped at ``max_windows``; None when empty.  The cap is taken
        ROUND-ROBIN across sessions, newest first within each — a drift
        event spanning more sessions than the cap covers still samples
        every session instead of exhausting the budget on the first
        few."""
        sids = list(self._buf) if session_ids is None else list(session_ids)
        queues = [
            list(reversed(self._buf[sid]))
            for sid in sids
            if self._buf.get(sid)
        ]
        out: list[np.ndarray] = []
        max_windows = int(max_windows)
        while queues and len(out) < max_windows:
            still = []
            for q in queues:
                out.append(q.pop(0))
                if len(out) >= max_windows:
                    break
                if q:
                    still.append(q)
            queues = still
        if not out:
            return None
        return np.stack(out)

    def __len__(self) -> int:
        return sum(len(b) for b in self._buf.values())


@dataclasses.dataclass(frozen=True)
class RetrainJob:
    """One fired trigger: everything a retrainer needs to act."""

    job_id: int
    created_at: float  # trigger clock seconds
    session_ids: tuple  # the drifted sessions behind the escalation
    channels: tuple[int, ...]  # shared drifted channel indices
    replay: np.ndarray | None  # (n, T, C) drifted-session windows
    reason: str


@dataclasses.dataclass(frozen=True)
class TriggerConfig:
    """Escalation thresholds and debounce for the retrain trigger."""

    # fleet escalation: this many sessions drifting on a COMMON channel
    min_sessions: int = 3
    # ... with their latest drift evidence inside this window
    window_s: float = 120.0
    # refractory period after a fired job: the same population event
    # must not enqueue a second retrain while the first is in flight
    cooldown_s: float = 600.0
    # consecutive clean reports before a session leaves the drifted set
    # (hysteresis — the exit threshold is stickier than the entry one,
    # which DriftMonitor's own patience already debounces)
    recovery_patience: int = 3
    # per-channel thresholds for "this channel is implicated", matching
    # DriftMonitor's defaults so a drifting verdict always implicates
    # at least one channel
    z_threshold: float = 3.0
    scale_threshold: float = 0.69
    # replay windows handed to the retrainer per job
    max_replay_windows: int = 512

    def __post_init__(self):
        if self.min_sessions <= 0:
            raise ValueError("min_sessions must be positive")
        if self.recovery_patience < 1:
            raise ValueError("recovery_patience must be >= 1")


class _SessionDrift:
    """Aggregator-side view of one session's drift episode."""

    __slots__ = ("onset", "channels", "last_seen", "clean_streak",
                 "alerted_onset", "last_n", "last_gen")

    def __init__(self):
        self.onset = None
        self.channels: set[int] = set()
        self.last_seen = -float("inf")
        self.clean_streak = 0
        self.alerted_onset = None  # episode already folded into a job
        self.last_n = -1  # n_samples watermark within one generation:
        #   equality means the same stored report re-observed (stale)
        self.last_gen = None  # DriftReport.generation watermark: a
        #   change means the monitor was reset — onset indices restart
        #   with it, so the aggregator must not equate a post-reset
        #   onset with a numerically equal pre-reset one


class DriftAggregator:
    """Per-session episode tracking with onset de-duplication."""

    def __init__(
        self,
        config: TriggerConfig | None = None,
        *,
        clock: Callable[[], float] | None = None,
    ):
        self.config = config or TriggerConfig()
        self._clock = clock or time.monotonic
        self._sessions: dict[Hashable, _SessionDrift] = {}

    def observe(self, session_id: Hashable, report) -> None:
        """Absorb one session's latest DriftReport (None is a no-op)."""
        if report is None:
            return
        cfg = self.config
        st = self._sessions.get(session_id)
        if st is None:
            st = self._sessions[session_id] = _SessionDrift()
        now = self._clock()
        gen = getattr(report, "generation", 0)
        if st.last_gen is not None and gen != st.last_gen:
            # monitor reset between observations (generation bumped):
            # episode bookkeeping restarts with it — onset indices are
            # relative to the reset, even when the new n_samples lands
            # exactly on the old watermark
            st.onset = None
            st.channels = set()
            st.alerted_onset = None
            st.clean_streak = 0
        elif report.n_samples < st.last_n:
            # same fallback for generation-less reports (hand-built
            # DriftReports, foreign monitors): n restarting = a reset
            st.onset = None
            st.channels = set()
            st.alerted_onset = None
            st.clean_streak = 0
        elif report.n_samples == st.last_n and st.last_n >= 0:
            # the SAME stored report re-observed (the engine's step()
            # can run at any cadence over FleetServer.drift_report): no
            # new evidence — re-counting it would defeat the recovery
            # hysteresis and keep last_seen fresh on a dead stream
            return
        st.last_gen = gen
        st.last_n = report.n_samples
        if report.drifting:
            if report.onset != st.onset:
                if st.onset is None:
                    # a genuinely NEW episode (the previous one ended
                    # through the hysteresis below, or via a detected
                    # monitor reset): previous alert bookkeeping is void
                    st.alerted_onset = None
                elif st.alerted_onset == st.onset:
                    # the monitor flapped (one clean chunk cleared ITS
                    # onset) but the hysteresis says this is the SAME
                    # ongoing episode — carry the alerted mark onto the
                    # new onset so it cannot re-alert
                    st.alerted_onset = report.onset
                # channels re-derive from CURRENT evidence on any onset
                # change — an episode must not inherit the implicated
                # channels of the one it replaced
                st.channels = set()
                st.onset = report.onset
            st.clean_streak = 0
            st.last_seen = now
            z = np.asarray(report.location_z)
            r = np.abs(np.asarray(report.scale_log_ratio))
            st.channels.update(
                int(c)
                for c in np.flatnonzero(
                    (z > cfg.z_threshold) | (r > cfg.scale_threshold)
                )
            )
            if not st.channels:
                # drifting verdict but nothing currently over the
                # aggregator's thresholds (EWMA mid-decay): keep the
                # episode alive on its historically worst channel
                st.channels.add(int(report.worst_channel))
        else:
            st.clean_streak += 1
            if st.clean_streak >= cfg.recovery_patience:
                # hysteresis satisfied: the episode is over
                st.onset = None
                st.channels = set()
                st.alerted_onset = None

    def drifted(self, now: float | None = None) -> dict:
        """{session_id: channels} for sessions in an active, recent,
        not-yet-alerted episode."""
        now = self._clock() if now is None else now
        cfg = self.config
        return {
            sid: set(st.channels)
            for sid, st in self._sessions.items()
            if st.onset is not None
            and st.alerted_onset != st.onset
            and (now - st.last_seen) <= cfg.window_s
        }

    def mark_alerted(self, session_ids) -> None:
        """These sessions' CURRENT episodes were folded into a job —
        they must not count toward the next escalation until they
        recover and re-drift (a new onset)."""
        for sid in session_ids:
            st = self._sessions.get(sid)
            if st is not None:
                st.alerted_onset = st.onset

    def unmark_alerted(self, session_ids) -> None:
        """Undo mark_alerted for still-active episodes — the job their
        alert fed FAILED (retrain error), so a persistent episode must
        be allowed to fire again once the cooldown passes."""
        for sid in session_ids:
            st = self._sessions.get(sid)
            if st is not None and st.onset is not None:
                st.alerted_onset = None

    def reset(self) -> None:
        """Drop all episode state (the adaptation engine calls this
        alongside FleetServer.reset_monitors after a swap/rollback:
        every monitor restarted, so every tracked episode is void)."""
        self._sessions.clear()


class RetrainTrigger:
    """DriftAggregator + escalation rule + cooldown → RetrainJob queue."""

    def __init__(
        self,
        config: TriggerConfig | None = None,
        *,
        replay: ReplayBuffer | None = None,
        clock: Callable[[], float] | None = None,
    ):
        self.config = config or TriggerConfig()
        self.replay = replay if replay is not None else ReplayBuffer()
        self._clock = clock or time.monotonic
        self.aggregator = DriftAggregator(self.config, clock=self._clock)
        self._last_fired = -float("inf")
        self._n_jobs = 0

    def observe(self, session_id: Hashable, report) -> None:
        self.aggregator.observe(session_id, report)

    def observe_server(self, server) -> None:
        """Pull every session's latest drift report from a FleetServer
        (sessions without monitors report None and are skipped)."""
        for sid in server.sessions:
            self.observe(sid, server.drift_report(sid))

    def observe_workers(self, servers) -> None:
        """Fleet-GLOBAL escalation across worker partitions (the
        cluster control plane, har_tpu_torch.serve.cluster): pull every
        partition's latest reports into the ONE aggregator, so K
        sessions drifting on a common channel fire the trigger no
        matter how the router spread them across workers — the same
        population event that would be invisible to K per-worker
        triggers each seeing fewer than ``min_sessions`` of it.
        Session ids must be cluster-unique (the router guarantees it:
        a session lives on exactly one worker)."""
        for server in servers:
            self.observe_server(server)

    def hold(self) -> None:
        """Restart the cooldown without firing — called after a swap or
        rollback so the population event that just resolved cannot
        immediately enqueue another retrain."""
        self._last_fired = self._clock()

    def reopen(self, job: RetrainJob) -> None:
        """A fired job failed before producing a candidate: re-arm its
        sessions' episodes so a PERSISTENT drift fires again after the
        cooldown (the cooldown itself stays — a failing retrainer must
        not be hammered)."""
        self.aggregator.unmark_alerted(job.session_ids)

    def poll(self) -> RetrainJob | None:
        """Fire a RetrainJob when the escalation rule holds and the
        cooldown has passed; None otherwise."""
        cfg = self.config
        now = self._clock()
        if (now - self._last_fired) < cfg.cooldown_s:
            return None
        drifted = self.aggregator.drifted(now)
        if len(drifted) < cfg.min_sessions:
            return None
        # the COMMON-channel rule: population drift means the same
        # physical channel moved for many wearers (a gain change, a
        # firmware update), not K unrelated personal anomalies
        counts: dict[int, int] = {}
        for channels in drifted.values():
            for c in channels:
                counts[c] = counts.get(c, 0) + 1
        shared = sorted(c for c, n in counts.items() if n >= cfg.min_sessions)
        if not shared:
            return None
        sessions = tuple(
            sid
            for sid, channels in drifted.items()
            if channels & set(shared)
        )
        self.aggregator.mark_alerted(sessions)
        self._last_fired = now
        self._n_jobs += 1
        return RetrainJob(
            job_id=self._n_jobs,
            created_at=now,
            session_ids=sessions,
            channels=tuple(shared),
            replay=self.replay.sample(
                sessions, max_windows=cfg.max_replay_windows
            ),
            reason=(
                f"{len(sessions)} sessions drifted on channel(s) "
                f"{list(shared)} within {cfg.window_s:.0f}s"
            ),
        )
