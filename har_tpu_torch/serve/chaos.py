"""Deterministic kill-point chaos harness for the fleet durability
layer — enumerate every stage boundary a process can die at, kill
there, recover, and prove the contract instead of hoping at it.

The crash model is honest about what a SIGKILL leaves behind: the
engine and the adaptation controller call ``journal.chaos_point(name)``
at each stage boundary; a ``KillPlan`` installed as the journal's chaos
hook raises ``SimulatedCrash`` at the chosen occurrence of the chosen
point, the harness abandons the server object (all process memory
gone) and calls ``FleetJournal.kill()`` — which discards the un-flushed
buffer, exactly the bytes the kernel would have lost.  Recovery then
runs the real ``FleetServer.restore`` path against whatever the
directory actually holds.

Kill points (KILL_POINTS), in pipeline order::

    post_enqueue        windows queued, push record possibly un-flushed
    pre_dispatch        queue populated, nothing scored
    mid_dispatch        batch popped from the queue, not yet launched
    mid_launch          batch launched on-device (ticket in flight),
                        nothing fetched, nothing acked
    pre_retire          ticket about to be retired: device result may
                        exist, acks not yet written
    post_score_pre_ack  scores computed, acks not yet journaled
    mid_snapshot        snapshot tmp written, rename not yet done
    mid_swap            swap applied in memory, record not yet durable
    mid_resize          elastic resize applied in memory (target_batch /
                        pipeline_depth / mesh), record not yet durable —
                        recovery serves the pre-resize capacity and the
                        controller re-issues
    mid_promote         registry promoted, fleet swap not yet applied
    mid_rollback        registry rolled back, swap-back not yet applied

The two launch/retire points exist because pipelining moved the ack
boundary: a ticket in flight at crash time is un-acked BY CONSTRUCTION,
so both points must recover exactly like pre_dispatch — the popped
windows re-derive from replayed pushes and are re-scored.  The matrix
runs at pipeline_depth 1 AND 2 in full, the ticket-centric points
additionally at ring depths 3 and 4, and the randomized property test
draws depth from {1, 2, 3, 4} (all test-pinned): depth must never
change what a crash can lose.

The verdict of every point is the same three-part contract
(test-pinned in tests/test_recovery.py, sampled by the release gate's
``recovery_smoke``):

  1. accounting — ``enqueued == scored + dropped + pending +
     lost_in_crash`` in the recovered fleet, per version and in total;
  2. zero double-scoring — no (session, t_index) event is delivered
     twice across the crash;
  3. bit-identical continuation — the union of pre-crash and
     post-recovery events equals an uninterrupted run's event stream
     exactly (decision fields), because the harness's transport
     re-delivers un-journaled samples from the recovered watermark.

Port of ``har_tpu/serve/chaos.py``: ``run_kill_point`` and
``run_engine_kill_point`` take ``device=`` to run behind the device
dispatch plane, and ``mesh=`` behind a serving mesh.
``ENGINE_KILL_POINTS`` drive the adaptation engine (har_tpu_torch.adapt);
``run_cluster_kill_point`` kills one worker of a ``FleetCluster`` (or its
controller, ``CLUSTER_KILL_POINTS``), with or without a warm standby;
``run_tail_kill_point`` kills the replication tail (``TAIL_KILL_POINTS``).
The ship and gateway matrices run over the wire (``serve/net/chaos.py``).
"""

from __future__ import annotations

import dataclasses
import tempfile
import time

import numpy as np

from har_tpu_torch.serve.engine import FleetConfig, FleetServer
from har_tpu_torch.serve.faults import DispatchFaults, FakeClock
from har_tpu_torch.serve.journal import FleetJournal, JournalConfig
from har_tpu_torch.serve.loadgen import AnalyticDemoModel

KILL_POINTS = (
    "post_enqueue",
    "pre_dispatch",
    "mid_dispatch",
    "mid_launch",
    "pre_retire",
    "post_score_pre_ack",
    "mid_snapshot",
    "mid_swap",
    "mid_resize",
)
# the adaptation controller's stage boundaries (registry promoted or
# rolled back, fleet swap not yet applied): run_engine_kill_point
ENGINE_KILL_POINTS = ("mid_promote", "mid_rollback")
# the cluster control plane's migration stage boundaries
# (har_tpu_torch.serve.cluster.controller): after a session's adopt is
# durable on the target but before the source's eviction record
# (mid_handoff — the dual-ownership window), and between per-session
# hand-offs of a failover (mid_migration — the partially-migrated
# partition).  Killed on the CLUSTER's chaos hook: the controller dies,
# the surviving worker processes do not.
CLUSTER_KILL_POINTS = ("mid_handoff", "mid_migration")
# the journal-shipping transfer's stage boundaries (shared-nothing
# failover, har_tpu_torch.serve.net.ship): the SENDING host's agent dies
# mid-transfer (mid_ship_send — a real os._exit inside the agent
# process; the restarted agent must serve the resume from the last
# durable chunk), the RECEIVING controller dies between chunks
# (mid_ship_recv — the takeover controller resumes the staged
# transfer), and the controller dies after the verified ship lands but
# before the restored engine drains (post_ship_pre_drain — the
# takeover finds a complete staged copy and finishes).  Run in the
# wire matrix (net/chaos.py) with every worker journal in a private,
# non-shared directory.
SHIP_KILL_POINTS = (
    "mid_ship_send",
    "mid_ship_recv",
    "post_ship_pre_drain",
)
# the continuous-replication tail's stage boundaries
# (har_tpu_torch.serve.net.tail, run by run_tail_kill_point with a warm
# standby attached to a live journaled worker): the STANDBY dies
# between chunk pulls mid-tail (mid_tail_recv — its replacement resumes
# from the durable ship.log without re-pulling one already-durable
# byte), the standby dies at the re-manifest boundary while the source
# worker snapshots/rotates under the tail (mid_tail_remanifest — the
# resumed tail adopts the new file set cleanly), and the failover
# finalizer dies after every whole-file digest verifies but before
# ship_done lands (post_tail_verify — the retried finalize re-verifies
# already-local bytes and pulls zero, over a tail the worker's death
# left PARTIAL: failover drains the missing suffix, not the journal).
TAIL_KILL_POINTS = (
    "mid_tail_recv",
    "mid_tail_remanifest",
    "post_tail_verify",
)
# the ingest gateway pair's stage boundaries (har_tpu_torch.serve.net.gateway,
# run by run_gateway_kill_point with two elected gateways in front of
# live workers): the ACTIVE gateway dies while a push frame's header is
# being judged (mid_frame_recv — the client's frame is unacked and
# ambiguous; the re-send to the new leader dedups by watermark), it
# dies after admission said yes but before the chunks reach the workers
# (post_accept_pre_forward — admitted-but-undelivered, the worst
# ambiguity window), and it dies inside a graceful drain after marking
# itself draining but before the early lease release lands
# (mid_lease_handoff — the peer must still win by waiting out the
# un-released lease).  Every cell demands windows_lost == 0 and a
# scored event stream bit-identical to the un-killed run.
GATEWAY_KILL_POINTS = (
    "mid_frame_recv",
    "post_accept_pre_forward",
    "mid_lease_handoff",
)
# the failure modes only a REAL link has (har_tpu_torch.serve.net.chaos —
# run over subprocess workers on loopback TCP): a slow link and a
# blackholed probe must NOT be failovers, a duplicated delivery must
# not double-score, and a split brain resolves by the `handoffs`
# generation.  Declared here beside the kill points so the full chaos
# surface reads from one module; the runners live in net/chaos.py
# (they need the transport, which imports this module).
NET_PARTITION_CASES = (
    "slow_link",
    "dropped_probe",
    "duplicate",
    "split_brain",
)

# occurrence of each point the matrix kills at by default — calibrated
# so every kill lands mid-run (some windows acked, some pending, the
# swap schedule still ahead or just behind; for the cluster points,
# at least one session already handed off when the controller dies)
_DEFAULT_AT = {
    "post_enqueue": 12,
    "pre_dispatch": 3,
    "mid_dispatch": 2,
    "mid_launch": 2,
    "pre_retire": 2,
    "post_score_pre_ack": 2,
    "mid_snapshot": 1,
    "mid_swap": 1,
    "mid_resize": 1,
    # the adaptation loop reaches each registry transition once a run
    "mid_promote": 1,
    "mid_rollback": 1,
    "mid_handoff": 1,
    "mid_migration": 2,
    # ship-axis occurrences: the chunk counts are calibrated against
    # the matrix's small ship_chunk_bytes so both kills land genuinely
    # MID-transfer (durable progress exists, the transfer is unfinished)
    "mid_ship_send": 3,
    "mid_ship_recv": 3,
    "post_ship_pre_drain": 1,
    # tail-axis occurrences: the second chunk pull of a cycle (durable
    # progress exists, the pass is unfinished), the first re-manifest
    # boundary, and the first finalize verify window
    "mid_tail_recv": 2,
    "mid_tail_remanifest": 1,
    "post_tail_verify": 1,
    # gateway-axis occurrences: a mid-run frame receipt (rounds already
    # delivered, more coming), the second admitted-but-unforwarded
    # window, and the first drain hand-off
    "mid_frame_recv": 3,
    "post_accept_pre_forward": 2,
    "mid_lease_handoff": 1,
}


class SimulatedCrash(Exception):
    """Raised by a KillPlan at its chosen stage boundary."""


@dataclasses.dataclass
class KillPlan:
    """Journal chaos hook: crash at the ``at``-th hit of ``point``."""

    point: str
    at: int = 1
    hits: int = 0
    fired: bool = False

    def __call__(self, point: str) -> None:
        if point != self.point:
            return
        self.hits += 1
        if self.hits == self.at:
            self.fired = True
            raise SimulatedCrash(self.point)


def _recordings(n_sessions: int, n_samples: int, channels: int, seed: int):
    rng = np.random.default_rng((seed, 0xC4A5))
    return [
        rng.normal(size=(n_samples, channels)).astype(np.float32)
        for _ in range(n_sessions)
    ]


def _event_key(fe):
    return (fe.session_id, fe.event.t_index)


def _event_fields(fe):
    ev = fe.event
    return (
        ev.t_index, ev.label, ev.raw_label, ev.drift,
        ev.probability.tobytes(),
    )


def _deliver(server, recordings, cursors, upto, hop, clock, events,
             on_round=None):
    """Round-robin hop-aligned delivery until every cursor reaches
    min(upto, len(recording)); force-poll after each round.  Resuming
    from arbitrary per-session watermarks re-aligns to the hop grid, so
    an interrupted schedule continues exactly where it died.
    ``on_round()`` fires after each round's poll — the tail kill cells
    interleave standby cycles there."""
    while True:
        active = False
        for i, rec in enumerate(recordings):
            stop = min(upto, len(rec))
            if cursors[i] >= stop:
                continue
            active = True
            take = hop - (cursors[i] % hop) or hop
            chunk = rec[cursors[i] : min(cursors[i] + take, stop)]
            cursors[i] += len(chunk)
            server.push(i, chunk)
        if not active:
            break
        events.extend(server.poll(force=True))
        clock.advance(0.01)
        if on_round is not None:
            on_round()
    events.extend(server.flush())


def _run_schedule(server, recordings, cursors, *, hop, clock, models,
                  swap_sample, events):
    """The one delivery schedule both the reference and the crashed+
    recovered runs execute: everything up to ``swap_sample`` scores on
    model A, then the swap, then the rest — driven purely off cursor
    state so it resumes deterministically from recovered watermarks.
    ``events`` is caller-owned so delivered events survive a
    SimulatedCrash raised mid-schedule."""
    _deliver(server, recordings, cursors, swap_sample, hop, clock, events)
    if server.model_version == "A":
        # elastic resize at the same schedule point the swap fires:
        # gives mid_resize a boundary to kill at, and proves depth/
        # batch changes never move an event (scores are row-independent
        # and retire order is FIFO, so the reference run — which
        # resizes identically — stays bit-identical).  Guarded like the
        # cluster path so a crash-resume re-issue is a true no-op: a
        # recovered server already at 48 must not journal a second
        # resize record or double-count stats.resizes.
        if server.config.target_batch != 48:
            server.resize(target_batch=48)
        server.swap_model(models["B"], version="B")
    _deliver(
        server, recordings, cursors, max(map(len, recordings)), hop,
        clock, events,
    )
    return events


def run_kill_point(
    point: str,
    *,
    at: int | None = None,
    sessions: int = 8,
    seed: int = 0,
    n_samples: int = 600,
    window: int = 100,
    hop: int = 50,
    flush_every: int = 8,
    snapshot_every: int = 40,
    fsync: bool = True,
    journal_dir: str | None = None,
    pipeline_depth: int = 1,
    mesh=None,
    device=None,
) -> dict:
    """Kill a journaled fleet at one stage boundary, recover, resume,
    and return the verdict dict (``ok`` + evidence).

    ``device`` (``"cuda"`` or ``"cpu"``) runs the whole matrix behind
    the device dispatch plane: the A/B models become two
    ``JitDemoModel``s on that device (the analytic pair has no device
    program).  None keeps the analytic pair on the host.  ``mesh`` (a
    ``parallel.mesh.ServingMesh``) runs the matrix behind a mesh-backed
    dispatch plane — a 2D ``(dp, tp)`` mesh serves through
    ``ModelParallelScorer`` — with the demo pair on the mesh's first
    device (``device`` defaults to it), and recovery re-places the
    weights through the SAME table: placement is a runtime resource like
    the mesh, never journaled.

    Runs under the FakeClock + DispatchFaults harness (periodic
    injected stalls on the fake clock: the fault plumbing is live, the
    scores stay deterministic), with a mid-run hot swap in the schedule
    so swap-adjacent kill points have something to interrupt.

    ``pipeline_depth > 1`` runs the same matrix with tickets genuinely
    in flight at the kill instant — the conservation law and the
    bit-identical-continuation contract must hold unchanged, because a
    ticket in flight is un-acked by construction.
    """
    if mesh is not None and device is None:
        device = mesh.devices.flat[0]
    if point in ENGINE_KILL_POINTS:
        return run_engine_kill_point(
            point, at=at, sessions=sessions, seed=seed,
            journal_dir=journal_dir, pipeline_depth=pipeline_depth,
            device=device, mesh=mesh,
        )
    if point not in KILL_POINTS:
        raise ValueError(f"unknown kill point {point!r}")
    at = _DEFAULT_AT[point] if at is None else at
    recordings = _recordings(sessions, n_samples, 3, seed)
    if device is None:
        models = {
            "A": AnalyticDemoModel(), "B": AnalyticDemoModel(tau=5.0),
        }
    else:
        # device dispatch plane: the analytic pair is host-only, so the
        # A/B swap serves two demo MLPs on the device instead
        from har_tpu_torch.serve.loadgen import JitDemoModel

        models = {
            "A": JitDemoModel(window=window, channels=3, seed=1729,
                              device=device),
            "B": JitDemoModel(window=window, channels=3, seed=5,
                              device=device),
        }
    swap_sample = (n_samples // hop // 2) * hop  # mid-recording
    config = FleetConfig(
        max_sessions=sessions, target_batch=32, max_delay_ms=0.0,
        retries=1, pipeline_depth=pipeline_depth,
    )

    def build(clock, journal):
        server = FleetServer(
            models["A"], window=window, hop=hop, channels=3,
            smoothing="ema", config=config,
            fault_hook=DispatchFaults(
                stall_every=3, stall_ms=1.0, fake_clock=clock
            ),
            clock=clock, model_version="A", journal=journal, mesh=mesh,
        )
        for i in range(sessions):
            server.add_session(i)
        return server

    # ---- reference: the uninterrupted run --------------------------------
    ref_clock = FakeClock()
    ref_server = build(ref_clock, None)
    ref_events: list = []
    _run_schedule(
        ref_server, recordings, [0] * sessions, hop=hop, clock=ref_clock,
        models=models, swap_sample=swap_sample, events=ref_events,
    )

    # ---- crashed run -----------------------------------------------------
    tmp = None
    if journal_dir is None:
        tmp = journal_dir = tempfile.mkdtemp(prefix="har_chaos_")
    try:
        journal = FleetJournal(
            journal_dir,
            JournalConfig(
                flush_every=flush_every, snapshot_every=snapshot_every,
                fsync=fsync,
            ),
        )
        clock = FakeClock()
        server = build(clock, journal)
        # armed only after construction: the attach-time snapshot is
        # part of setup, not of the schedule under chaos
        plan = KillPlan(point, at)
        journal.chaos = plan
        pre_events: list = []
        cursors = [0] * sessions
        try:
            _run_schedule(
                server, recordings, cursors, hop=hop, clock=clock,
                models=models, swap_sample=swap_sample, events=pre_events,
            )
            journal.close()
            return {
                "ok": False, "point": point,
                "why": f"kill point {point!r} never fired (at={at})",
                "windows_lost": 0, "recovery_ms": 0.0,
            }
        except SimulatedCrash:
            # SIGKILL: process memory gone, un-flushed journal bytes
            # gone; only `pre_events` (already delivered to the
            # consumer before the crash) and the disk survive
            journal.kill()

        # ---- recovery ----------------------------------------------------
        t0 = time.perf_counter()
        clock2 = FakeClock(clock.t)
        restored = FleetServer.restore(
            journal_dir,
            lambda ver: models[ver],
            clock=clock2,
            fault_hook=DispatchFaults(
                stall_every=3, stall_ms=1.0, fake_clock=clock2
            ),
            mesh=mesh,
        )
        recovery_ms = (time.perf_counter() - t0) * 1e3

        # ---- resume: transport re-delivers from the watermark ------------
        post_events: list = []
        post_events.extend(restored.poll(force=True))  # drain recovered
        resume_cursors = [restored.watermark(i) for i in range(sessions)]
        _run_schedule(
            restored, recordings, resume_cursors, hop=hop,
            clock=clock2, models=models, swap_sample=swap_sample,
            events=post_events,
        )

        # ---- verdict -----------------------------------------------------
        return _verdict(
            point, ref_events, pre_events, post_events, restored,
            recovery_ms,
        )
    finally:
        if tmp is not None:
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)


def _verdict(point, ref_events, pre_events, post_events, restored,
             recovery_ms) -> dict:
    why = None
    combined = list(pre_events) + list(post_events)
    keys = [_event_key(e) for e in combined]
    if len(keys) != len(set(keys)):
        why = "an event was delivered twice across the crash"
    by_sid: dict = {}
    for e in combined:
        by_sid.setdefault(e.session_id, []).append(e)
    ref_by_sid: dict = {}
    for e in ref_events:
        ref_by_sid.setdefault(e.session_id, []).append(e)
    windows_lost = sum(len(v) for v in ref_by_sid.values()) - sum(
        len(v) for v in by_sid.values()
    )
    if why is None and windows_lost != 0:
        why = f"{windows_lost} window(s) lost vs the uninterrupted run"
    if why is None:
        for sid, want in ref_by_sid.items():
            got = by_sid.get(sid, [])
            if [_event_fields(e) for e in got] != [
                _event_fields(e) for e in want
            ]:
                why = (
                    f"session {sid!r} events diverge from the "
                    "uninterrupted run"
                )
                break
    acct = restored.stats.accounting()
    if why is None and not (
        acct["balanced"] and acct["pending"] == 0 and acct["dropped"] == 0
    ):
        why = f"accounting violated after recovery: {acct}"
    if why is None and restored.stats.recoveries != 1:
        why = f"recoveries counter is {restored.stats.recoveries}, not 1"
    return {
        "ok": why is None,
        "point": point,
        "why": why,
        "windows_lost": max(windows_lost, 0),
        "delivered_pre_crash": len(pre_events),
        "delivered_post_recovery": len(post_events),
        "recovery_ms": round(recovery_ms, 3),
        "accounting": acct,
    }


def run_random_kill(seed: int, mesh=None, device=None) -> dict:
    """Seed-randomized kill-point draw for the property test: point,
    occurrence, flush batching, snapshot cadence AND pipeline depth all
    vary — the recovery contract must hold for every combination.  The
    depth draw spans the full ticket ring {1, 2, 3, 4}: at depth >= 3
    several tickets are genuinely in flight at the kill instant, and
    every one of them must recover as ordinary un-acked pending.
    ``device`` and ``mesh`` run the draw behind the device dispatch
    plane or a mesh (see `run_kill_point`)."""
    rng = np.random.default_rng((seed, 0xDEAD))
    point = KILL_POINTS[int(rng.integers(len(KILL_POINTS)))]
    at = _DEFAULT_AT[point] + int(rng.integers(0, 3))
    out = run_kill_point(
        point,
        at=at,
        sessions=int(rng.integers(3, 9)),
        seed=seed,
        flush_every=int(rng.choice([1, 4, 16, 64])),
        snapshot_every=int(rng.choice([0, 10, 30])),
        pipeline_depth=int(rng.choice([1, 2, 3, 4])),
        mesh=mesh, device=device,
    )
    out["seed"] = seed
    if not out["ok"] and "never fired" in (out["why"] or ""):
        # a tiny random fleet may finish before a late occurrence; that
        # is a harness-calibration miss, not a durability failure —
        # retry at the first occurrence so every seed tests recovery
        out = run_kill_point(point, at=1, sessions=4, seed=seed, mesh=mesh,
                             device=device)
        out["seed"] = seed
    return out



def run_engine_kill_point(
    point: str, *, at: int | None = None, sessions: int = 8, seed: int = 0,
    journal_dir: str | None = None, pipeline_depth: int = 1,
    device=None, mesh=None,
) -> dict:
    """Kill inside the adaptation controller's registry transitions —
    after ``registry.promote`` but before the fleet swap applies
    (``mid_promote``), or after ``registry.rollback`` but before the
    swap-back (``mid_rollback``) — then recover and prove the
    half-finished transition completes cleanly: the recovered fleet
    serves exactly the registry's CURRENT version, with accounting
    intact.  ``device`` serves the transition behind the device
    dispatch plane: two ``JitDemoModel``s on that device, independently
    seeded, so both agreement gates are off (the shadow gate, as the
    JAX package's mesh run has it, and probation's reverse-shadow
    floor, which such a pair would breach as soon as 16 windows are
    scored): the matrix tests the journaled transition, not candidate
    quality.  ``mesh`` serves it behind a mesh, as in `run_kill_point`."""
    import shutil

    from har_tpu_torch.adapt.registry import ModelRegistry
    from har_tpu_torch.adapt.shadow import ShadowConfig
    from har_tpu_torch.adapt.swap import AdaptationConfig, AdaptationEngine
    from har_tpu_torch.adapt.trigger import TriggerConfig
    from har_tpu_torch.monitoring import DriftMonitor

    if point not in ENGINE_KILL_POINTS:
        raise ValueError(f"unknown engine kill point {point!r}")
    if mesh is not None and device is None:
        device = mesh.devices.flat[0]
    at = _DEFAULT_AT[point] if at is None else at
    tmp = None
    if journal_dir is None:
        tmp = journal_dir = tempfile.mkdtemp(prefix="har_chaos_adapt_")
    reg_root = journal_dir + ".registry"
    try:
        clock = FakeClock()
        journal = FleetJournal(
            journal_dir, JournalConfig(flush_every=8, snapshot_every=0)
        )
        if device is None:
            incumbent = AnalyticDemoModel()
            candidate = AnalyticDemoModel(tau=5.0)
        else:
            from har_tpu_torch.serve.loadgen import JitDemoModel

            incumbent = JitDemoModel(window=100, channels=3, seed=1729,
                                     device=device)
            candidate = JitDemoModel(window=100, channels=3, seed=5,
                                     device=device)
        models: dict = {}

        def adaptation(server, registry, clk, **kw):
            return AdaptationEngine(
                server, registry, lambda job: candidate,
                config=AdaptationConfig(
                    probation_dispatches=3, max_shadow_dispatches=8,
                    probation_min_agreement=0.95 if device is None else 0.0,
                ),
                trigger_config=TriggerConfig(
                    min_sessions=2, window_s=1e9, cooldown_s=1e9,
                    recovery_patience=1,
                ),
                shadow_config=ShadowConfig(
                    sample_every=1, min_windows=4,
                    min_agreement=0.98 if device is None else 0.0,
                ),
                clock=clk, **kw,
            )

        # post-swap dispatch failures force the probation regression
        # that reaches the rollback path
        faults = DispatchFaults(fake_clock=clock)
        server = FleetServer(
            incumbent, window=100, hop=100, channels=3, smoothing="none",
            config=FleetConfig(
                max_sessions=sessions, max_delay_ms=0.0, retries=0,
                pipeline_depth=pipeline_depth,
            ),
            clock=clock, fault_hook=faults, journal=journal, mesh=mesh,
        )
        rng = np.random.default_rng((seed, 77))
        recs = [
            rng.normal(size=(1200, 3)).astype(np.float32)
            for _ in range(sessions)
        ]
        for i in range(sessions):
            server.add_session(
                i,
                monitor=DriftMonitor(
                    np.zeros(3), np.ones(3), halflife=50.0, patience=2
                ),
            )
        engine = adaptation(server, ModelRegistry(reg_root, clock=clock),
                            clock)
        models[server.model_version] = incumbent
        # armed only after setup (attach snapshot + bootstrap register)
        journal.chaos = KillPlan(point, at)

        def loader(ver: str):
            if ver not in models:
                # the candidate registers as the next version id
                models[ver] = candidate
            return models[ver]

        crashed = False
        try:
            for rnd in range(10):
                for i in range(sessions):
                    chunk = recs[i][rnd * 100 : (rnd + 1) * 100]
                    if i < sessions // 2 and rnd >= 1:
                        chunk = chunk + 25.0  # population re-mount
                    server.push(i, chunk)
                server.poll(force=True)
                if (
                    point == "mid_rollback"
                    and engine.state == "probation"
                ):
                    faults.fail_every = 1  # regression: every dispatch dies
                engine.step()
                clock.advance(1.0)
        except SimulatedCrash:
            crashed = True
            journal.kill()
        if not crashed:
            journal.close()
            return {
                "ok": False, "point": point,
                "why": f"kill point {point!r} never fired (at={at})",
                "windows_lost": 0, "recovery_ms": 0.0,
            }

        # ---- recovery ----------------------------------------------------
        t0 = time.perf_counter()
        clock2 = FakeClock(clock.t)
        restored = FleetServer.restore(journal_dir, loader, clock=clock2,
                                       mesh=mesh)
        registry2 = ModelRegistry(reg_root, clock=clock2)
        engine2 = adaptation(restored, registry2, clock2, resume=True,
                             loader=loader)
        recovery_ms = (time.perf_counter() - t0) * 1e3

        # resume a few clean rounds (faults off: probation must close)
        restored.poll(force=True)
        cursors = [restored.watermark(i) for i in range(sessions)]
        for rnd in range(3):
            for i in range(sessions):
                chunk = recs[i][cursors[i] : cursors[i] + 100]
                cursors[i] += 100
                if len(chunk):
                    restored.push(i, chunk)
            restored.poll(force=True)
            engine2.step()
            clock2.advance(1.0)
        restored.flush()
        engine2.step()

        acct = restored.stats.accounting()
        cur = registry2.current()
        why = None
        if cur is None or cur.name != restored.model_version:
            why = (
                f"registry CURRENT ({None if cur is None else cur.name}) "
                f"!= serving version ({restored.model_version}) after "
                "recovery"
            )
        elif restored.model is not models[cur.name]:
            why = f"the fleet does not serve {cur.name}'s model"
        elif not acct["balanced"] or acct["pending"] != 0:
            why = f"accounting violated after recovery: {acct}"
        elif point == "mid_promote" and cur.version < 2:
            why = "mid_promote recovery did not complete the promotion"
        elif point == "mid_rollback" and cur.version != 1:
            why = "mid_rollback recovery did not land on the incumbent"
        elif engine2.state not in ("serving",):
            why = f"engine did not settle post-recovery: {engine2.state}"
        return {
            "ok": why is None,
            "point": point,
            "why": why,
            "windows_lost": 0,
            "recovery_ms": round(recovery_ms, 3),
            "serving_version": restored.model_version,
            "registry_current": cur.name if cur else None,
            "accounting": acct,
            "adapt_log": [e["event"] for e in engine2.log],
        }
    finally:
        shutil.rmtree(reg_root, ignore_errors=True)
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------
# replication-axis chaos: a warm standby tail-follows a live journaled
# worker; the standby dies mid-tail / at the re-manifest boundary, or
# the finalize verifier dies over a partial tail — then the worker is
# killed and recovery runs from the STANDBY's staging directory.


def run_tail_kill_point(
    point: str,
    *,
    at: int | None = None,
    sessions: int = 6,
    seed: int = 0,
    n_samples: int = 600,
    window: int = 100,
    hop: int = 50,
    flush_every: int = 8,
    chunk_bytes: int = 1024,
) -> dict:
    """Kill the continuous-replication tail at one of its stage
    boundaries (TAIL_KILL_POINTS), resume it, kill the SOURCE worker,
    fail over from the standby's staging directory, and demand the
    same three-part contract as every other cell — plus the
    replication-specific evidence:

    - ``mid_tail_recv``: the replacement standby resumes from the
      durable ship.log; total bytes pulled across BOTH standby
      incarnations equals the source manifest exactly (zero re-pulled
      bytes), and the caught-up failover transfers zero.
    - ``mid_tail_remanifest``: the source rotates/snapshots under the
      tail; the resumed tail adopts the new file set (a durable
      ``ship_remanifest`` record lands, the warm replica re-founds on
      the new snapshot) and the caught-up failover transfers zero.
    - ``post_tail_verify``: the tail is deliberately left PARTIAL
      (cycles stop early), the first finalize pulls the missing
      suffix then dies after verification but before ``ship.done``;
      the retried finalize re-verifies already-local bytes and pulls
      zero.

    The source worker runs the ordinary journaled schedule; its death
    is ``journal.kill()`` after phase A (pending windows exist, the
    swap still ahead) — the tail axis is about the STANDBY dying, not
    the worker, so the worker's own kill points stay in KILL_POINTS.
    """
    import shutil

    from har_tpu_torch.serve.journal import read_segment_from
    from har_tpu_torch.serve.net.ship import journal_manifest
    from har_tpu_torch.serve.net.tail import LocalShipSource
    from har_tpu_torch.serve.replica import StandbyAgent

    if point not in TAIL_KILL_POINTS:
        raise ValueError(f"unknown tail kill point {point!r}")
    at = _DEFAULT_AT[point] if at is None else at
    # mid_tail_remanifest needs the source to rotate under the tail;
    # the other two pin append-only byte accounting, which wants a
    # stable file set (no prunes) — attach-time snapshot only
    snapshot_every = 40 if point == "mid_tail_remanifest" else 0
    recordings = _recordings(sessions, n_samples, 3, seed)
    models = {"A": AnalyticDemoModel(), "B": AnalyticDemoModel(tau=5.0)}
    loader = lambda ver: models[ver]  # noqa: E731
    swap_sample = (n_samples // hop // 2) * hop
    config = FleetConfig(
        max_sessions=sessions, target_batch=32, max_delay_ms=0.0,
        retries=1,
    )

    def build(clock, journal):
        server = FleetServer(
            models["A"], window=window, hop=hop, channels=3,
            smoothing="ema", config=config,
            fault_hook=DispatchFaults(
                stall_every=3, stall_ms=1.0, fake_clock=clock
            ),
            clock=clock, model_version="A", journal=journal,
        )
        for i in range(sessions):
            server.add_session(i)
        return server

    # ---- reference: the uninterrupted run --------------------------------
    ref_clock = FakeClock()
    ref_server = build(ref_clock, None)
    ref_events: list = []
    _run_schedule(
        ref_server, recordings, [0] * sessions, hop=hop, clock=ref_clock,
        models=models, swap_sample=swap_sample, events=ref_events,
    )

    td = tempfile.mkdtemp(prefix="har_chaos_tail_")
    try:
        src_root = f"{td}/src"
        src_home = f"{src_root}/w0"
        sb_root = f"{td}/sb"
        journal = FleetJournal(
            src_home,
            JournalConfig(
                flush_every=flush_every, snapshot_every=snapshot_every
            ),
        )
        clock = FakeClock()
        server = build(clock, journal)
        plan = KillPlan(point, at)
        standbys = [
            StandbyAgent(
                sb_root, {"w0": LocalShipSource(src_root)}, loader=loader,
                chunk_bytes=chunk_bytes, chaos=plan, clock=clock,
            )
        ]

        def cycle_once():
            """One standby cycle; a SimulatedCrash is the standby
            process dying — a REPLACEMENT agent (fresh memory, no
            chaos) resumes over the same staging root from the
            durable ship.log."""
            try:
                standbys[-1].cycle()
            except SimulatedCrash:
                standbys.append(
                    StandbyAgent(
                        sb_root, {"w0": LocalShipSource(src_root)},
                        loader=loader, chunk_bytes=chunk_bytes,
                        clock=clock,
                    )
                )

        rounds = {"n": 0}

        def on_round():
            rounds["n"] += 1
            if point == "post_tail_verify" and rounds["n"] > 3:
                return  # stop tailing early: the tail stays PARTIAL
            cycle_once()

        # ---- phase A: live worker under tail, then SIGKILL it ------------
        pre_events: list = []
        cursors = [0] * sessions
        _deliver(
            server, recordings, cursors, swap_sample, hop, clock,
            pre_events, on_round=on_round,
        )
        journal.kill()

        # ---- catch-up: the journal is static now; drain the tail ---------
        if point != "post_tail_verify":
            for _ in range(3):
                cycle_once()
            if not plan.fired:
                shutil.rmtree(td, ignore_errors=True)
                return {
                    "ok": False, "point": point,
                    "why": f"kill point {point!r} never fired (at={at})",
                    "windows_lost": 0, "recovery_ms": 0.0,
                }

        # ---- failover: finalize from the standby's bytes -----------------
        sb = standbys[-1]
        pre_shipped = sb.stats.shipped_bytes
        t0 = time.perf_counter()
        finalize_crashed = False
        first_bytes = 0
        try:
            fin = sb.finalize("w0")
        except SimulatedCrash:
            finalize_crashed = True
            first_bytes = sb.stats.shipped_bytes - pre_shipped
            fin = sb.finalize("w0")  # retried over already-local bytes
        failover_path_bytes = first_bytes + fin["bytes"]

        why = None
        if point == "post_tail_verify":
            if not finalize_crashed:
                why = f"kill point {point!r} never fired (at={at})"
            elif first_bytes <= 0:
                why = (
                    "the partial tail's finalize pulled no missing "
                    "suffix — the cell did not exercise the drain"
                )
            elif fin["bytes"] != 0:
                why = (
                    "retried finalize re-pulled "
                    f"{fin['bytes']} byte(s); the verify must be "
                    "idempotent over already-local bytes"
                )
        else:
            if fin["bytes"] != 0:
                why = (
                    f"caught-up failover transferred {fin['bytes']} "
                    "byte(s); a fully-tailed standby must transfer zero"
                )
        if why is None and point == "mid_tail_recv":
            # zero re-pulled bytes: every standby incarnation's pulls,
            # summed, equal the final source manifest exactly (valid
            # because snapshot_every=0 means no file was ever pruned)
            total = sum(
                e["size"] for e in journal_manifest(src_home)
            )
            pulled = sum(s.stats.shipped_bytes for s in standbys)
            if pulled != total:
                why = (
                    f"pulled {pulled} byte(s) across standby "
                    f"incarnations for a {total}-byte manifest — the "
                    "resume re-pulled already-durable bytes"
                )
        remanifests = 0
        if why is None and point == "mid_tail_remanifest":
            ship_log = f"{sb.dest('w0')}/ship.log"
            records, _ = read_segment_from(ship_log, 0)
            remanifests = sum(
                1 for meta, _p in records
                if meta.get("t") == "ship_remanifest"
            )
            replica = sb.replicas.get("w0")
            if remanifests < 1:
                why = (
                    "no durable ship_remanifest record: the tail never "
                    "crossed the rotation boundary"
                )
            elif replica is None or replica.rebuilds < 1:
                why = (
                    "the warm replica never re-founded on the rotated "
                    "snapshot"
                )
        if why is not None:
            shutil.rmtree(td, ignore_errors=True)
            return {
                "ok": False, "point": point, "why": why,
                "windows_lost": 0, "recovery_ms": 0.0,
                "failover_path_bytes": failover_path_bytes,
            }

        # ---- recovery from the STANDBY's staging directory ---------------
        clock2 = FakeClock(clock.t)
        restored = FleetServer.restore(
            sb.dest("w0"),
            loader,
            clock=clock2,
            fault_hook=DispatchFaults(
                stall_every=3, stall_ms=1.0, fake_clock=clock2
            ),
        )
        recovery_ms = (time.perf_counter() - t0) * 1e3

        post_events: list = []
        post_events.extend(restored.poll(force=True))
        resume_cursors = [restored.watermark(i) for i in range(sessions)]
        _run_schedule(
            restored, recordings, resume_cursors, hop=hop,
            clock=clock2, models=models, swap_sample=swap_sample,
            events=post_events,
        )

        out = _verdict(
            point, ref_events, pre_events, post_events, restored,
            recovery_ms,
        )
        out.update(
            failover_path_bytes=failover_path_bytes,
            standby_incarnations=len(standbys),
            finalize_resumes=fin["resumes"],
            remanifests=remanifests,
            tail_cycles=sum(s.cycles for s in standbys),
        )
        return out
    finally:
        shutil.rmtree(td, ignore_errors=True)


# ---------------------------------------------------------------------
# worker-axis chaos: kill one worker of a running cluster
# (har_tpu_torch.serve.cluster) and demand the same three-part contract
# ACROSS the failover — plus the two control-plane kill points.


def _build_cluster(root, clock, *, sessions, workers, window, hop,
                   model, flush_every, snapshot_every, loader):
    from har_tpu_torch.serve.cluster.controller import (
        ClusterConfig,
        FleetCluster,
    )

    return FleetCluster(
        model,
        root,
        workers=workers,
        window=window,
        hop=hop,
        channels=3,
        smoothing="ema",
        fleet_config=FleetConfig(
            max_sessions=sessions, target_batch=32, max_delay_ms=0.0,
            retries=1,
        ),
        # flush_every must exceed the per-poll ack volume: an ack that
        # auto-flushes mid-poll would be durable-but-undelivered if the
        # kill lands before the poll returns — a loss channel the
        # single-server matrix calibrates around and the cluster
        # harness excludes by construction
        journal_config=JournalConfig(
            flush_every=flush_every, snapshot_every=snapshot_every
        ),
        config=ClusterConfig(
            lease_s=0.2, probe_retries=3, probe_base_ms=20.0,
            probe_cap_ms=100.0,
        ),
        clock=clock,
        loader=loader,
        fault_hook_for=lambda wid: DispatchFaults(
            stall_every=3, stall_ms=1.0, fake_clock=clock
        ),
    )




def _drive_cluster(cluster, recordings, cursors, upto, hop, clock,
                   events, on_round=None, max_rounds=20000):
    """Hop-aligned round-robin delivery against a cluster, failover-
    aware: a push to an unreachable worker keeps its cursor (the
    transport re-delivers), every completed migration rewinds its
    session's cursor to the adopted watermark, and the loop keeps
    polling past the end of delivery until no session is stranded on a
    dead worker — the failure detector needs polls and clock to run.
    ``on_round(cluster)`` fires after every poll (kill scheduling and
    the every-snapshot conservation log live there)."""
    from har_tpu_torch.serve.cluster.membership import WorkerUnavailable

    # entry rewind: a takeover/migration before this drive moved
    # sessions; their durable watermark is where delivery resumes
    for i in range(len(recordings)):
        try:
            cursors[i] = cluster.watermark(i)
        except WorkerUnavailable:
            pass  # mid-failover: the migration-log rewind below lands
    seen_migrations = len(cluster.migration_log)
    for _ in range(max_rounds):
        active = False
        for i, rec in enumerate(recordings):
            stop = min(upto, len(rec))
            if cursors[i] >= stop:
                continue
            active = True
            take = hop - (cursors[i] % hop) or hop
            chunk = rec[cursors[i] : min(cursors[i] + take, stop)]
            try:
                cluster.push(i, chunk)
            except WorkerUnavailable:
                continue  # cursor kept; re-delivered post-failover
            cursors[i] += len(chunk)
        events.extend(cluster.poll(force=True))
        clock.advance(0.05)
        if on_round is not None:
            on_round(cluster)
        while seen_migrations < len(cluster.migration_log):
            sid = cluster.migration_log[seen_migrations]["sid"]
            cursors[sid] = cluster.watermark(sid)
            seen_migrations += 1
        if not active:
            stranded = any(
                cluster._workers.get(cluster.worker_of(i)) is None
                or not cluster._workers[cluster.worker_of(i)].alive
                for i in range(len(recordings))
            )
            # the migration rewind above may have re-opened cursors:
            # this phase must finish its own re-delivery BEFORE
            # returning (the schedule's next step may be a model swap
            # — delivering phase-1 windows after it would score them
            # on the wrong model and break bit-identity)
            rewound = any(
                cursors[i] < min(upto, len(recordings[i]))
                for i in range(len(recordings))
            )
            if not stranded and not rewound:
                break
    else:  # pragma: no cover - harness guard
        raise RuntimeError("cluster drive did not converge")
    events.extend(cluster.flush())
    if on_round is not None:
        on_round(cluster)


def _cluster_schedule(cluster, recordings, cursors, *, hop, clock,
                      models, swap_sample, events, on_round=None):
    """The one delivery schedule reference and crashed cluster runs
    share: deliver to ``swap_sample``, broadcast the hot swap (per-
    worker idempotent — a resumed schedule re-issues it only where it
    has not landed), deliver the rest.  Driven purely off cursor state,
    so it resumes deterministically after a kill."""
    _drive_cluster(
        cluster, recordings, cursors, swap_sample, hop, clock, events,
        on_round,
    )
    # per-worker elastic resize at the swap point — the cluster-side
    # boundary mid_resize kills at.  Guarded per worker exactly like
    # the idempotent swap broadcast: a resumed schedule re-issues it
    # only where it has not landed.
    for w in cluster._workers.values():
        if w.alive and w.server.config.target_batch != 48:
            w.server.resize(target_batch=48)
    cluster.swap_model(models["B"], version="B")
    _drive_cluster(
        cluster, recordings, cursors, max(map(len, recordings)), hop,
        clock, events, on_round,
    )


def run_cluster_kill_point(
    point: str,
    *,
    at: int | None = None,
    workers: int = 3,
    sessions: int = 12,
    seed: int = 0,
    n_samples: int = 300,
    window: int = 100,
    hop: int = 50,
    flush_every: int = 512,
    snapshot_every: int = 40,
    kill_round: int = 3,
    standby: bool = False,
) -> dict:
    """Kill one worker of an N-worker cluster at a stage boundary (any
    of the engine KILL_POINTS, fired inside the victim's own journal
    hook) or kill the CONTROLLER inside the migration machinery
    (CLUSTER_KILL_POINTS), then let failover / takeover finish the job
    and demand the cross-worker contract:

      1. zero double-scored — no (session, t_index) event delivered
         twice across the kill, no matter which worker scored it;
      2. migrated streams bit-identical — every session's combined
         event stream equals the un-killed cluster run's, decision
         fields exact;
      3. global conservation — ``enqueued == scored + dropped +
         pending + lost_in_crash`` summed over live workers + the
         retired ledger, balanced in EVERY accounting snapshot and
         drained to pending 0 at the end, with zero windows lost (the
         transport re-delivers from the adopted watermarks).

    Worker-axis kills leave the controller alive (failover path);
    cluster-point kills model a controller loss mid-migration — the
    worker processes survive and ``FleetCluster.takeover`` adopts
    them, completing the orphaned failover idempotently.

    ``standby=True`` runs the SAME matrix with a warm standby
    registered on the crashed cluster (the reference run never has
    one — a standby must not change one delivered byte): the standby
    tail-follows every worker from the controller's poll loop, and the
    verdict additionally demands that the failover sourced the
    partition from the standby (``standby_fetches >= 1``) over a
    zero-byte failover path (``failover_path_bytes == 0`` — the tail
    was caught up, so finalize moved nothing).
    """
    import os
    import shutil

    if point not in KILL_POINTS and point not in CLUSTER_KILL_POINTS:
        raise ValueError(f"unknown cluster kill point {point!r}")
    at = _DEFAULT_AT[point] if at is None else at
    recordings = _recordings(sessions, n_samples, 3, seed)
    models = {"A": AnalyticDemoModel(), "B": AnalyticDemoModel(tau=5.0)}

    def loader(ver):
        return models.get(ver, models["A"])

    swap_sample = (n_samples // hop // 2) * hop
    build_kwargs = dict(
        sessions=sessions, workers=workers, window=window, hop=hop,
        flush_every=flush_every, snapshot_every=snapshot_every,
        loader=loader,
    )

    # ---- reference: the un-killed cluster run -----------------------
    ref_root = tempfile.mkdtemp(prefix="har_cluster_ref_")
    try:
        ref_clock = FakeClock()
        ref = _build_cluster(
            ref_root, ref_clock, model=models["A"], **build_kwargs
        )
        for i in range(sessions):
            ref.add_session(i)
        ref_events: list = []
        _cluster_schedule(
            ref, recordings, [0] * sessions, hop=hop, clock=ref_clock,
            models=models, swap_sample=swap_sample, events=ref_events,
        )
        ref.close()
    finally:
        shutil.rmtree(ref_root, ignore_errors=True)

    # ---- crashed run ------------------------------------------------
    root = tempfile.mkdtemp(prefix="har_cluster_chaos_")
    try:
        clock = FakeClock()
        cluster = _build_cluster(
            root, clock, model=models["A"], **build_kwargs
        )
        for i in range(sessions):
            cluster.add_session(i)
        if standby:
            from har_tpu_torch.serve.net.tail import LocalShipSource
            from har_tpu_torch.serve.replica import StandbyAgent

            cluster.register_standby(
                StandbyAgent(
                    os.path.join(root, "_replica"),
                    {
                        wid: LocalShipSource(root)
                        for wid in cluster._workers
                    },
                    loader=loader,
                )
            )
        victim = cluster.worker_of(0)
        plan = KillPlan(point, at)
        if point in CLUSTER_KILL_POINTS:
            # controller kill mid-migration: the victim worker is
            # SIGKILLed outright partway through delivery; the plan
            # then fires inside the resulting failover's hand-offs
            cluster.chaos = plan
        else:
            cluster._workers[victim].server.journal.chaos = plan
        events: list = []
        cursors = [0] * sessions
        balance_log: list = []
        rounds = {"n": 0}

        def on_round(c):
            rounds["n"] += 1
            if (
                point in CLUSTER_KILL_POINTS
                and rounds["n"] == kill_round
            ):
                c._workers[victim].kill()
            balance_log.append(c.accounting())

        crashed = False
        try:
            _cluster_schedule(
                cluster, recordings, cursors, hop=hop, clock=clock,
                models=models, swap_sample=swap_sample, events=events,
                on_round=on_round,
            )
        except SimulatedCrash:
            crashed = True
        # standby accounting up to the crash instant: a CLUSTER-point
        # kill lands mid-handoff, AFTER the fetch — the counters live
        # on the controller object the takeover replaces
        pre_fpb = cluster.failover_path_bytes
        pre_sf = cluster.standby_fetches
        if not crashed:
            cluster.close()
            return {
                "ok": False, "point": point,
                "why": f"kill point {point!r} never fired (at={at})",
                "windows_lost": 0, "failover_ms": 0.0,
            }

        t0 = time.perf_counter()
        if point in CLUSTER_KILL_POINTS:
            # the controller died; the surviving worker PROCESSES did
            # not — a new controller takes them over and completes the
            # orphaned failover from the journals
            from har_tpu_torch.serve.cluster.controller import FleetCluster

            survivors = [
                w for w in cluster._workers.values() if w.alive
            ]
            cluster = FleetCluster.takeover(
                models["A"], root, survivors,
                config=cluster.config, clock=clock, loader=loader,
            )
        else:
            # the victim worker died at its stage boundary; model the
            # SIGKILL (un-flushed journal suffix gone) and let the
            # still-running controller's failure detector find it
            cluster._workers[victim].kill()
        _cluster_schedule(
            cluster, recordings, cursors, hop=hop, clock=clock,
            models=models, swap_sample=swap_sample, events=events,
            on_round=lambda c: balance_log.append(c.accounting()),
        )
        failover_ms = (time.perf_counter() - t0) * 1e3
        stats = cluster.cluster_stats()
        verdict = _cluster_verdict(
            point, ref_events, events, cluster, balance_log, stats,
            failover_ms,
        )
        if standby:
            # sum across the controller generations: an engine-point
            # kill accrues after the crash on the same object
            # (pre-crash counters are zero), a CLUSTER-point kill
            # accrues before it (the takeover controller starts clean)
            total_sf = pre_sf + cluster.standby_fetches
            total_fpb = pre_fpb + cluster.failover_path_bytes
            verdict.update(
                standby_fetches=total_sf,
                failover_path_bytes=total_fpb,
            )
            if verdict["ok"] and total_sf < 1:
                verdict.update(
                    ok=False,
                    why="failover never sourced from the warm standby",
                )
            elif verdict["ok"] and total_fpb != 0:
                verdict.update(
                    ok=False,
                    why=(
                        f"warm failover moved {total_fpb} byte(s); a "
                        "caught-up standby must transfer zero"
                    ),
                )
        cluster.close()
        return verdict
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _cluster_verdict(point, ref_events, events, cluster, balance_log,
                     stats, failover_ms) -> dict:
    why = None
    keys = [_event_key(e) for e in events]
    if len(keys) != len(set(keys)):
        why = "an event was delivered twice across the worker kill"
    by_sid: dict = {}
    for e in events:
        by_sid.setdefault(e.session_id, []).append(e)
    ref_by_sid: dict = {}
    for e in ref_events:
        ref_by_sid.setdefault(e.session_id, []).append(e)
    windows_lost = sum(len(v) for v in ref_by_sid.values()) - sum(
        len(v) for v in by_sid.values()
    )
    if why is None and windows_lost != 0:
        why = f"{windows_lost} window(s) lost vs the un-killed run"
    if why is None:
        for sid, want in ref_by_sid.items():
            got = by_sid.get(sid, [])
            if [_event_fields(e) for e in got] != [
                _event_fields(e) for e in want
            ]:
                why = (
                    f"session {sid!r} events diverge from the "
                    "un-killed cluster run"
                )
                break
    acct = cluster.accounting()
    if why is None and not (acct["balanced"] and acct["pending"] == 0):
        why = f"global conservation violated at the end: {acct}"
    if why is None:
        for i, snap in enumerate(balance_log):
            if not snap["balanced"] or snap["pending"] < 0:
                why = (
                    f"global conservation violated at snapshot {i}: "
                    f"{snap}"
                )
                break
    if why is None and stats["failovers"] < 1:
        why = "no failover was recorded"
    # the controller's in-memory migration log dies with it in a
    # takeover; the per-worker `migrations` counter is the durable
    # evidence (adopt records replay it), so it is the one checked
    migrated = max(stats["migrated_sessions"], stats["migrations"])
    if why is None and migrated < 1:
        why = "no session was migrated"
    return {
        "ok": why is None,
        "point": point,
        "why": why,
        "workers": stats["workers"],
        "failovers": stats["failovers"],
        "migrated_sessions": migrated,
        "windows_lost": max(windows_lost, 0),
        "migration_ms": stats["migration_ms"],
        "failover_ms": round(failover_ms, 3),
        "delivered": len(events),
        "accounting": acct,
    }
