"""Crash-safe fleet durability (har_tpu_torch.serve.journal / recover / chaos).

Pins the contracts the durability layer ships on:
  1. journal mechanics — torn-tail-safe framing, fsync-batched buffering
     whose kill model loses exactly the un-flushed suffix, atomic
     snapshot rotation;
  2. recovery — snapshot + journal-suffix replay rebuilds sessions,
     smoother/monitor state and the pending queue; acked events are
     never re-emitted (zero double-scored);
  3. the kill-point matrix — every enumerated stage boundary recovers
     with the accounting invariant intact and BIT-IDENTICAL scores vs
     an uninterrupted run, plus a seed-randomized kill-point property
     test;
  4. the extended conservation law — enqueued == scored + dropped +
     pending + lost_in_crash when a transport declares a gap;
  5. the ingest guard — NaN/Inf/out-of-range samples are rejected
     per-session (counted, never raised) identically on both serving
     paths.
"""

import json
import os

import numpy as np
import pytest

from har_tpu_torch.serve import (
    ENGINE_KILL_POINTS,
    KILL_POINTS,
    FleetConfig,
    FleetJournal,
    FleetServer,
    JournalConfig,
    run_kill_point,
    run_random_kill,
)
from har_tpu_torch.serve.journal import encode_record, load_journal, read_segment
from har_tpu_torch.serve.stats import FleetStats, StageHistogram
from har_tpu_torch.serving import StreamingClassifier, finite_rows


class _StubModel:
    """Row-deterministic numpy stand-in (as in test_fleet_serving)."""

    num_classes = 3

    def transform(self, x):
        from har_tpu_torch.models.base import Predictions

        x = np.asarray(x)
        m = x.mean(axis=(1, 2))
        raw = np.stack([-m, m, np.zeros_like(m)], axis=-1)
        e = np.exp(raw - raw.max(axis=-1, keepdims=True))
        return Predictions.from_raw(raw, e / e.sum(axis=-1, keepdims=True))


# ------------------------------------------------------------ journal


def test_journal_framing_roundtrip_and_torn_tail(tmp_path):
    path = str(tmp_path / "seg.log")
    recs = [
        ({"t": "push", "sid": 1, "n": 2}, b"\x00" * 24),
        ({"t": "ack", "sid": "a", "ti": 100}, np.arange(3.0).tobytes()),
        ({"t": "swap", "ver": "B"}, b""),
    ]
    blob = b"".join(encode_record(m, p) for m, p in recs)
    with open(path, "wb") as f:
        f.write(blob)
    got, torn = read_segment(path)
    assert not torn
    assert [m for m, _ in got] == [m for m, _ in recs]
    assert got[1][1] == recs[1][1]
    # a record half-written at the kill instant is discarded, the
    # intact prefix survives — never a parse error
    with open(path, "wb") as f:
        f.write(blob[:-7])
    got, torn = read_segment(path)
    assert torn
    assert [m["t"] for m, _ in got] == ["push", "ack"]
    # corrupted bytes mid-record fail the CRC, same contract
    bad = bytearray(blob)
    bad[len(blob) - 4] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(bad))
    got, torn = read_segment(path)
    assert torn and len(got) == 2


def test_journal_kill_loses_exactly_the_unflushed_suffix(tmp_path):
    j = FleetJournal(str(tmp_path), JournalConfig(flush_every=100))
    for i in range(5):
        j.append({"i": i})
    j.flush()
    for i in range(5, 9):
        j.append({"i": i})  # buffered, never flushed
    j.kill()
    segs = [f for f in os.listdir(tmp_path) if f.startswith("wal.")]
    assert len(segs) == 1
    got, torn = read_segment(str(tmp_path / segs[0]))
    assert not torn
    assert [m["i"] for m, _ in got] == [0, 1, 2, 3, 4]


def test_journal_snapshot_rotates_and_prunes(tmp_path):
    j = FleetJournal(str(tmp_path), JournalConfig(flush_every=1))
    j.append({"i": 0})
    j.write_snapshot({"x": 1}, {"a": np.zeros(3)})
    j.append({"i": 1})
    j.write_snapshot({"x": 2}, {"a": np.ones(3)})
    j.append({"i": 2})
    j.close()
    state, arrays, records = load_journal(str(tmp_path))
    assert state["x"] == 2
    assert np.array_equal(arrays["a"], np.ones(3))
    assert [m["i"] for m, _ in records] == [2]
    # pre-rotation segments and stale snapshots were pruned
    names = os.listdir(tmp_path)
    assert sum(n.startswith("snap.") for n in names) == 1
    assert sum(n.startswith("wal.") for n in names) == 1


# ----------------------------------------------------------- recovery


def _journaled_server(tmp_path, model=None, **cfg):
    server = FleetServer(
        model or _StubModel(), window=100, hop=50, smoothing="ema",
        config=FleetConfig(
            max_sessions=16, target_batch=8, max_delay_ms=0.0,
            **cfg,
        ),
        journal=FleetJournal(
            str(tmp_path / "j"), JournalConfig(flush_every=4)
        ),
    )
    return server


def test_restore_rebuilds_state_and_never_reemits_acked(tmp_path):
    """The core recovery semantics, hand-driven: acked events stay
    acked (nothing re-emitted), un-acked windows come back pending, the
    smoother continues the pre-crash stream bit-identically."""
    rng = np.random.default_rng(3)
    recs = [rng.normal(size=(500, 3)).astype(np.float32) for _ in range(4)]
    server = _journaled_server(tmp_path)
    for i in range(4):
        server.add_session(i)
    # first half: deliver + poll → acked events
    delivered = []
    for i in range(4):
        server.push(i, recs[i][:250])
    delivered.extend(server.poll(force=True))
    # second half enqueued but never polled → pending at the kill
    for i in range(4):
        server.push(i, recs[i][250:])
    pending_before = server.stats.accounting()["pending"]
    assert pending_before > 0
    server.journal.kill()

    restored = FleetServer.restore(str(tmp_path / "j"), _StubModel())
    assert restored.stats.recoveries == 1
    acct = restored.stats.accounting()
    assert acct["scored"] == len(delivered)
    assert acct["pending"] == pending_before
    # draining the restored fleet emits ONLY the never-acked windows...
    post = restored.flush()
    seen = {(e.session_id, e.event.t_index) for e in delivered}
    assert all((e.session_id, e.event.t_index) not in seen for e in post)
    # ...bit-identically to an uninterrupted run of the same stream
    ref = {}
    for i in range(4):
        sc = StreamingClassifier(
            _StubModel(), window=100, hop=50, smoothing="ema"
        )
        evs = sc.push(recs[i][:250]) + sc.push(recs[i][250:])
        ref[i] = evs
    combined = {}
    for e in list(delivered) + list(post):
        combined.setdefault(e.session_id, []).append(e.event)
    for i in range(4):
        assert len(combined[i]) == len(ref[i])
        for g, w in zip(combined[i], ref[i]):
            assert g.t_index == w.t_index
            assert g.label == w.label
            assert g.raw_label == w.raw_label
            np.testing.assert_array_equal(g.probability, w.probability)
    final = restored.stats.accounting()
    assert final["balanced"] and final["pending"] == 0
    assert json.dumps(restored.stats_snapshot())  # stays JSON-clean


def test_restore_recovers_monitor_state_and_episodes(tmp_path):
    """Drift-monitor EWMAs and the live episode survive the crash: a
    drifting session is still drifting after recovery, with the same
    episode id (generation, onset)."""
    from har_tpu_torch.monitoring import DriftMonitor

    server = _journaled_server(tmp_path)
    server.add_session(
        "bad", monitor=DriftMonitor(np.zeros(3), np.ones(3), patience=2)
    )
    shifted = (np.zeros((400, 3)) + 25.0).astype(np.float32)
    for start in range(0, 400, 50):
        server.push("bad", shifted[start : start + 50])
    server.poll(force=True)
    rep = server.drift_report("bad")
    assert rep is not None and rep.drifting
    server.journal.kill()

    restored = FleetServer.restore(str(tmp_path / "j"), _StubModel())
    mon = restored._sessions["bad"].asm.monitor
    assert mon is not None
    assert mon._drifting
    assert mon._onset == rep.onset
    assert mon._generation == rep.generation
    assert mon._n == 400
    # and the next chunk continues the same episode, not a fresh one
    restored.push("bad", shifted[:50])
    rep2 = restored.drift_report("bad")
    assert rep2.drifting and rep2.onset == rep.onset


def test_watermark_and_declare_lost_extend_the_conservation_law(tmp_path):
    """A transport that cannot replay declares the gap: the skipped
    windows are counted as enqueued AND lost_in_crash, and the next
    full fresh window after the gap scores normally."""
    server = _journaled_server(tmp_path)
    server.add_session(0)
    server.push(0, np.zeros((250, 3), np.float32))  # windows at 100,150,200,250
    server.flush()
    assert server.watermark(0) == 250
    # the stream moved to 500 while the process was dead; no replay
    lost = server.declare_lost(0, 500)
    # boundaries 300..550 need pre-500 samples → lost; first clean one
    # is at 600 (500 + window)
    assert lost > 0
    acct = server.stats.accounting()
    assert acct["lost_in_crash"] == lost
    assert acct["enqueued"] == (
        acct["scored"] + acct["dropped"] + acct["pending"] + lost
    )
    assert acct["balanced"]
    # delivery resumes: one full window after the gap emits at 600
    events = []
    server.push(0, np.ones((100, 3), np.float32))
    events.extend(server.flush())
    assert [e.event.t_index for e in events] == [600]
    assert server.stats.accounting()["balanced"]


def test_second_crash_recovers_from_first_recovery(tmp_path):
    """Crashes compose: restore() re-attaches the journal with a
    recovery-point snapshot, so a second kill recovers too."""
    server = _journaled_server(tmp_path)
    server.add_session(0)
    server.push(0, np.zeros((200, 3), np.float32))
    ev1 = server.poll(force=True)
    server.journal.kill()
    r1 = FleetServer.restore(str(tmp_path / "j"), _StubModel())
    r1.push(0, np.ones((100, 3), np.float32))
    ev2 = r1.poll(force=True)
    r1.journal.kill()
    r2 = FleetServer.restore(str(tmp_path / "j"), _StubModel())
    assert r2.stats.recoveries == 2
    acct = r2.stats.accounting()
    assert acct["scored"] == len(ev1) + len(ev2)
    assert acct["balanced"] and acct["pending"] == 0


# ----------------------------------------------- kill-point chaos matrix


@pytest.mark.parametrize("point", KILL_POINTS)
def test_kill_point_recovers_bit_identical(point):
    """THE acceptance pin: kill at every enumerated stage boundary
    under the FakeClock+DispatchFaults harness, recover, resume
    from the watermark — accounting invariant intact, zero events
    double-scored, and the union of pre-crash and post-recovery events
    bit-identical to an uninterrupted run."""
    out = run_kill_point(point, sessions=6, seed=1)
    assert out["ok"], out
    assert out["windows_lost"] == 0
    assert out["accounting"]["balanced"]
    assert out["accounting"]["pending"] == 0
    assert out["delivered_post_recovery"] > 0


@pytest.mark.parametrize("point", ENGINE_KILL_POINTS)
def test_engine_kill_point_resolves_half_finished_transition(point):
    """mid_promote / mid_rollback: the registry pointer moved but the
    fleet swap never applied — recovery must land the fleet on CURRENT
    (resuming probation for a promotion) with accounting intact."""
    out = run_kill_point(point, sessions=6, seed=2)
    assert out["ok"], out
    assert out["serving_version"] == out["registry_current"]
    assert out["accounting"]["balanced"]


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("point", ENGINE_KILL_POINTS)
def test_engine_kill_point_behind_the_device_plane(point, depth):
    """Both engine kill points behind the device dispatch plane (two demo
    MLPs on the CPU) at depths 1 and 3: recovery serves CURRENT's model,
    and a promotion's probation closes on it."""
    out = run_kill_point(point, sessions=8, seed=0, pipeline_depth=depth,
                         device="cpu")
    assert out["ok"], out
    assert out["serving_version"] == out["registry_current"] == (
        "v0000002" if point == "mid_promote" else "v0000001")
    assert out["accounting"]["balanced"] and out["accounting"]["pending"] == 0
    assert out["adapt_log"][0] == (
        "recovery_completed_promotion" if point == "mid_promote"
        else "recovery_completed_rollback")


def test_crash_after_failed_rollback_write_still_swaps_back(tmp_path):
    """The live path swaps back even when registry.rollback raises
    ("serving correctness over lineage"); a kill between that failed
    pointer write and the swap-back must not strand the regressing
    model — resume completes the swap-back to the prior incumbent."""
    from har_tpu_torch.adapt.registry import ModelRegistry
    from har_tpu_torch.adapt.shadow import ShadowConfig
    from har_tpu_torch.adapt.swap import AdaptationConfig, AdaptationEngine
    from har_tpu_torch.adapt.trigger import TriggerConfig
    from har_tpu_torch.monitoring import DriftMonitor
    from har_tpu_torch.serve import (
        DispatchFaults,
        FakeClock,
        KillPlan,
        SimulatedCrash,
    )
    from har_tpu_torch.serve.loadgen import AnalyticDemoModel

    clock = FakeClock()
    journal = FleetJournal(
        str(tmp_path / "j"), JournalConfig(flush_every=4)
    )
    incumbent = AnalyticDemoModel()
    candidate = AnalyticDemoModel(tau=5.0)
    faults = DispatchFaults(fake_clock=clock)
    server = FleetServer(
        incumbent, window=100, hop=100, channels=3, smoothing="none",
        config=FleetConfig(max_sessions=6, max_delay_ms=0.0, retries=0),
        clock=clock, fault_hook=faults, journal=journal,
    )
    rng = np.random.default_rng(21)
    recs = [
        rng.normal(size=(1200, 3)).astype(np.float32) for _ in range(6)
    ]
    for i in range(6):
        server.add_session(
            i,
            monitor=DriftMonitor(
                np.zeros(3), np.ones(3), halflife=50.0, patience=2
            ),
        )
    registry = ModelRegistry(str(tmp_path / "reg"), clock=clock)
    kw = dict(
        config=AdaptationConfig(
            probation_dispatches=4, max_shadow_dispatches=8
        ),
        trigger_config=TriggerConfig(
            min_sessions=2, window_s=1e9, cooldown_s=1e9,
            recovery_patience=1,
        ),
        shadow_config=ShadowConfig(sample_every=1, min_windows=4),
        clock=clock,
    )
    engine = AdaptationEngine(server, registry, lambda job: candidate,
                              **kw)
    v1 = server.model_version
    models = {v1: incumbent}

    def loader(ver):
        return models.get(ver, candidate)

    def broken_rollback():
        raise OSError("registry dir went read-only")

    registry.rollback = broken_rollback
    journal.chaos = KillPlan("mid_rollback", 1)
    crashed = False
    try:
        for rnd in range(10):
            for i in range(6):
                chunk = recs[i][rnd * 100 : (rnd + 1) * 100]
                if i < 3 and rnd >= 1:
                    chunk = chunk + 25.0
                server.push(i, chunk)
            server.poll(force=True)
            if engine.state == "probation":
                faults.fail_every = 1  # regression: every dispatch dies
            engine.step()
            clock.advance(1.0)
    except SimulatedCrash:
        crashed = True
        journal.kill()
    assert crashed, f"never reached mid_rollback (state={engine.state})"

    clock2 = FakeClock(clock.t)
    restored = FleetServer.restore(
        str(tmp_path / "j"), loader, clock=clock2
    )
    # the kill hit between the failed pointer write and the swap-back:
    # the regressing candidate is still the serving version on disk
    assert restored.model_version != v1
    registry2 = ModelRegistry(str(tmp_path / "reg"), clock=clock2)
    engine2 = AdaptationEngine(
        restored, registry2, lambda job: candidate, **kw,
        resume=True, loader=loader,
    )
    assert restored.model_version == v1  # swap-back completed
    assert restored.stats.rollbacks == 1
    assert engine2.state == "serving"
    # and the pointer retry (healthy registry2) landed back on v1 too
    assert registry2.current().name == v1


@pytest.mark.parametrize("point", KILL_POINTS)
def test_kill_point_matrix_holds_at_pipeline_depth_2(point):
    """The pipelining acceptance pin: the FULL matrix re-runs with
    pipeline_depth=2 — tickets genuinely in flight at the kill instant
    (mid_launch / pre_retire especially) — and the contract must hold
    unchanged, because an in-flight ticket is un-acked by construction
    and its windows recover as pending from the replayed pushes."""
    out = run_kill_point(point, sessions=6, seed=3, pipeline_depth=2)
    assert out["ok"], out
    assert out["windows_lost"] == 0
    assert out["accounting"]["balanced"]
    assert out["accounting"]["pending"] == 0


@pytest.mark.parametrize("depth", [3, 4])
@pytest.mark.parametrize(
    "point", ["mid_launch", "pre_retire", "post_score_pre_ack",
              "mid_resize"]
)
def test_kill_point_ticket_ring_depths_3_and_4(point, depth):
    """The depth-N ticket ring's chaos pin: the ticket-centric stage
    boundaries (several tickets genuinely in flight at the kill
    instant at depth >= 3, plus the capacity boundary) recover
    bit-identically at ring depths 3 and 4 — every in-flight ticket is
    un-acked by construction no matter how deep the ring runs.  The
    full matrix stays pinned at depths 1 and 2 above; the randomized
    property test draws the remaining (point × depth) combinations."""
    out = run_kill_point(point, sessions=6, seed=4, pipeline_depth=depth)
    assert out["ok"], out
    assert out["windows_lost"] == 0
    assert out["accounting"]["balanced"]
    assert out["accounting"]["pending"] == 0


@pytest.mark.parametrize("depth", [3, 4])
@pytest.mark.parametrize(
    "point", ["post_enqueue", "pre_dispatch", "mid_dispatch", "mid_snapshot",
              "mid_swap"]
)
def test_kill_point_rest_of_matrix_at_depths_3_and_4(point, depth):
    """The points the ticket-ring pin above leaves to the random draw,
    at ring depths 3 and 4 too: with it, every KILL_POINTS case
    recovers bit-identically at depths 1-4."""
    out = run_kill_point(point, sessions=6, seed=4, pipeline_depth=depth)
    assert out["ok"], out
    assert out["windows_lost"] == 0


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("point", KILL_POINTS)
def test_kill_point_behind_the_device_plane(point, depth):
    """The matrix with two JitDemoModels on the CPU behind DeviceScorer
    (launch, un-synchronised handle, fetch at retire), as chip_smoke.py
    runs it on the card."""
    out = run_kill_point(point, sessions=4, seed=5, pipeline_depth=depth,
                         device="cpu")
    assert out["ok"], out
    assert out["windows_lost"] == 0


def test_kill_point_with_a_mesh_names_its_item(tmp_path):
    """A kill point behind a serving mesh: a 4-entry batch-sharded mesh
    and a 2×2 model-parallel one recover as one device does, and
    ``restore_server(mesh=)`` rebuilds the scorer on the mesh it is
    given."""
    from har_tpu_torch.parallel.mesh import create_serving_mesh

    for dp, tp in ((4, 1), (2, 2)):
        mesh = create_serving_mesh(dp=dp, tp=tp, devices=["cpu"] * 4)
        out = run_kill_point("pre_dispatch", sessions=4, seed=2, mesh=mesh)
        assert out["ok"], out
        assert out["windows_lost"] == 0
    from har_tpu_torch.serve import (
        FleetConfig,
        FleetJournal,
        FleetServer,
        JitDemoModel,
        JournalConfig,
        restore_server,
    )

    model = JitDemoModel(window=100, device="cpu")
    root = str(tmp_path / "wal")
    server = FleetServer(model, window=100, hop=100, smoothing="none",
                         config=FleetConfig(max_sessions=4, max_delay_ms=1e9),
                         journal=FleetJournal(root, JournalConfig(flush_every=1)))
    for i in range(4):
        server.add_session(i)
        server.push(i, np.zeros((100, 3), np.float32))
    server.journal.kill()
    restored = restore_server(root, model, mesh=mesh)
    assert len(restored.flush()) == 4
    assert restored.scorer.kind == "model_parallel" and restored.scorer.devices == 2


@pytest.mark.parametrize("seed", range(6))
def test_randomized_kill_point_property(seed):
    """Seed-randomized draw over (kill point, occurrence, flush
    batching, snapshot cadence, pipeline depth — the full {1, 2, 3, 4}
    ticket ring, fleet size): the recovery contract is a property, not
    a fixture."""
    out = run_random_kill(seed)
    assert out["ok"], out
    assert out["windows_lost"] == 0


# -------------------------------------------------------- ingest guard


def test_finite_rows_guard():
    x = np.zeros((5, 3), np.float32)
    x[1, 0] = np.nan
    x[2, 2] = np.inf
    x[3, 1] = -2e6
    clean, n_bad = finite_rows(x, 1e6)
    assert n_bad == 3 and len(clean) == 2
    clean, n_bad = finite_rows(x, None)  # range check off, NaN/Inf on
    assert n_bad == 2 and len(clean) == 3


def test_fleet_push_rejects_poison_samples_never_raises(tmp_path):
    """One NaN row must not poison the micro-batch — rejected
    per-session, counted, and the fleet stays bit-identical to a
    standalone classifier fed the same poisoned chunks."""
    server = FleetServer(
        _StubModel(), window=100, hop=50, smoothing="ema",
        config=FleetConfig(max_sessions=2),
    )
    server.add_session(0)
    rng = np.random.default_rng(5)
    rec = rng.normal(size=(400, 3)).astype(np.float32)
    poisoned = rec.copy()
    poisoned[7, 1] = np.nan
    poisoned[200, 0] = np.inf
    poisoned[301, 2] = 5e8  # wildly out of range
    server.push(0, poisoned)
    events = server.flush()
    assert server.stats.rejected_samples == 3
    assert all(np.isfinite(e.event.probability).all() for e in events)
    acct = server.stats.accounting()
    assert acct["balanced"] and acct["pending"] == 0

    sc = StreamingClassifier(_StubModel(), window=100, hop=50,
                             smoothing="ema")
    ref = sc.push(poisoned)
    assert sc.rejected_samples == 3
    assert len(events) == len(ref)
    for g, w in zip(events, ref):
        assert g.event.t_index == w.t_index
        assert g.event.label == w.label
        np.testing.assert_array_equal(g.event.probability, w.probability)


def test_watermark_speaks_raw_transport_coordinates(tmp_path):
    """A rejected NaN row must not shift post-crash re-delivery: the
    watermark counts RAW delivered samples (rejected rows included), so
    slicing the transport's recording at the watermark resumes exactly
    where delivery stopped — combined events stay bit-identical to an
    uninterrupted run of the same poisoned stream."""
    rng = np.random.default_rng(11)
    poisoned = rng.normal(size=(400, 3)).astype(np.float32)
    poisoned[10, 0] = np.nan
    poisoned[120, 2] = np.inf
    server = _journaled_server(tmp_path)
    server.add_session(0)
    server.push(0, poisoned[:200])
    delivered = server.poll(force=True)
    server.journal.kill()

    restored = FleetServer.restore(str(tmp_path / "j"), _StubModel())
    assert restored.stats.rejected_samples == 2
    wm = restored.watermark(0)
    assert wm == 200  # raw coordinates; post-filter would report 198
    post = restored.poll(force=True)
    restored.push(0, poisoned[wm:])
    post += restored.flush()

    sc = StreamingClassifier(
        _StubModel(), window=100, hop=50, smoothing="ema"
    )
    ref = sc.push(poisoned[:200]) + sc.push(poisoned[200:])
    combined = [e.event for e in list(delivered) + list(post)]
    assert len(combined) == len(ref) > 0
    for g, w in zip(combined, ref):
        assert g.t_index == w.t_index
        assert g.label == w.label
        np.testing.assert_array_equal(g.probability, w.probability)


def test_malformed_push_raises_before_journaling(tmp_path):
    """A wrong-shape push raises to its caller BEFORE any journal
    record or watermark advance — one malformed call must never poison
    the journal and make the whole fleet unrecoverable."""
    server = _journaled_server(tmp_path)
    server.add_session(0)
    server.push(0, np.zeros((100, 3), np.float32))
    with pytest.raises(ValueError, match="expected"):
        server.push(0, np.zeros((10, 5), np.float32))
    assert server.watermark(0) == 100  # not advanced by the bad push
    server.push(0, np.zeros((100, 3), np.float32))
    server.poll(force=True)  # ack boundary: flush everything durable
    server.journal.kill()
    restored = FleetServer.restore(str(tmp_path / "j"), _StubModel())
    assert restored.watermark(0) == 200
    restored.flush()
    acct = restored.stats.accounting()
    assert acct["balanced"] and acct["pending"] == 0


def test_fresh_attach_refuses_existing_journal(tmp_path):
    """`--journal DIR` without `--resume` onto a crashed fleet's
    directory must refuse instead of silently rotating away (and thus
    destroying) the recovery data."""
    from har_tpu_torch.serve import JournalError

    server = _journaled_server(tmp_path)
    server.add_session(0)
    server.push(0, np.zeros((150, 3), np.float32))
    server.poll(force=True)  # flush so the crash leaves durable state
    server.journal.kill()
    with pytest.raises(JournalError, match="already holds"):
        _journaled_server(tmp_path)
    # the recovery data survived the refused attach
    restored = FleetServer.restore(str(tmp_path / "j"), _StubModel())
    assert restored.watermark(0) == 150


# -------------------------------------------- back-compat (pre-journal)


def test_pre_pipeline_journal_restores_cleanly(tmp_path):
    """Back-compat pin (next to the older-format pins): a journal written
    BEFORE the pipelined dispatch plane existed — no ``staging_arena``
    extra, no ``pipeline_depth`` in the config block, no overlap/
    in-flight stats fields, pending windows as the plain stacked array
    — restores through today's code with the arena rebuilt
    transparently and pipeline_depth defaulting to the synchronous 1."""
    root = str(tmp_path / "old")
    j = FleetJournal(root, JournalConfig(flush_every=1, snapshot_every=0))
    rng = np.random.default_rng(0)
    pend = rng.normal(size=(2, 100, 3)).astype(np.float32)
    state = {
        "geometry": {
            "window": 100, "hop": 100, "channels": 3,
            "smoothing": "ema", "ema_alpha": 0.4, "vote_depth": 5,
            "class_names": None, "model_version": "v0",
        },
        # exactly what the older dataclasses.asdict produced: no
        # pipeline_depth key at all
        "config": {"max_sessions": 8, "target_batch": 32},
        "ladder": {
            "smoothing_shed": False, "breaches": 0, "ok_streak": 0,
        },
        "stats": {"counters": {"enqueued": 2}},
        "sessions": [
            {
                "sid": 0, "n_seen": 200, "raw_seen": 200,
                "next_emit": 300, "n_enqueued": 2, "n_scored": 0,
                "n_dropped": 0, "votes": [], "monitor": None,
            }
        ],
        "pending": [[0, 100, False], [0, 200, False]],
        "extra": {},  # no staging_arena record, no in-flight tickets
    }
    j.write_snapshot(
        state,
        {"ring0": np.zeros((100, 3), np.float32), "pending": pend},
    )
    j.close()
    restored = FleetServer.restore(root, _StubModel(), reattach=False)
    assert restored.config.pipeline_depth == 1
    assert restored.stats.overlap_host_ms == 0.0
    acct = restored.stats.accounting()
    assert acct["pending"] == 2
    events = restored.flush()
    assert [e.event.t_index for e in events] == [100, 200]
    # the recovered windows scored from the re-staged arena slots are
    # the snapshot's bytes exactly
    want = _StubModel().transform(pend).probability
    got = np.stack([e.event.probability for e in events])
    np.testing.assert_array_equal(got[0], want[0])
    acct = restored.stats.accounting()
    assert acct["balanced"] and acct["pending"] == 0


def test_stats_state_roundtrip_and_pre_journal_defaults():
    """FleetStats.state()/load_state round-trips, and a pre-journal
    state dict (no lost_in_crash / recoveries / rejected_samples)
    loads with zero defaults — both directions pinned."""
    s = FleetStats()
    s.enqueued = 10
    s.note_scored(6, "v1")
    s.note_scored(1, "v2")
    s.drop(3, "backpressure")
    s.rejected_samples = 2
    s.lost_in_crash = 0
    s.dispatch.record(1.5)
    s.overlap_host_ms = 12.5
    s.inflight_ms = 40.0
    s.note_inflight_depth(2)
    s.note_device_windows("0", 16)
    state = s.state()
    s2 = FleetStats()
    s2.load_state(json.loads(json.dumps(state)))  # via JSON, like disk
    assert s2.enqueued == 10 and s2.scored == 7
    assert s2.scored_by_version == {"v1": 6, "v2": 1}
    assert s2.dropped == {"backpressure": 3}
    assert s2.rejected_samples == 2
    assert s2.dispatch.count == 1
    assert s2.overlap_host_ms == 12.5 and s2.inflight_ms == 40.0
    assert s2.inflight_depth == {2: 1}
    assert s2.device_windows == {"0": 16}
    assert s2.accounting() == s.accounting()
    # pre-journal dict: the new fields absent entirely (a PRE-PIPELINE
    # state also lacks the overlap/in-flight fields — zero defaults)
    old = json.loads(json.dumps(state))
    for key in ("lost_in_crash", "recoveries", "rejected_samples"):
        old["counters"].pop(key, None)
    for key in (
        "overlap_host_ms", "inflight_ms", "inflight_depth",
        "device_windows",
    ):
        old.pop(key, None)
    s3 = FleetStats()
    s3.load_state(old)
    assert s3.lost_in_crash == 0
    assert s3.recoveries == 0
    assert s3.rejected_samples == 0
    assert s3.overlap_host_ms == 0.0 and s3.inflight_ms == 0.0
    assert s3.inflight_depth == {} and s3.device_windows == {}
    assert s3.accounting()["balanced"]
    h = StageHistogram()
    h.load_state({})  # empty pre-journal histogram state
    assert h.count == 0


def test_stats_load_state_warns_and_counts_unknown_keys():
    """Forward-compat (the runtime half of harlint HL002): a state dict
    written by a NEWER FleetStats — extra counters, extra top-level
    blocks, extra stage histograms — loads everything this version
    knows, but the unknown keys are counted (``unknown_state_keys``)
    and warned about, never silently dropped."""
    s = FleetStats()
    s.enqueued = 4
    s.note_scored(4, "v1")
    future = json.loads(json.dumps(s.state()))
    future["counters"]["frobnications"] = 9  # a newer writer's counter
    future["future_block"] = {"x": 1}  # a newer top-level section
    future["stages"]["teleport"] = {"count": 1}  # a newer stage
    s2 = FleetStats()
    with pytest.warns(RuntimeWarning, match="unknown state keys"):
        s2.load_state(future)
    assert s2.unknown_state_keys == 3
    # the known fields still loaded in full
    assert s2.enqueued == 4 and s2.scored == 4
    assert s2.accounting()["balanced"]
    # the counter is itself durable state: it survives a round-trip
    # (and accumulates if the downgrade happens again)
    s3 = FleetStats()
    s3.load_state(json.loads(json.dumps(s2.state())))
    assert s3.unknown_state_keys == 3
    assert "unknown_state_keys" in s2.snapshot()
    # a same-version state round-trips silently (no false alarms)
    import warnings as _warnings

    with _warnings.catch_warnings():
        _warnings.simplefilter("error")
        FleetStats().load_state(json.loads(json.dumps(s.state())))


def test_stats_tenant_counters_roundtrip_and_pre_tenant_defaults():
    """The edge identity axis is durable observability: per-tenant
    accept/shed counters survive the state()/load_state round-trip via
    JSON, and a PRE-TENANT state dict (written before the edge carried
    identity) loads with empty-dict defaults — no warning, no phantom
    tenants."""
    s = FleetStats()
    s.note_tenant_accept("care")
    s.note_tenant_accept("care")
    s.note_tenant_accept("bulk")
    s.note_tenant_shed("bulk")
    state = json.loads(json.dumps(s.state()))
    s2 = FleetStats()
    s2.load_state(state)
    assert s2.tenant_accepts == {"care": 2, "bulk": 1}
    assert s2.tenant_sheds == {"bulk": 1}
    # the round-trip is idempotent through the snapshot surface too
    assert s2.state()["tenant_accepts"] == state["tenant_accepts"]
    # pre-tenant dict: the keys absent entirely — zero defaults, and a
    # silent load (an old journal is not a forward-compat event)
    old = json.loads(json.dumps(state))
    old.pop("tenant_accepts")
    old.pop("tenant_sheds")
    s3 = FleetStats()
    import warnings as _warnings

    with _warnings.catch_warnings():
        _warnings.simplefilter("error")
        s3.load_state(old)
    assert s3.tenant_accepts == {} and s3.tenant_sheds == {}
    assert s3.accounting()["balanced"]


def test_cli_serve_journal_kill_and_resume(tmp_path, capsys):
    """Acceptance: `har serve --journal DIR --resume` survives a
    mid-run kill end to end — the resumed run recovers, re-delivers
    from the watermark, scores every window exactly once, and the
    accounting (including recoveries) proves it."""
    import subprocess
    import sys as _sys

    jdir = str(tmp_path / "wal")
    env = dict(os.environ)
    proc = subprocess.run(
        [
            _sys.executable, "-m", "har_tpu_torch.cli", "serve",
            "--device", "cpu", "--sessions", "8", "--windows-per-session", "4",
            "--journal", jdir, "--journal-flush-every", "4",
            "--kill-after-polls", "3",
        ],
        capture_output=True, text=True, env=env,
    )
    assert proc.returncode == 17, proc.stderr[-500:]
    assert "kill-after-polls" in proc.stderr
    assert os.path.isdir(jdir)

    from har_tpu_torch.cli import main

    rc = main(
        [
            "serve", "--device", "cpu", "--sessions", "8", "--windows-per-session", "4",
            "--journal", jdir, "--resume",
        ]
    )
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["resumed"] is True
    assert out["recoveries"] == 1
    assert out["lost_in_crash"] == 0
    assert out["dropped"] == 0
    # every window of the full workload scored exactly once across the
    # two processes: cumulative accounting (restored + resumed) covers
    # all 8 sessions x 4 windows, with zero double-scoring possible by
    # the ack-replay construction
    assert out["enqueued"] == out["scored"] == 32
    assert out["stats"]["accounting"]["balanced"]
    assert out["stats"]["accounting"]["pending"] == 0


def test_restore_ignores_torn_tmp_snapshot_and_prune_removes_it(tmp_path):
    """A kill inside write_snapshot (before the atomic rename) leaves a
    ``snap.<k>.tmp`` directory.  Regression pin: restore must ignore it
    (the newest COMPLETE snapshot wins) and ``FleetJournal.prune()``
    must remove it — a fleet that crashes inside snapshots must not
    accumulate full state copies on disk."""
    server = _journaled_server(tmp_path)
    for i in range(2):
        server.add_session(i)
        server.push(i, np.random.default_rng(i).normal(
            size=(150, 3)).astype(np.float32))
    server.flush()
    server.write_snapshot()
    root = tmp_path / "j"
    # a torn tmp left by a mid-snapshot kill: partial state, no rename
    torn = root / "snap.99.tmp"
    torn.mkdir()
    (torn / "state.json").write_text('{"torn": tru')  # half-written
    (torn / "arrays.npz").write_bytes(b"\x00garbage")
    server.journal.kill()

    restored = FleetServer.restore(str(root), _StubModel())
    # the torn tmp was invisible to recovery...
    assert restored.stats.recoveries == 1
    acct = restored.stats.accounting()
    assert acct["balanced"]
    assert len(restored.sessions) == 2
    # ...and the restore's own recovery snapshot pruned it from disk
    assert not torn.exists()
    # prune() also clears a torn tmp dropped AFTER the last snapshot
    torn2 = root / "snap.100.tmp"
    torn2.mkdir()
    (torn2 / "state.json").write_text("{}")
    restored.journal.prune()
    assert not torn2.exists()
    restored.journal.close()


def test_stats_cluster_counters_roundtrip_and_pre_cluster_defaults():
    """The cluster control-plane counters (worker_failovers,
    migrations, migration_ms) round-trip through state()/load_state,
    and a pre-cluster state dict missing them loads with zero defaults
    — both directions pinned (HL002's runtime contract)."""
    s = FleetStats()
    s.enqueued = 5
    s.note_scored(5, "v1")
    s.worker_failovers = 2
    s.migrations = 7
    s.migration_ms = 123.5
    state = json.loads(json.dumps(s.state()))
    s2 = FleetStats()
    s2.load_state(state)
    assert s2.worker_failovers == 2
    assert s2.migrations == 7
    assert s2.migration_ms == 123.5
    assert s2.accounting() == s.accounting()
    snap = s2.snapshot()
    assert snap["worker_failovers"] == 2
    assert snap["migrations"] == 7
    assert snap["migration_ms"] == 123.5
    # pre-cluster state: the fields absent entirely — zero defaults,
    # and no unknown-key warning in either direction
    old = json.loads(json.dumps(state))
    old["counters"].pop("worker_failovers")
    old["counters"].pop("migrations")
    old.pop("migration_ms")
    s3 = FleetStats()
    import warnings as _warnings

    with _warnings.catch_warnings():
        _warnings.simplefilter("error")
        s3.load_state(old)
    assert s3.worker_failovers == 0
    assert s3.migrations == 0
    assert s3.migration_ms == 0.0
    assert s3.accounting()["balanced"]


def test_stats_rpc_counters_roundtrip_and_pre_net_defaults():
    """The wire-transport counters (rpc_sent, rpc_retries,
    rpc_bytes_tx/rx) and the rpc_rtt stage histogram round-trip
    through state()/load_state, and a PRE-NET state dict missing them
    entirely loads with zero defaults and no unknown-key warning —
    both directions pinned (HL002's runtime contract)."""
    s = FleetStats()
    s.enqueued = 3
    s.note_scored(3, "v1")
    s.rpc_sent = 41
    s.rpc_retries = 2
    s.rpc_bytes_tx = 9000
    s.rpc_bytes_rx = 4500
    s.rpc_rtt.record(0.8)
    s.rpc_rtt.record(12.5)
    state = json.loads(json.dumps(s.state()))
    s2 = FleetStats()
    s2.load_state(state)
    assert s2.rpc_sent == 41
    assert s2.rpc_retries == 2
    assert s2.rpc_bytes_tx == 9000
    assert s2.rpc_bytes_rx == 4500
    assert s2.rpc_rtt.count == 2
    assert s2.rpc_rtt.total_ms == s.rpc_rtt.total_ms
    snap = s2.snapshot()
    assert snap["rpc_sent"] == 41
    assert snap["rpc_retries"] == 2
    assert snap["rpc_bytes_tx"] == 9000
    assert snap["rpc_bytes_rx"] == 4500
    assert snap["stages"]["rpc_rtt_ms"]["count"] == 2
    # pre-net state: counters AND the rpc_rtt stage absent entirely —
    # zero defaults, no unknown-key warning in either direction
    old = json.loads(json.dumps(state))
    for k in ("rpc_sent", "rpc_retries", "rpc_bytes_tx", "rpc_bytes_rx"):
        old["counters"].pop(k)
    old["stages"].pop("rpc_rtt")
    s3 = FleetStats()
    import warnings as _warnings

    with _warnings.catch_warnings():
        _warnings.simplefilter("error")
        s3.load_state(old)
    assert s3.rpc_sent == 0
    assert s3.rpc_retries == 0
    assert s3.rpc_bytes_tx == 0
    assert s3.rpc_bytes_rx == 0
    assert s3.rpc_rtt.count == 0
    assert s3.accounting()["balanced"]


def test_stats_elastic_counters_roundtrip_and_pre_elastic_defaults():
    """The elastic-capacity counters (resizes, scale_ups, scale_downs)
    round-trip through state()/load_state, and a pre-elastic state dict
    missing them loads with zero defaults — both directions pinned
    (HL002's runtime contract).  The utilization gauge is EPHEMERAL by
    design: recomputed by the next dispatch, never persisted."""
    s = FleetStats()
    s.enqueued = 4
    s.note_scored(4, "v1")
    s.resizes = 3
    s.scale_ups = 2
    s.scale_downs = 1
    s.utilization = 0.75
    state = json.loads(json.dumps(s.state()))
    assert "utilization" not in state  # live gauge: not snapshot state
    assert "utilization" not in state["counters"]
    s2 = FleetStats()
    s2.load_state(state)
    assert s2.resizes == 3
    assert s2.scale_ups == 2
    assert s2.scale_downs == 1
    assert s2.utilization == 0.0  # recomputed at the next dispatch
    assert s2.accounting() == s.accounting()
    snap = s2.snapshot()
    assert snap["resizes"] == 3
    assert snap["scale_ups"] == 2
    assert snap["scale_downs"] == 1
    # pre-elastic state: the fields absent entirely — zero defaults,
    # and no unknown-key warning in either direction
    old = json.loads(json.dumps(state))
    old["counters"].pop("resizes")
    old["counters"].pop("scale_ups")
    old["counters"].pop("scale_downs")
    s3 = FleetStats()
    import warnings as _warnings

    with _warnings.catch_warnings():
        _warnings.simplefilter("error")
        s3.load_state(old)
    assert s3.resizes == 0
    assert s3.scale_ups == 0
    assert s3.scale_downs == 0
    assert s3.unknown_state_keys == 0
    assert s3.accounting()["balanced"]


def test_resize_record_replays_schedule_knobs(tmp_path):
    """A journaled elastic resize replays exactly: the restored server
    serves the post-resize target_batch/pipeline_depth with the resize
    counters intact — while the mesh OBJECT stays a runtime resource
    (recovery shards onto whatever mesh restore() was given, the same
    stance the model takes)."""
    server = _journaled_server(tmp_path)
    server.add_session(0)
    rng = np.random.default_rng(6)
    server.push(0, rng.normal(size=(250, 3)).astype(np.float32))
    server.poll(force=True)
    server.resize(target_batch=32, pipeline_depth=2)
    server.push(0, rng.normal(size=(250, 3)).astype(np.float32))
    server.poll(force=True)
    server.journal.kill()

    restored = FleetServer.restore(str(tmp_path / "j"), _StubModel())
    assert restored.config.target_batch == 32
    assert restored.config.pipeline_depth == 2
    assert restored.stats.resizes == 1
    assert restored.stats.scale_ups == 1
    assert restored.stats.scale_downs == 0
    restored.flush()
    acct = restored.stats.accounting()
    assert acct["balanced"] and acct["pending"] == 0


def test_unflushed_resize_record_lost_with_pre_resize_capacity(tmp_path):
    """mid_resize crash semantics, hand-driven: a resize applied in
    memory whose record never reached disk recovers serving the
    PRE-resize capacity (the controller re-issues on its next step) —
    never a half-applied schedule."""
    server = _journaled_server(tmp_path)  # flush_every=4
    server.add_session(0)
    rng = np.random.default_rng(8)
    server.push(0, rng.normal(size=(250, 3)).astype(np.float32))
    server.poll(force=True)  # acks flushed at the poll boundary
    # journal hook level: buffer the resize record, then SIGKILL before
    # any flush — exactly what the chaos matrix's mid_resize point does
    server._journal.flush = lambda: None  # the crash window
    server.resize(target_batch=64)
    server.journal.kill()

    restored = FleetServer.restore(str(tmp_path / "j"), _StubModel())
    assert restored.config.target_batch == 8  # pre-resize capacity
    assert restored.stats.resizes == 0
    acct = restored.stats.accounting()
    assert acct["balanced"]


# ------------------------------------------- storage-fault containment


def test_journal_fsync_fault_contained_and_heals(tmp_path):
    """An fsync failure during poll() is a counted, declared
    degradation — events still deliver, ``journal_write_errors``
    counts, a RuntimeWarning fires — instead of an uncaught exception
    killing the serving loop; a later clean flush restores full
    durability with nothing lost (the records stayed buffered /
    sync-pending), pinned by a crash + restore after the heal."""
    import warnings as _warnings

    from har_tpu_torch.serve.faults import JournalFaults

    server = FleetServer(
        _StubModel(), window=100, hop=100, smoothing="ema",
        config=FleetConfig(max_sessions=4, max_delay_ms=0.0),
        journal=FleetJournal(
            str(tmp_path / "j"),
            JournalConfig(flush_every=512, snapshot_every=0),
        ),
    )
    for i in range(4):
        server.add_session(i)
    rng = np.random.default_rng(0)
    server.journal.fault = JournalFaults("fsync", at=1, times=2)
    delivered = 0
    with _warnings.catch_warnings(record=True) as caught:
        _warnings.simplefilter("always")
        for _ in range(3):
            for i in range(4):
                server.push(
                    i, rng.normal(size=(100, 3)).astype(np.float32)
                )
            delivered += len(server.poll(force=True))
    assert delivered == 12  # the loop never died, events delivered
    assert server.stats.journal_write_errors == 2
    assert not server._journal_degraded  # third flush healed
    warns = [
        w for w in caught if issubclass(w.category, RuntimeWarning)
        and "NOT durable" in str(w.message)
    ]
    assert len(warns) == 2
    # after the heal, everything is durable: SIGKILL + restore sees
    # every ack exactly once, and the error counter rides the healed
    # snapshot like any other stats counter
    server.write_snapshot()
    expected = server.stats.scored
    server.journal.kill()
    restored = FleetServer.restore(str(tmp_path / "j"), _StubModel())
    acct = restored.stats.accounting()
    assert acct["balanced"] and acct["scored"] == expected
    assert restored.stats.journal_write_errors == 2  # counter persists


def test_journal_write_fault_enospc_contained(tmp_path):
    """The ENOSPC flavor: the segment WRITE fails — the record buffer
    is kept (FleetJournal's retry-safe flush), serving continues, and
    once space 'frees' the buffered records land intact (no torn
    middle, no duplicates) — pinned through a crash + replay."""
    import warnings as _warnings

    from har_tpu_torch.serve.faults import JournalFaults

    server = FleetServer(
        _StubModel(), window=100, hop=100, smoothing="ema",
        config=FleetConfig(max_sessions=2, max_delay_ms=0.0),
        journal=FleetJournal(
            str(tmp_path / "j"),
            JournalConfig(flush_every=512, snapshot_every=0),
        ),
    )
    for i in range(2):
        server.add_session(i)
    rng = np.random.default_rng(1)
    server.journal.fault = JournalFaults("write", at=1, times=1)
    with _warnings.catch_warnings(record=True):
        _warnings.simplefilter("always")
        for i in range(2):
            server.push(
                i, rng.normal(size=(100, 3)).astype(np.float32)
            )
        events = server.poll(force=True)  # flush fails, contained
    assert len(events) == 2
    assert server.stats.journal_write_errors == 1
    assert server._journal_degraded
    server.poll(force=True)  # clean flush: the buffered records land
    assert not server._journal_degraded
    expected = server.stats.scored
    server.journal.kill()
    restored = FleetServer.restore(str(tmp_path / "j"), _StubModel())
    acct = restored.stats.accounting()
    assert acct["balanced"] and acct["scored"] == expected


def test_journal_fsync_then_write_fault_loses_nothing(tmp_path):
    """The COMPOUND storage fault: flush #1's write lands but its fsync
    fails (records now live ONLY in the file — the buffer is cleared),
    then flush #2's WRITE fails.  The failed-write rewind must truncate
    back to the end of flush #1's records, not the last fsync-durable
    offset — rewinding past write-landed-but-unsynced records would
    silently drop their acks while a later clean flush reports the
    journal fully healed.  Pinned through heal + crash + restore:
    every ack exactly once."""
    import warnings as _warnings

    from har_tpu_torch.serve.faults import JournalFaults

    server = FleetServer(
        _StubModel(), window=100, hop=100, smoothing="ema",
        config=FleetConfig(max_sessions=2, max_delay_ms=0.0),
        journal=FleetJournal(
            str(tmp_path / "j"),
            JournalConfig(flush_every=512, snapshot_every=0),
        ),
    )
    for i in range(2):
        server.add_session(i)
    rng = np.random.default_rng(3)

    def _round(fault_op):
        server.journal.fault = (
            JournalFaults(fault_op, at=1, times=1) if fault_op else None
        )
        for i in range(2):
            server.push(
                i, rng.normal(size=(100, 3)).astype(np.float32)
            )
        return len(server.poll(force=True))

    with _warnings.catch_warnings(record=True):
        _warnings.simplefilter("always")
        delivered = _round("fsync")   # write lands, fsync fails
        delivered += _round("write")  # write fails -> rewind
        delivered += _round(None)     # heals: everything lands
    assert delivered == 6  # the loop never died, events delivered
    assert server.stats.journal_write_errors == 2
    assert not server._journal_degraded
    expected = server.stats.scored
    server.journal.kill()
    restored = FleetServer.restore(str(tmp_path / "j"), _StubModel())
    acct = restored.stats.accounting()
    # every ack exactly once (the counter itself rides SNAPSHOTS, and
    # this test deliberately never writes one — see the fsync test for
    # the counter round-trip pin)
    assert acct["balanced"] and acct["scored"] == expected


def test_snapshot_refused_while_journal_degraded(tmp_path):
    """The acks-not-durable refusal: while a storage fault keeps the
    flush failing, write_snapshot refuses (warning, no new snap dir —
    a rotation would prune segments the un-flushed suffix still
    needs); the refusal lifts with the fault."""
    import warnings as _warnings

    from har_tpu_torch.serve.faults import JournalFaults

    server = FleetServer(
        _StubModel(), window=100, hop=100, smoothing="ema",
        config=FleetConfig(max_sessions=1, max_delay_ms=0.0),
        journal=FleetJournal(
            str(tmp_path / "j"),
            JournalConfig(flush_every=512, snapshot_every=0),
        ),
    )
    server.add_session(0)
    rng = np.random.default_rng(2)
    server.journal.fault = JournalFaults("fsync", at=1, times=100)
    with _warnings.catch_warnings(record=True):
        _warnings.simplefilter("always")
        server.push(0, rng.normal(size=(100, 3)).astype(np.float32))
        server.poll(force=True)
        assert server._journal_degraded
        snaps_before = sorted(
            n for n in os.listdir(tmp_path / "j")
            if n.startswith("snap.")
        )
        with pytest.warns(RuntimeWarning, match="snapshot refused"):
            server.write_snapshot()
        snaps_after = sorted(
            n for n in os.listdir(tmp_path / "j")
            if n.startswith("snap.")
        )
        assert snaps_after == snaps_before  # refused: nothing rotated
    server.journal.fault = None
    server.poll(force=True)  # heals
    server.write_snapshot()
    snaps_final = sorted(
        n for n in os.listdir(tmp_path / "j")
        if n.startswith("snap.")
    )
    assert len(snaps_final) == 1 and snaps_final != snaps_before
    server.journal.close()


def test_stats_ship_and_journal_error_counters_roundtrip():
    """The ship counters (shipped_bytes / ship_chunks / ship_resumes
    + journal_write_errors) round-trip through state()/load_state, and
    a PRE-ship state dict missing them entirely loads with zero
    defaults and no unknown-key warning — both directions pinned
    (HL002's runtime contract)."""
    s = FleetStats()
    s.enqueued = 2
    s.note_scored(2, "v1")
    s.shipped_bytes = 12345
    s.ship_chunks = 9
    s.ship_resumes = 1
    s.journal_write_errors = 3
    state = json.loads(json.dumps(s.state()))
    s2 = FleetStats()
    s2.load_state(state)
    assert s2.shipped_bytes == 12345
    assert s2.ship_chunks == 9
    assert s2.ship_resumes == 1
    assert s2.journal_write_errors == 3
    snap = s2.snapshot()
    assert snap["shipped_bytes"] == 12345
    assert snap["ship_chunks"] == 9
    assert snap["ship_resumes"] == 1
    assert snap["journal_write_errors"] == 3
    # pre-ship state: the counters absent entirely — zero defaults,
    # no unknown-key warning in either direction
    old = json.loads(json.dumps(state))
    for k in (
        "shipped_bytes", "ship_chunks", "ship_resumes",
        "journal_write_errors",
    ):
        old["counters"].pop(k)
    s3 = FleetStats()
    import warnings as _warnings

    with _warnings.catch_warnings():
        _warnings.simplefilter("error")
        s3.load_state(old)
    assert s3.shipped_bytes == 0
    assert s3.ship_chunks == 0
    assert s3.ship_resumes == 0
    assert s3.journal_write_errors == 0
    assert s3.accounting()["balanced"]


# ------------------------------------- ack-coalescing back-compat


def _decompose_acks(src_dir, dst_dir, *, window, hop, every=1):
    """Rewrite a journal directory, expanding each ``acks``
    group-commit record (every ``every``-th when > 1, for mixed logs)
    into the retired per-event ``ack`` layout the pre-coalescing
    writer produced — the fixture generator for the no-migration pin.
    Valid for drop-free logs: each session's acked t_index sequence is
    then window, window+hop, ... in consumption order."""
    import shutil

    os.makedirs(dst_dir, exist_ok=True)
    next_ti = {}
    k = 0
    for name in sorted(os.listdir(src_dir)):
        src = os.path.join(src_dir, name)
        if name.startswith("snap."):
            shutil.copytree(src, os.path.join(dst_dir, name))
            continue
        if not name.startswith("wal."):
            continue
        records, torn = read_segment(src)
        assert not torn
        out = []
        for meta, payload in records:
            if meta.get("t") != "acks":
                out.append(encode_record(meta, payload))
                continue
            k += 1
            if (k - 1) % every:
                out.append(encode_record(meta, payload))
                # the skipped group still consumes its sessions' tis
                for sid in meta["sids"]:
                    next_ti[sid] = next_ti.get(sid, window) + hop
                continue
            rows = np.frombuffer(payload, np.float64).reshape(
                int(meta["n"]), -1
            )
            for sid, row in zip(meta["sids"], rows):
                ti = next_ti.get(sid, window)
                next_ti[sid] = ti + hop
                out.append(
                    encode_record(
                        {
                            "t": "ack",
                            "sid": sid,
                            "ti": int(ti),
                            "ver": meta.get("ver", "v0"),
                            "shed": bool(meta.get("shed")),
                        },
                        row.tobytes(),
                    )
                )
        with open(os.path.join(dst_dir, name), "wb") as fh:
            fh.write(b"".join(out))


def _drive_acked_journal(tmp_path, name):
    """A drop-free journaled run with several retires: 4 sessions x
    500 samples in hop-sized chunks, polled every round, killed with
    a pending tail — the coalesced-``acks`` source log the back-compat
    fixtures decompose."""
    rng = np.random.default_rng(11)
    server = FleetServer(
        _StubModel(), window=100, hop=50, smoothing="ema",
        config=FleetConfig(
            max_sessions=16, target_batch=8, max_delay_ms=0.0
        ),
        journal=FleetJournal(
            str(tmp_path / name),
            JournalConfig(flush_every=4, snapshot_every=0),
        ),
    )
    recs = [rng.normal(size=(500, 3)).astype(np.float32) for _ in range(4)]
    for i in range(4):
        server.add_session(i)
    for start in range(0, 450, 50):
        for i in range(4):
            server.push(i, recs[i][start : start + 50])
        server.poll(force=True)
    # last chunk enqueued but never polled → pending at the kill
    for i in range(4):
        server.push(i, recs[i][450:])
    server.journal.kill()
    return str(tmp_path / name)


def _drain_fields(server):
    """Accounting + the drained tail's full event fields — the
    bit-identity currency the fixture restores are compared on."""
    events = [
        (
            e.session_id,
            e.event.t_index,
            e.event.label,
            e.event.raw_label,
            e.event.probability.tobytes(),
        )
        for e in server.flush()
    ]
    return events, server.stats.accounting()


def test_pre_coalescing_ack_journal_restores_bit_identical(tmp_path):
    """The no-migration pin, old half: a journal written in the
    RETIRED per-event ``ack`` layout (the pre-coalescing fixture,
    decomposed record-for-record from a real run's ``acks`` groups)
    restores bit-identically to the group-committed log — same
    accounting, same scored count, same drained tail to the byte —
    and restore leaves the old log's bytes untouched (read-side
    compat forever, never a rewrite)."""
    src = _drive_acked_journal(tmp_path, "new")
    old = str(tmp_path / "old")
    _decompose_acks(src, old, window=100, hop=50)
    before = {
        n: (tmp_path / "old" / n).read_bytes()
        for n in os.listdir(old)
        if n.startswith("wal.")
    }

    a = FleetServer.restore(src, _StubModel(), reattach=False)
    b = FleetServer.restore(old, _StubModel(), reattach=False)
    assert b.stats.recoveries == 1
    ev_a, acct_a = _drain_fields(a)
    ev_b, acct_b = _drain_fields(b)
    assert ev_b == ev_a and ev_b
    assert acct_b == acct_a
    assert acct_b["balanced"] and acct_b["pending"] == 0
    assert acct_b["scored"] > 0
    # no migration ever: the retired-layout log is byte-identical
    # after the restore read it
    after = {
        n: (tmp_path / "old" / n).read_bytes()
        for n in os.listdir(old)
        if n.startswith("wal.")
    }
    assert after == before


def test_mixed_ack_and_acks_journal_restores_bit_identical(tmp_path):
    """The no-migration pin, mixed half: a log alternating retired
    per-event ``ack`` runs with group-committed ``acks`` records (what
    a journal looks like mid-history, written before and after the
    coalescing change) replays through BOTH handlers in record order
    to the same state as the uniform log."""
    src = _drive_acked_journal(tmp_path, "new")
    mixed = str(tmp_path / "mixed")
    _decompose_acks(src, mixed, window=100, hop=50, every=2)
    kinds = set()
    for n in sorted(os.listdir(mixed)):
        if n.startswith("wal."):
            records, _ = read_segment(os.path.join(mixed, n))
            kinds.update(m["t"] for m, _ in records)
    assert {"ack", "acks"} <= kinds  # genuinely mixed

    a = FleetServer.restore(src, _StubModel(), reattach=False)
    b = FleetServer.restore(mixed, _StubModel(), reattach=False)
    ev_a, acct_a = _drain_fields(a)
    ev_b, acct_b = _drain_fields(b)
    assert ev_b == ev_a and ev_b
    assert acct_b == acct_a
    assert acct_b["balanced"] and acct_b["pending"] == 0


# ------------------------------------------- the port against har_tpu

XP_SESSIONS, XP_SAMPLES, XP_WINDOW, XP_HOP = 6, 600, 100, 50


def _xp(pkg):
    import importlib

    return (importlib.import_module(f"{pkg}.serve"),
            importlib.import_module(f"{pkg}.serve.chaos"))


def _xp_server(pkg, clock, journal=None):
    serve, _ = _xp(pkg)
    server = serve.FleetServer(
        serve.AnalyticDemoModel(), window=XP_WINDOW, hop=XP_HOP, channels=3,
        smoothing="ema",
        config=serve.FleetConfig(max_sessions=XP_SESSIONS, target_batch=8,
                                 max_delay_ms=0.0),
        clock=clock, journal=journal,
    )
    for i in range(XP_SESSIONS):
        server.add_session(i)
    return server


def _xp_deliver(pkg, server, clock, cursors, events):
    _, chaos = _xp(pkg)
    recordings = chaos._recordings(XP_SESSIONS, XP_SAMPLES, 3, 7)
    chaos._deliver(server, recordings, cursors, XP_SAMPLES, XP_HOP, clock, events)


def _journal_files(root):
    return sorted(
        os.path.relpath(os.path.join(d, f), root)
        for d, _, files in os.walk(root) for f in files
    )


def test_journal_byte_compatible_with_jax(tmp_path):
    """The same FakeClock run journaled by both packages: the same
    files, every WAL segment byte for byte, every snapshot's state.json
    key for key and arrays.npz array for array (names and dtypes)."""
    roots = {}
    for pkg in ("har_tpu_torch", "har_tpu"):
        serve, _ = _xp(pkg)
        root = str(tmp_path / pkg)
        journal = serve.FleetJournal(
            root, serve.JournalConfig(flush_every=4, snapshot_every=40))
        clock = serve.FakeClock()
        server = _xp_server(pkg, clock, journal)
        events: list = []
        _xp_deliver(pkg, server, clock, [0] * XP_SESSIONS, events)
        journal.close()
        assert events
        roots[pkg] = root
    ours, theirs = roots["har_tpu_torch"], roots["har_tpu"]
    files = _journal_files(ours)
    assert files == _journal_files(theirs)
    wal = [f for f in files if os.path.basename(f).startswith("wal.")]
    snaps = [f for f in files if f.endswith("state.json")]
    # older snapshots and segments are pruned: snap.3 is the third
    assert wal and snaps and snaps[-1] != "snap.0/state.json"
    for f in wal:
        with open(os.path.join(ours, f), "rb") as a, open(os.path.join(theirs, f), "rb") as b:
            assert a.read() == b.read(), f
    for f in snaps:
        with open(os.path.join(ours, f)) as a, open(os.path.join(theirs, f)) as b:
            assert json.load(a) == json.load(b), f
        npz = f.replace("state.json", "arrays.npz")
        with np.load(os.path.join(ours, npz)) as a, np.load(os.path.join(theirs, npz)) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("point, at", [
    ("post_score_pre_ack", 3), ("mid_dispatch", 4), ("mid_snapshot", 1),
    ("post_enqueue", 20),
])
@pytest.mark.parametrize("writer, reader", [
    ("har_tpu", "har_tpu_torch"), ("har_tpu_torch", "har_tpu"),
])
def test_journal_restores_across_packages(tmp_path, writer, reader, point, at):
    """A fleet journaled by one package and killed at a stage boundary
    restores in the other and continues: no event twice, none lost, and
    the union of both runs' events equals an unbroken run's bit for bit
    (the port's chaos verdict)."""
    from har_tpu_torch.serve.chaos import _verdict

    serve_w, chaos_w = _xp(writer)
    root = str(tmp_path / "wal")
    journal = serve_w.FleetJournal(
        root, serve_w.JournalConfig(flush_every=4, snapshot_every=40))
    clock = serve_w.FakeClock()
    server = _xp_server(writer, clock, journal)
    journal.chaos = chaos_w.KillPlan(point, at)
    pre: list = []
    with pytest.raises(chaos_w.SimulatedCrash):
        _xp_deliver(writer, server, clock, [0] * XP_SESSIONS, pre)
    journal.kill()

    serve_r, _ = _xp(reader)
    clock2 = serve_r.FakeClock(clock.t)
    restored = serve_r.FleetServer.restore(
        root, serve_r.AnalyticDemoModel(), clock=clock2)
    post = list(restored.poll(force=True))
    _xp_deliver(reader, restored, clock2,
                [restored.watermark(i) for i in range(XP_SESSIONS)], post)

    ref_clock = serve_r.FakeClock()
    ref: list = []
    _xp_deliver(reader, _xp_server(reader, ref_clock), ref_clock,
                [0] * XP_SESSIONS, ref)
    verdict = _verdict(point, ref, pre, post, restored, 0.0)
    assert verdict["ok"], verdict
    assert verdict["delivered_pre_crash"] > 0 and verdict["delivered_post_recovery"] > 0
