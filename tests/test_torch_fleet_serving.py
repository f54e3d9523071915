"""Fleet serving engine (har_tpu_torch.serve).

Pins the contracts the fleet ships on:
  1. equivalence — N multiplexed sessions emit bit-identical events to
     N independent StreamingClassifiers fed the same delivery chunks
     (bursty and in-order, smoothing on and off, drift monitors on);
  2. scheduling — deadline-aware micro-batching with power-of-two
     padded dispatches, bounded queues, admission control;
  3. degradation ORDER under injected stalls — smoothing shed first
     (events keep flowing), scoring shed second (stalest dropped),
     recovery in reverse, the producer never blocked;
  4. accounting — enqueued == scored + dropped (+ pending) always.
"""

import numpy as np
import pytest

from har_tpu_torch.serve import (
    AdmissionError,
    AnalyticDemoModel,
    DeliveryFaults,
    DispatchFaults,
    FakeClock,
    FleetConfig,
    FleetServer,
    drive_fleet,
    events_equal,
    fleet_slo_smoke,
    synthetic_sessions,
)
from har_tpu_torch.serving import StreamingClassifier


class _StubModel:
    """Row-deterministic numpy stand-in (mirrors test_serving's): class
    from the sign pattern of the window mean — per-row results are
    bit-identical under any batch composition."""

    num_classes = 3

    def transform(self, x):
        from har_tpu_torch.models.base import Predictions

        x = np.asarray(x)
        m = x.mean(axis=(1, 2))
        raw = np.stack([-m, m, np.zeros_like(m)], axis=-1)
        e = np.exp(raw - raw.max(axis=-1, keepdims=True))
        return Predictions.from_raw(raw, e / e.sum(axis=-1, keepdims=True))


def _recordings(n_sessions, n_samples=450, channels=3, seed=0):
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=(n_samples, channels)).astype(np.float32)
        for _ in range(n_sessions)
    ]


def _independent_events(model, chunks_by_session, **kwargs):
    """Replay each session's exact chunk sequence through a standalone
    StreamingClassifier; return {sid: [StreamEvent]}."""
    out = {}
    for sid, chunks in chunks_by_session.items():
        sc = StreamingClassifier(model, **kwargs)
        evs = []
        for c in chunks:
            evs.extend(sc.push(c))
        out[sid] = evs
    return out


def _fleet_events_by_session(events):
    out = {}
    for fe in events:
        out.setdefault(fe.session_id, []).append(fe.event)
    return out


@pytest.mark.parametrize("smoothing", ["ema", "vote", "none"])
def test_fleet_bit_identical_to_independent(smoothing):
    """The headline contract at N=64: interleaved in-order hop-chunk
    delivery across the fleet, events bit-identical per session."""
    n = 64
    model = _StubModel()
    recs = _recordings(n, n_samples=430, seed=1)
    server = FleetServer(
        model, window=100, hop=50, smoothing=smoothing,
        config=FleetConfig(max_sessions=n),
    )
    chunks_by_session = {i: [] for i in range(n)}
    for i in range(n):
        server.add_session(i)
    # round-robin in-order delivery, session-dependent chunk sizes so
    # batches mix sessions at different phases; poll interleaved with
    # delivery so scoring happens across many dispatches
    cursors = [0] * n
    rng = np.random.default_rng(7)
    all_events = []
    while any(c < len(recs[i]) for i, c in enumerate(cursors)):
        for i in range(n):
            if cursors[i] >= len(recs[i]):
                continue
            step = int(rng.integers(10, 90))
            chunk = recs[i][cursors[i] : cursors[i] + step]
            cursors[i] += step
            chunks_by_session[i].append(chunk)
            server.push(i, chunk)
        all_events.extend(server.poll(force=True))
    all_events.extend(server.flush())
    fleet = _fleet_events_by_session(all_events)

    want = _independent_events(
        model, chunks_by_session, window=100, hop=50, smoothing=smoothing
    )
    total = 0
    for i in range(n):
        got = fleet.get(i, [])
        assert len(got) == len(want[i])
        for g, w in zip(got, want[i]):
            assert events_equal(g, w)
            # bitwise, not allclose: the same shared smoother state
            # machine saw the same float inputs
            np.testing.assert_array_equal(g.probability, w.probability)
        total += len(got)
    assert total > n  # every session emitted


def test_fleet_bursty_delivery_bit_identical():
    """Whole-recording bursts (the catch-up path): one push per session
    completes many windows at once; still bit-identical."""
    n = 64
    model = _StubModel()
    recs = _recordings(n, n_samples=800, seed=2)
    server = FleetServer(
        model, window=200, hop=100, smoothing="ema",
        config=FleetConfig(max_sessions=n),
    )
    for i in range(n):
        server.add_session(i)
        server.push(i, recs[i])
    fleet = _fleet_events_by_session(server.flush())
    want = _independent_events(
        model, {i: [recs[i]] for i in range(n)},
        window=200, hop=100, smoothing="ema",
    )
    for i in range(n):
        assert [e.t_index for e in fleet[i]] == [
            e.t_index for e in want[i]
        ]
        assert all(events_equal(g, w) for g, w in zip(fleet[i], want[i]))


def test_fleet_drift_monitors_flow_and_match():
    """Per-session DriftMonitors: verdicts flow into the multiplexed
    stream and equal a standalone classifier's on the same chunks."""
    from har_tpu_torch.monitoring import DriftMonitor

    model = _StubModel()
    rng = np.random.default_rng(3)
    base = rng.normal(0, 1, size=(600, 3)).astype(np.float32)
    shifted = (base + 25.0).astype(np.float32)  # way out of reference
    server = FleetServer(
        model, window=100, hop=50, smoothing="none",
        config=FleetConfig(max_sessions=2),
    )
    server.add_session("ok", monitor=DriftMonitor(np.zeros(3), np.ones(3)))
    server.add_session(
        "bad", monitor=DriftMonitor(np.zeros(3), np.ones(3))
    )
    chunks = {"ok": [], "bad": []}
    for start in range(0, 600, 50):
        for sid, rec in (("ok", base), ("bad", shifted)):
            c = rec[start : start + 50]
            chunks[sid].append(c)
            server.push(sid, c)
    fleet = _fleet_events_by_session(server.flush())
    assert not any(e.drift for e in fleet["ok"])
    assert any(e.drift for e in fleet["bad"])
    assert server.drift_report("bad").drifting

    def mk():
        return DriftMonitor(np.zeros(3), np.ones(3))

    for sid in ("ok", "bad"):
        sc = StreamingClassifier(
            model, window=100, hop=50, smoothing="none", monitor=mk()
        )
        want = []
        for c in chunks[sid]:
            want.extend(sc.push(c))
        assert [e.drift for e in fleet[sid]] == [e.drift for e in want]


def test_micro_batcher_deadline_and_padding():
    """Windows below target_batch wait for the deadline, then dispatch
    as ONE power-of-two padded batch."""
    clock = FakeClock()
    model = _StubModel()
    server = FleetServer(
        model, window=100, hop=100, smoothing="none",
        config=FleetConfig(target_batch=256, max_delay_ms=50.0),
        clock=clock,
    )
    for i in range(5):
        server.add_session(i)
        server.push(i, np.zeros((100, 3), np.float32))
    assert server.stats.enqueued == 5
    assert not server.due(clock())
    assert server.poll() == []  # not due: no deadline passed, < batch
    clock.advance(0.051)
    assert server.due(clock())
    events = server.poll()
    assert len(events) == 5
    assert server.stats.dispatches == 1
    assert server.stats.batch_sizes == {8: 1}  # 5 padded to 8


def test_full_batch_dispatches_without_deadline():
    clock = FakeClock()
    server = FleetServer(
        _StubModel(), window=10, hop=10, smoothing="none",
        config=FleetConfig(target_batch=16, max_delay_ms=1e9),
        clock=clock,
    )
    server.add_session(0)
    server.push(0, np.zeros((10 * 16, 3), np.float32))  # 16 windows
    assert server.due(clock())
    assert len(server.poll()) == 16
    assert server.stats.batch_sizes == {16: 1}


def test_constructor_validates_smoothing_knobs():
    """Bad smoothing knobs fail at construction (same guards as
    StreamingClassifier), never inside poll() with windows queued."""
    with pytest.raises(ValueError, match="ema_alpha"):
        FleetServer(_StubModel(), smoothing="ema", ema_alpha=0.0)
    with pytest.raises(ValueError, match="vote_depth"):
        FleetServer(_StubModel(), smoothing="vote", vote_depth=0)
    with pytest.raises(ValueError, match="smoothing"):
        FleetServer(_StubModel(), smoothing="mean")


def test_slo_sees_failed_attempt_time():
    """dispatch_ms covers the WHOLE dispatch, failed attempts included:
    a stall-then-fail absorbed by the retry path still reads as an SLO
    breach — the ladder must not be blinded by a fast retry."""
    clock = FakeClock()
    calls = {"n": 0}

    def stall_then_fail_once(windows):
        calls["n"] += 1
        if calls["n"] % 2 == 1:  # first attempt per dispatch
            clock.advance(2.0)  # 2 s stall, then the attempt dies
            raise RuntimeError("injected stall-then-fail")

    server = FleetServer(
        _StubModel(), window=10, hop=10, smoothing="none",
        config=FleetConfig(
            retries=1, target_batch=4, max_delay_ms=0.0,
            dispatch_timeout_ms=1000.0, degrade_after_breaches=1,
        ),
        fault_hook=stall_then_fail_once,
        clock=clock,
    )
    server.add_session(0)
    server.push(0, np.zeros((40, 3), np.float32))
    events = server.poll(force=True)
    assert len(events) == 4  # the retry succeeded — no windows lost
    assert server.stats.dispatch_retries == 1
    assert server.stats.dropped == {}
    assert server.stats.slo_breaches == 1  # the stalled attempt counted
    assert server.stats.dispatch.max_ms >= 2000.0


def test_admission_control_and_unknown_session():
    server = FleetServer(
        _StubModel(), window=10, hop=10,
        config=FleetConfig(max_sessions=2),
    )
    server.add_session("a")
    server.add_session("b")
    with pytest.raises(AdmissionError, match="full"):
        server.add_session("c")
    assert server.stats.admission_rejections == 1
    with pytest.raises(AdmissionError, match="already"):
        server.add_session("a")
    with pytest.raises(AdmissionError, match="unknown"):
        server.push("zzz", np.zeros((10, 3), np.float32))
    server.remove_session("a")
    server.add_session("c")  # slot freed
    assert set(server.sessions) == {"b", "c"}


def test_session_queue_bound_sheds_own_oldest():
    """A session over max_pending sheds ITS OWN stalest windows; peers
    are untouched and accounting stays balanced."""
    server = FleetServer(
        _StubModel(), window=10, hop=10, smoothing="none",
        config=FleetConfig(
            max_pending_per_session=4, target_batch=1024,
            max_delay_ms=1e9,
        ),
    )
    server.add_session("noisy")
    server.add_session("quiet")
    server.push("quiet", np.zeros((20, 3), np.float32))  # 2 windows
    server.push("noisy", np.ones((100, 3), np.float32))  # 10 windows
    assert server.stats.dropped == {"session_queue": 6}
    events = server.flush()
    by_sid = _fleet_events_by_session(events)
    assert len(by_sid["quiet"]) == 2  # peer unaffected
    assert len(by_sid["noisy"]) == 4  # newest 4 kept (oldest shed)
    assert [e.t_index for e in by_sid["noisy"]] == [70, 80, 90, 100]
    acct = server.stats.accounting()
    assert acct["enqueued"] == acct["scored"] + acct["dropped"]
    assert acct["pending"] == 0


def test_global_backpressure_sheds_stalest():
    server = FleetServer(
        _StubModel(), window=10, hop=10, smoothing="none",
        config=FleetConfig(
            max_queue_windows=8, max_pending_per_session=1024,
            target_batch=1024, max_delay_ms=1e9,
        ),
    )
    server.add_session(0)
    server.add_session(1)
    server.push(0, np.zeros((60, 3), np.float32))  # 6 windows
    server.push(1, np.zeros((60, 3), np.float32))  # 6 more -> 12 > 8
    assert server.stats.dropped == {"backpressure": 4}
    # stalest = session 0's first four windows (earliest enqueued)
    by_sid = _fleet_events_by_session(server.flush())
    assert [e.t_index for e in by_sid[0]] == [50, 60]
    assert len(by_sid[1]) == 6
    assert server.stats.queue_depth == 0


def test_degradation_order_smoothing_then_shedding_then_recovery():
    """The ladder, in order: SLO breaches shed smoothing FIRST (events
    keep flowing, raw labels, state frozen), further breaches shed the
    stalest windows, and within-SLO dispatches recover."""
    clock = FakeClock()
    faults = DispatchFaults(
        stall_every=1, stall_ms=2000.0, fake_clock=clock
    )
    server = FleetServer(
        _StubModel(), window=10, hop=10, smoothing="ema",
        config=FleetConfig(
            target_batch=4, max_delay_ms=0.0, dispatch_timeout_ms=1000.0,
            degrade_after_breaches=2, recover_after_ok=2,
        ),
        fault_hook=faults,
        clock=clock,
    )
    server.add_session(0)

    def feed_and_poll(n_windows):
        server.push(0, np.zeros((10 * n_windows, 3), np.float32))
        return server.poll(force=True)

    # breaches 1+2: smoothing shed entered, but NOTHING dropped yet —
    # scoring is shed only after smoothing
    ev1 = feed_and_poll(2)
    assert not ev1[0].degraded and not server.smoothing_shed
    ev2 = feed_and_poll(2)
    assert server.smoothing_shed
    assert server.stats.dropped == {}
    # next batch emits degraded (raw-label) events, still zero drops
    ev3 = feed_and_poll(2)
    assert all(e.degraded for e in ev3)
    assert all(e.event.label == e.event.raw_label for e in ev3)
    assert server.stats.degraded_events == len(ev3)
    assert server.stats.dropped == {}
    # two more breaches while already shed -> level 2: stalest windows
    # dropped (shed_fraction of the live queue at breach time)
    server.push(0, np.zeros((10 * 8, 3), np.float32))
    ev4 = server.poll(force=True)  # first batch breaches -> sheds rest
    assert server.stats.dropped.get("slo_shed", 0) > 0
    # recovery: stalls stop, within-SLO dispatches un-shed smoothing
    faults.stall_every = 0
    feed_and_poll(2)
    feed_and_poll(2)
    assert not server.smoothing_shed
    ev5 = feed_and_poll(2)
    assert not any(e.degraded for e in ev5)
    acct = server.stats.accounting()
    assert acct["enqueued"] == acct["scored"] + acct["dropped"]
    assert len(ev4) >= 1  # the breaching batch itself still emitted


def test_dispatch_retry_absorbs_transient_failure():
    faults = DispatchFaults(fail_every=2)  # every 2nd ATTEMPT fails
    server = FleetServer(
        _StubModel(), window=10, hop=10, smoothing="none",
        config=FleetConfig(retries=1, target_batch=4, max_delay_ms=0.0),
        fault_hook=faults,
    )
    server.add_session(0)
    server.push(0, np.zeros((40, 3), np.float32))
    events = server.poll(force=True)
    assert len(events) == 4  # attempt 1 ok (4 windows in 1 batch)
    server.push(0, np.zeros((40, 3), np.float32))
    events = server.poll(force=True)  # attempt 2 fails, retry 3 ok
    assert len(events) == 4
    assert server.stats.dispatch_retries == 1
    assert server.stats.dispatch_failures == 0
    assert server.stats.dropped == {}


def test_dispatch_failure_drops_batch_and_keeps_serving():
    faults = DispatchFaults(fail_every=1)  # every attempt fails
    server = FleetServer(
        _StubModel(), window=10, hop=10, smoothing="none",
        config=FleetConfig(retries=1, target_batch=4, max_delay_ms=0.0),
        fault_hook=faults,
    )
    server.add_session(0)
    server.push(0, np.zeros((40, 3), np.float32))
    assert server.poll(force=True) == []
    assert server.stats.dispatch_failures == 1
    assert server.stats.dropped == {"dispatch_failed": 4}
    # the engine keeps serving once the fault clears
    faults.fail_every = 0
    server.push(0, np.zeros((40, 3), np.float32))
    assert len(server.poll(force=True)) == 4
    acct = server.stats.accounting()
    assert acct["enqueued"] == 8
    assert acct["scored"] == 4 and acct["dropped"] == 4


def test_stats_accounting_under_faulty_delivery():
    """enqueued == scored + dropped with transport faults in the mix
    (delivery drops/delays change WHICH windows exist, never the
    conservation law)."""
    n = 16
    model = AnalyticDemoModel()
    recs, _ = synthetic_sessions(n, windows_per_session=3, seed=5)
    server = FleetServer(
        model, window=200, hop=200, smoothing="ema",
        config=FleetConfig(max_sessions=n),
    )
    for i in range(n):
        server.add_session(i)
    _, report = drive_fleet(
        server, recs, seed=5,
        faults=DeliveryFaults(
            drop_prob=0.1, delay_prob=0.2, burst_prob=0.1
        ),
    )
    assert report.dropped_deliveries > 0
    assert report.delayed_deliveries > 0
    acct = server.stats.accounting()
    assert acct["pending"] == 0
    assert acct["enqueued"] == acct["scored"] + acct["dropped"]
    assert acct["enqueued"] == report.windows_enqueued
    snap = server.stats_snapshot()
    assert snap["accounting"]["balanced"]
    assert snap["stages"]["dispatch_ms"]["count"] == snap["dispatches"]


def test_loadgen_deterministic():
    model = AnalyticDemoModel()
    outs = []
    for _ in range(2):
        recs, _ = synthetic_sessions(8, windows_per_session=2, seed=9)
        server = FleetServer(
            model, window=200, hop=200,
            config=FleetConfig(max_sessions=8),
        )
        for i in range(8):
            server.add_session(i)
        events, report = drive_fleet(
            server, recs, seed=9,
            faults=DeliveryFaults(drop_prob=0.2, delay_prob=0.2),
        )
        outs.append(
            (
                report.dropped_deliveries,
                report.delayed_deliveries,
                [(e.session_id, e.event.t_index, e.event.label)
                 for e in events],
            )
        )
    assert outs[0] == outs[1]


def test_device_calibration_stamps_events_and_attribution():
    """A neural model's fleet events carry the per-event device share
    after calibration, and the snapshot attributes dispatch p99."""
    from har_tpu_torch.data.raw_windows import synthetic_raw_stream
    from har_tpu_torch.features.wisdm_pipeline import FeatureSet
    from har_tpu_torch.models.neural_classifier import NeuralClassifier
    from har_tpu_torch.train.trainer import TrainerConfig

    raw = synthetic_raw_stream(n_windows=64, seed=0)
    model = NeuralClassifier(
        "cnn1d",
        config=TrainerConfig(batch_size=64, epochs=1, learning_rate=1e-3,
                             seed=0),
        model_kwargs={"channels": (8,)},
        device="cpu",
    ).fit(FeatureSet(features=raw.windows,
                     label=raw.labels.astype(np.int32)))
    server = FleetServer(
        model, window=200, hop=200, smoothing="none",
        config=FleetConfig(max_sessions=4),
    )
    for i in range(4):
        server.add_session(i)
        server.push(i, raw.windows[i].reshape(-1, 3))
    ev_before = server.flush()
    assert all(e.event.device_ms is None for e in ev_before)
    server.calibrate_device(iters=4)
    assert 4 in server._device_ms  # the padded size actually dispatched
    for i in range(4):
        server.push(i, raw.windows[4 + i].reshape(-1, 3))
    ev_after = server.flush()
    assert all(e.event.device_ms is not None for e in ev_after)
    for e in ev_after:
        assert 0 <= e.event.device_ms
    snap = server.stats_snapshot()
    assert snap["device_ms"]
    attr = snap["dispatch_p99_attribution"]
    assert attr["dominated_by"] in ("host_tunnel", "device")
    assert attr["host_overhead_ms"] >= 0
    # a host-side stub has no device program: calibration refuses
    stub_server = FleetServer(_StubModel(), window=10, hop=10)
    with pytest.raises(ValueError, match="device timing"):
        stub_server.calibrate_device()


def test_slo_smoke_verdict():
    out = fleet_slo_smoke(sessions=24, seed=1)
    assert out["ok"] is True
    assert out["equivalent"] is True
    assert out["dropped"] == 0
    assert out["sessions"] == 24
    assert out["p99_ms"] is not None
    assert out["accounting_balanced"]


# ------------------------------------------- the port against har_tpu


def _pair_models(kind):
    """(port model, har_tpu model): the same numpy model in each package."""
    import har_tpu.serve as jax_serve
    import har_tpu_torch.serve as port_serve

    if kind == "stub":
        from har_tpu.serve.loadgen import HostPlaneStubModel as JaxStub
        from har_tpu_torch.serve.loadgen import HostPlaneStubModel as PortStub

        return PortStub(), JaxStub()
    return port_serve.AnalyticDemoModel(), jax_serve.AnalyticDemoModel()


# name -> (FleetConfig kwargs, DeliveryFaults kwargs, DispatchFaults
# kwargs, drive_fleet kwargs, windows per session)
SCENARIOS = {
    "in_order": (dict(target_batch=16), {}, {}, {}, 3),
    "bursty_drops_delays": (
        dict(target_batch=16),
        dict(drop_prob=0.1, delay_prob=0.15, burst_prob=0.1, burst_rounds=3),
        {}, {}, 4,
    ),
    "stalls_and_ladder": (
        dict(target_batch=8, max_delay_ms=0.0, dispatch_timeout_ms=1000.0,
             degrade_after_breaches=2, recover_after_ok=2),
        dict(delay_prob=0.1),
        dict(stall_every=1, stall_ms=1500.0, fail_every=7), {}, 4,
    ),
    "backpressure_shedding": (
        dict(target_batch=8, max_pending_per_session=2, max_queue_windows=24),
        dict(burst_prob=0.3, burst_rounds=4), {}, dict(poll_every=3), 5,
    ),
}


def _drive_pkg(pkg, model, scenario, smoothing, sessions=24, seed=3):
    """One package's fleet on one scenario under a FakeClock: its
    events, stats snapshot and AdmissionError count."""
    import importlib

    serve = importlib.import_module(f"{pkg}.serve")
    cfg, delivery, dispatch, drive, wps = SCENARIOS[scenario]
    clock = serve.FakeClock()
    faults = (serve.DispatchFaults(fake_clock=clock, **dispatch)
              if dispatch else None)
    server = serve.FleetServer(
        model, window=200, hop=100, smoothing=smoothing,
        config=serve.FleetConfig(max_sessions=sessions - 4, **cfg),
        fault_hook=faults, clock=clock,
    )
    refused = 0
    for i in range(sessions):
        try:
            server.add_session(i)
        except serve.AdmissionError:
            refused += 1
    admitted = sessions - refused
    recordings, _ = serve.synthetic_sessions(
        admitted, windows_per_session=wps, seed=seed)
    events, report = serve.drive_fleet(
        server, recordings, seed=seed,
        faults=serve.DeliveryFaults(**delivery), **drive)
    snap = server.stats.snapshot()
    return events, snap, refused, report


def _event_tuple(fe):
    ev = fe.event
    return (fe.session_id, fe.degraded, ev.t_index, ev.label, ev.raw_label,
            ev.drift, ev.latency_ms, ev.device_ms, ev.probability.tobytes())


@pytest.mark.parametrize("kind", ["analytic", "stub"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("smoothing", ["ema", "vote", "none"])
def test_fleet_events_equal_jax_field_for_field(smoothing, scenario, kind):
    """The same numpy model, the same seeded sessions and delivery
    faults, the same FakeClock: every fleet event equals har_tpu's field
    for field (latency read off the fake clock included), and so do the
    admission refusals, the accounting, the drops by reason and the
    ladder's counters."""
    port_model, jax_model = _pair_models(kind)
    ours = _drive_pkg("har_tpu_torch", port_model, scenario, smoothing)
    theirs = _drive_pkg("har_tpu", jax_model, scenario, smoothing)
    assert ours[0], "the scenario emitted nothing"
    assert [_event_tuple(e) for e in ours[0]] == [_event_tuple(e) for e in theirs[0]]
    assert ours[2] == theirs[2] == 4
    a, b = ours[1], theirs[1]
    assert a == b  # the whole stats snapshot, stage histograms included
    assert a["accounting"]["balanced"]
    if "drop_prob" in SCENARIOS[scenario][1]:
        assert ours[3].dropped_deliveries == theirs[3].dropped_deliveries > 0
    if scenario == "stalls_and_ladder":
        assert a["degraded_events"] > 0 and a["dispatch_retries"] > 0
        assert a["dropped_by_reason"].get("slo_shed", 0) > 0
    if scenario == "backpressure_shedding":
        assert set(a["dropped_by_reason"]) == {"session_queue", "backpressure"}
