"""The port's elastic traffic engine against ``har_tpu``'s on the same
inputs: every kind of trace schedules the same sessions, rates and spec
in both packages, the shared sample pool is bit-equal, and a drive of
the analytic demo model on a FakeClock — plain and autoscaled — emits
the same events, takes the same controller actions and ends in the same
stats snapshot.  Tolerance: equal (numpy host model, one FakeClock).
"""

import importlib
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SPECS = {
    "diurnal": dict(kind="diurnal", peak_sessions=40, swing=10.0, rounds=120,
                    period=60, seed=3),
    "bursty": dict(kind="bursty", peak_sessions=24, swing=6.0, rounds=48,
                   period=48, storms=((30, 0.25),), burst_prob=0.3, burst_size=4,
                   slow_prob=0.1, rate_mix=(1, 2), seed=9),
    "storm": dict(kind="storm", peak_sessions=24, swing=8.0, rounds=40,
                  period=40, storms=((26, 0.5),), slow_prob=0.1, slow_rounds=2,
                  rate_mix=(1, 2), seed=11),
}


def _traffic(pkg):
    return importlib.import_module(f"{pkg}.serve.traffic")


@pytest.mark.parametrize("name", sorted(SPECS))
def test_trace_schedule_and_spec_equal_jax(name):
    ours = _traffic("har_tpu_torch").TrafficTrace(
        _traffic("har_tpu_torch").TraceSpec(**SPECS[name]))
    theirs = _traffic("har_tpu").TrafficTrace(
        _traffic("har_tpu").TraceSpec(**SPECS[name]))
    assert ours.schedule == theirs.schedule
    assert ours.rate_of == theirs.rate_of
    assert ours.spec() == theirs.spec()
    for key in ("total_sessions", "peak_active", "trough_active",
                "storm_disconnects"):
        assert getattr(ours, key) == getattr(theirs, key), key
    # a spec exported by one package replays in the other
    replay = _traffic("har_tpu_torch").TrafficTrace.from_spec(
        json.loads(json.dumps(theirs.spec())))
    assert replay.schedule == theirs.schedule


def test_sample_pool_bit_equal_jax():
    from har_tpu.serve.traffic.generate import _pool as jax_pool
    from har_tpu_torch.serve.traffic.generate import _pool

    for name, spec in SPECS.items():
        for hop in (100, 200):
            a = _pool(_traffic("har_tpu_torch").TraceSpec(**spec), hop)
            b = jax_pool(_traffic("har_tpu").TraceSpec(**spec), hop)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (name, hop)


def _drive(pkg, name, autoscale):
    serve = importlib.import_module(f"{pkg}.serve")
    traffic = _traffic(pkg)
    clock = serve.FakeClock()
    server = serve.FleetServer(
        serve.AnalyticDemoModel(), window=200, hop=100, smoothing="ema",
        config=serve.FleetConfig(max_sessions=4096, target_batch=8,
                                 max_delay_ms=0.0),
        clock=clock,
    )
    controller = None
    if autoscale:
        controller = traffic.CapacityController(
            server,
            config=traffic.AutoscaleConfig(
                min_target_batch=8, max_target_batch=32, max_depth=2,
                queue_high=1.0, util_low=0.3, up_after=1, down_after=2,
                cooldown_s=0.0,
            ),
            clock=clock,
        )
    events, report = traffic.drive_trace(
        server, traffic.TrafficTrace(traffic.TraceSpec(**SPECS[name])),
        clock=clock,
        on_round=controller.on_round if controller is not None else None,
    )
    ev = [(fe.session_id, fe.degraded, fe.event.t_index, fe.event.label,
           fe.event.raw_label, fe.event.latency_ms, fe.event.probability.tobytes())
          for fe in events]
    rep = {k: v for k, v in report.__dict__.items() if k != "duration_s"}
    return dict(events=ev, report=rep, snap=server.stats.snapshot(),
                actions=None if controller is None else controller.actions,
                status=None if controller is None else controller.status())


@pytest.mark.parametrize("autoscale", [False, True], ids=["static", "autoscaled"])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_drive_trace_equals_jax(name, autoscale):
    ours = _drive("har_tpu_torch", name, autoscale)
    theirs = _drive("har_tpu", name, autoscale)
    assert ours["events"], "the trace emitted nothing"
    assert ours["events"] == theirs["events"]
    assert ours["report"] == theirs["report"]
    assert ours["snap"] == theirs["snap"]  # the whole stats snapshot
    assert ours["actions"] == theirs["actions"]  # the resize log
    assert ours["status"] == theirs["status"]
    acct = ours["snap"]["accounting"]
    assert acct["balanced"] and acct["pending"] == 0
    if autoscale:
        knobs = {(a["action"], a["knob"]) for a in ours["actions"]}
        assert ("up", "target_batch") in knobs
        assert ours["snap"]["scale_downs"] >= 1
