"""Elastic traffic engine (har_tpu_torch.serve.traffic).

The JAX package's tests/test_traffic.py on the port, with the imports
renamed and ``--device cpu`` for the CLI (its cluster cases on the
port's ``FleetCluster``), and one case more walks the mesh ladder.  It
pins the contracts the elastic subsystem ships on:

  1. a trace is a REPLAYABLE ARTIFACT — ``TrafficTrace.from_spec(
     trace.spec())`` (through a JSON round-trip) rebuilds the identical
     schedule, and driving the replayed trace emits bit-identical
     events;
  2. churn is GRACEFUL — ``disconnect_session`` flushes the
     assembler's partial window (one off-grid final event at
     ``t_index = n_seen``) and settles the pending queue BEFORE the
     ``remove`` journal record, so accepted data never silently
     vanishes;
  3. the capacity controller is a HYSTERESIS/COOLDOWN policy loop that
     walks the target_batch → pipeline_depth ladder up and retraces it
     exactly on the way down, never acting on one noisy poll;
  4. conservation holds through all of it: a full diurnal-storm drive
     with online resizes ends balanced with zero undeclared drops.
The port against ``har_tpu`` on the same inputs is in
tests/test_torch_traffic_cross.py.
"""

import json
import os

import numpy as np
import pytest
import torch

from har_tpu_torch.serve import (
    AdmissionError,
    AutoscaleConfig,
    CapacityController,
    FakeClock,
    FleetConfig,
    FleetServer,
    TraceSpec,
    TrafficTrace,
    drive_trace,
)
from har_tpu_torch.serve.journal import FleetJournal, JournalConfig
from har_tpu_torch.serve.traffic.smoke import DECLARED_SHEDS, undeclared_drops

torch.set_num_threads(1)


class _StubModel:
    """Host-side deterministic stand-in (row-independent numpy)."""

    num_classes = 3

    def transform(self, x):
        from har_tpu_torch.models.base import Predictions

        x = np.asarray(x)
        m = x.mean(axis=(1, 2))
        raw = np.stack([-m, m, np.zeros_like(m)], axis=-1)
        e = np.exp(raw - raw.max(axis=-1, keepdims=True))
        return Predictions.from_raw(raw, e / e.sum(axis=-1, keepdims=True))


def _server(clock=None, **cfg):
    defaults = dict(max_sessions=4096, target_batch=8, max_delay_ms=0.0)
    defaults.update(cfg)
    return FleetServer(
        _StubModel(), window=100, hop=50, smoothing="ema",
        config=FleetConfig(**defaults), clock=clock,
    )


def _decisions(events):
    out = {}
    for fe in events:
        ev = fe.event
        out.setdefault(fe.session_id, []).append(
            (ev.t_index, ev.label, ev.raw_label, ev.drift,
             ev.probability.tobytes())
        )
    return out


# ------------------------------------------------------- trace shapes


def test_trace_spec_validation():
    with pytest.raises(ValueError):
        TraceSpec(kind="weekly")
    with pytest.raises(ValueError):
        TraceSpec(swing=0.5)
    with pytest.raises(ValueError):
        TraceSpec(period=1)
    with pytest.raises(ValueError):
        TraceSpec(rate_mix=())
    with pytest.raises(ValueError):
        TraceSpec(rate_mix=(1, 0))


def test_diurnal_trace_shape_and_churn():
    """The sinusoid holds its contract: trough at round 0, peak
    mid-period, peak/trough ≈ swing; scale-down evicts oldest first."""
    spec = TraceSpec(
        kind="diurnal", peak_sessions=40, swing=10.0, rounds=120,
        period=60, seed=3,
    )
    trace = TrafficTrace(spec)
    assert trace.peak_active == 40
    assert trace.trough_active <= 40 / 10.0 + 1
    assert trace.peak_active / max(trace.trough_active, 1) >= 8.0
    # churn is real: the overnight cohort disconnects and DAY TWO's
    # upslope connects fresh sessions — the total session population
    # over two periods exceeds the concurrent peak
    assert trace.total_sessions > trace.peak_active
    # scale-down disconnects the OLDEST sessions (the morning cohort
    # leaves first): every disconnect batch is an ascending-sid prefix
    # of the still-active population at that round
    active = []
    for step in trace.schedule:
        for sid in step["disconnect"]:
            assert sid == active.pop(0)
        active.extend(step["connect"])
        for sid in step["disconnect"]:
            assert sid not in active


def test_storm_disconnects_oldest_cohort_at_once():
    spec = TraceSpec(
        kind="storm", peak_sessions=32, swing=4.0, rounds=40, period=40,
        storms=((20, 0.5),), seed=1,
    )
    trace = TrafficTrace(spec)
    assert trace.storm_disconnects > 0
    # at the storm round, a mass of disconnects lands in one step
    step = trace.schedule[20]
    assert len(step["disconnect"]) >= trace.storm_disconnects


def test_trace_replay_roundtrip_is_identical():
    """Export/replay: the spec dict survives JSON and rebuilds the
    exact same schedule AND rate assignment on any host."""
    spec = TraceSpec(
        kind="bursty", peak_sessions=24, swing=6.0, rounds=48, period=48,
        storms=((30, 0.25),), burst_prob=0.3, burst_size=4,
        slow_prob=0.1, rate_mix=(1, 2), seed=9,
    )
    trace = TrafficTrace(spec)
    replay = TrafficTrace.from_spec(json.loads(json.dumps(trace.spec())))
    assert replay.schedule == trace.schedule
    assert replay.rate_of == trace.rate_of
    assert replay.spec() == trace.spec()


def test_drive_trace_deterministic_and_replayable():
    """Two drives of the same spec — one from the original trace, one
    from its exported spec — emit bit-identical event streams with
    balanced accounting."""
    spec = TraceSpec(
        kind="storm", peak_sessions=16, swing=4.0, rounds=24, period=24,
        storms=((16, 0.5),), slow_prob=0.2, slow_rounds=2,
        rate_mix=(1, 2), seed=5,
    )

    def run(trace):
        clock = FakeClock()
        server = _server(clock=clock)
        events, report = drive_trace(server, trace, clock=clock)
        acct = server.stats.accounting()
        assert acct["balanced"] and acct["pending"] == 0
        assert undeclared_drops(server.stats.snapshot()) == 0
        return events, report

    ev1, rep1 = run(TrafficTrace(spec))
    ev2, rep2 = run(
        TrafficTrace.from_spec(json.loads(json.dumps(TrafficTrace(spec).spec())))
    )
    d1, d2 = _decisions(ev1), _decisions(ev2)
    assert d1.keys() == d2.keys()
    for sid in d1:
        assert d1[sid] == d2[sid]
    assert rep1.windows_enqueued == rep2.windows_enqueued
    assert rep1.samples_delivered == rep2.samples_delivered


def test_slow_clients_flush_on_hangup_never_lose_samples():
    """A stalled uplink's held chunks arrive as one catch-up burst —
    and a session that hangs up mid-stall flushes them BEFORE the
    goodbye.  Conservation: everything accepted scores."""
    spec = TraceSpec(
        kind="storm", peak_sessions=12, swing=3.0, rounds=20, period=20,
        storms=((14, 1.0),), slow_prob=0.6, slow_rounds=3, seed=7,
    )
    server = _server()
    events, report = drive_trace(server, TrafficTrace(spec))
    assert report.slow_stalls > 0
    assert report.storm_disconnects > 0
    acct = server.stats.accounting()
    assert acct["balanced"] and acct["pending"] == 0
    assert server.stats.enqueued == server.stats.scored
    assert undeclared_drops(server.stats.snapshot()) == 0


# -------------------------------------------- graceful disconnect


def test_disconnect_flushes_partial_window_and_settles():
    """THE churn fix (the loadgen's steady-state assumption): a session
    leaving mid-stream emits one final off-grid window covering its
    ring tail, and every queued window settles before the eviction."""
    server = _server()
    server.add_session(0)
    # 120 samples: one grid window due at t=100, then a 20-sample tail
    # past the hop boundary that steady-state serving would strand
    server.push(0, np.random.default_rng(0).normal(
        size=(120, 3)).astype(np.float32))
    events = server.disconnect_session(0)
    assert [e.event.t_index for e in events] == [100, 120]
    assert 120 % server.hop != 0  # genuinely off the hop grid
    assert 0 not in server._sessions
    acct = server.stats.accounting()
    assert acct["balanced"] and acct["pending"] == 0
    assert server.stats.enqueued == server.stats.scored == 2
    with pytest.raises(AdmissionError):
        server.disconnect_session(0)


def test_disconnect_on_grid_session_has_nothing_to_flush():
    """A recording that ends exactly on the hop grid flushes nothing —
    no duplicate, no off-grid event."""
    server = _server()
    server.add_session(0)
    server.push(0, np.zeros((150, 3), np.float32))  # events at 100, 150
    events = server.disconnect_session(0)
    assert [e.event.t_index for e in events] == [100, 150]


def test_disconnect_below_one_window_is_eventless():
    server = _server()
    server.add_session(0)
    server.push(0, np.zeros((60, 3), np.float32))  # < window: no flush
    assert server.disconnect_session(0) == []
    acct = server.stats.accounting()
    assert acct["balanced"] and acct["pending"] == 0


def test_disconnect_storm_under_load_conserves_every_window():
    """Regression for the disconnect storm: a trace that mass-evicts
    half the fleet mid-run (plus per-round churn) ends with every
    accepted window scored — the partial-window flush + settle path
    exercised dozens of times over, zero undeclared drops."""
    spec = TraceSpec(
        kind="storm", peak_sessions=24, swing=6.0, rounds=32, period=32,
        storms=((20, 0.5),), rate_mix=(1, 1, 2), seed=2,
    )
    server = _server()
    events, report = drive_trace(server, TrafficTrace(spec))
    assert report.storm_disconnects >= 5
    acct = server.stats.accounting()
    assert acct["balanced"] and acct["pending"] == 0
    assert server.stats.enqueued == server.stats.scored
    assert undeclared_drops(server.stats.snapshot()) == 0
    # off-grid flush events really happened (tails existed: sessions
    # deliver hop-sized chunks, so a mid-round eviction strands none,
    # but rate-2 sessions land 2×hop chunks whose windows settle here)
    assert len(events) == server.stats.scored


def test_disconnect_journal_order_acks_durable_before_remove(tmp_path):
    """Crash safety: the settle's acks reach the journal BEFORE the
    remove record, so a kill right after disconnect_session returns
    recovers with zero double-scored windows — re-polling the restored
    server re-emits nothing that was already delivered."""
    server = FleetServer(
        _StubModel(), window=100, hop=50, smoothing="ema",
        config=FleetConfig(
            max_sessions=16, target_batch=8, max_delay_ms=0.0,
        ),
        journal=FleetJournal(
            str(tmp_path / "j"), JournalConfig(flush_every=10_000)
        ),
    )
    for i in range(2):
        server.add_session(i)
        server.push(i, np.random.default_rng(i).normal(
            size=(120, 3)).astype(np.float32))
    delivered = server.disconnect_session(0)
    assert len(delivered) > 0
    server.journal.kill()  # SIGKILL: only flushed records survive

    restored = FleetServer.restore(str(tmp_path / "j"), _StubModel())
    # the disconnect's events were acked durably (poll flushes acks
    # before returning) — nothing re-emits, accounting stays whole
    seen = {(e.session_id, e.event.t_index) for e in delivered}
    post = restored.flush()
    assert all((e.session_id, e.event.t_index) not in seen for e in post)
    acct = restored.stats.accounting()
    assert acct["balanced"] and acct["pending"] == 0


def test_disc_replay_rebuilds_flush_bit_identically(tmp_path):
    """The ``disc`` journal record replays through the SAME
    _flush_partial code path: a server killed after the disconnect was
    journaled-but-unacked recovers the flush window bit-identically
    (re-derived from the recovered ring, then scored once)."""
    server = FleetServer(
        _StubModel(), window=100, hop=50, smoothing="ema",
        config=FleetConfig(
            max_sessions=16, target_batch=8, max_delay_ms=0.0,
        ),
        journal=FleetJournal(
            str(tmp_path / "j"), JournalConfig(flush_every=1)
        ),
    )
    server.add_session(0)
    rec = np.random.default_rng(4).normal(size=(120, 3)).astype(np.float32)
    server.push(0, rec)
    live = server.disconnect_session(0)
    live_d = _decisions(live)

    # uninterrupted reference on a fresh server
    ref_server = _server()
    ref_server.add_session(0)
    ref_server.push(0, rec)
    ref_d = _decisions(ref_server.disconnect_session(0))
    assert live_d == ref_d


# ---------------------------------------------- capacity controller


def test_controller_requires_exactly_one_target():
    server = _server()
    with pytest.raises(ValueError):
        CapacityController(server, cluster=object())
    with pytest.raises(ValueError):
        CapacityController()
    with pytest.raises(ValueError):
        CapacityController(
            server, config=AutoscaleConfig(mesh_ladder=(1, 8))
        )  # >1-device ladder without mesh_for
    with pytest.raises(ValueError):
        AutoscaleConfig(mesh_ladder=(8, 1))  # must ascend


def test_controller_hysteresis_needs_consecutive_evidence():
    """One bursty poll never resizes: up_after consecutive evidence
    steps are required, and any clean step resets the streak."""
    server = _server(target_batch=16)
    controller = CapacityController(
        server,
        config=AutoscaleConfig(
            min_target_batch=16, max_target_batch=64,
            up_after=3, down_after=3, cooldown_s=0.0,
        ),
        clock=lambda: 0.0,
    )
    server.stats.queue_depth = 10_000  # heavy backlog: up evidence
    assert controller.step() is None
    assert controller.step() is None
    server.stats.queue_depth = 0  # one clean poll resets the streak
    server.stats.utilization = 1.0
    assert controller.step() is None
    server.stats.queue_depth = 10_000
    assert controller.step() is None
    assert controller.step() is None
    action = controller.step()  # third consecutive: act
    assert action == {
        "action": "up", "knob": "target_batch", "to": 32,
        "signals": action["signals"],
    }
    assert server.config.target_batch == 32


def test_controller_cooldown_blocks_thrash():
    """A resize is a recompile ladder — actions must amortize.  The
    cooldown suppresses a second action until the clock passes."""
    t = {"now": 0.0}
    server = _server(target_batch=16)
    controller = CapacityController(
        server,
        config=AutoscaleConfig(
            min_target_batch=16, max_target_batch=256,
            up_after=1, down_after=1, cooldown_s=100.0,
        ),
        clock=lambda: t["now"],
    )
    server.stats.queue_depth = 10_000
    assert controller.step() is not None  # first action lands
    t["now"] = 50.0
    assert controller.step() is None  # inside the cooldown
    t["now"] = 150.0
    assert controller.step() is not None  # cooldown passed
    assert server.config.target_batch == 64


def test_controller_default_ladder_walks_depth_ring_to_3():
    """The depth-N ticket ring is on the default ladder:
    with no explicit config the controller walks target_batch to the
    cap, then pipeline depth 1→2→3 (the ring rung double-buffering
    never had), and retraces 3→2→1 on the way down."""
    server = _server(target_batch=256)
    controller = CapacityController(
        server,
        config=AutoscaleConfig(
            min_target_batch=256, max_target_batch=256,
            up_after=1, down_after=1, cooldown_s=0.0,
        ),
        clock=lambda: 0.0,
    )
    assert controller.config.max_depth == 3  # the new default rung
    server.stats.queue_depth = 10_000_000
    ups = [controller.step() for _ in range(3)]
    assert [(a or {}).get("knob") for a in ups] == [
        "pipeline_depth", "pipeline_depth", None,
    ]
    assert server.config.pipeline_depth == 3
    server.stats.queue_depth = 0
    server.stats.utilization = 0.05
    downs = [controller.step() for _ in range(3)]
    assert [(a or {}).get("knob") for a in downs] == [
        "pipeline_depth", "pipeline_depth", None,
    ]
    assert server.config.pipeline_depth == 1


def test_controller_ladder_up_then_down_retraces():
    """The capacity ladder: target_batch ×2 to the cap, then pipeline
    depth, then nothing (single-rung mesh ladder) — and scale-down
    walks the EXACT reverse path back to the floor."""
    server = _server(target_batch=16)
    controller = CapacityController(
        server,
        config=AutoscaleConfig(
            min_target_batch=16, max_target_batch=32,
            min_depth=1, max_depth=2,
            up_after=1, down_after=1, cooldown_s=0.0,
        ),
        clock=lambda: 0.0,
    )
    server.stats.queue_depth = 10_000
    ups = [controller.step() for _ in range(3)]
    assert [(a or {}).get("knob") for a in ups] == [
        "target_batch", "pipeline_depth", None,
    ]
    assert server.config.target_batch == 32
    assert server.config.pipeline_depth == 2
    assert server.stats.scale_ups == 2

    server.stats.queue_depth = 0
    server.stats.utilization = 0.05
    downs = [controller.step() for _ in range(3)]
    assert [(a or {}).get("knob") for a in downs] == [
        "pipeline_depth", "target_batch", None,
    ]
    assert server.config.target_batch == 16
    assert server.config.pipeline_depth == 1
    assert server.stats.scale_downs == 2
    assert server.stats.resizes == 4


def test_controller_shed_delta_is_up_evidence():
    """The SLO ladder paying (dropped_total rising between steps) is
    scale-up evidence even with an empty queue."""
    server = _server(target_batch=16)
    controller = CapacityController(
        server,
        config=AutoscaleConfig(
            min_target_batch=16, max_target_batch=64,
            up_after=1, down_after=10, cooldown_s=0.0,
        ),
        clock=lambda: 0.0,
    )
    controller.step()  # baseline dropped watermark
    server.stats.drop(5, "backpressure")
    action = controller.step()
    assert action is not None and action["knob"] == "target_batch"
    assert action["signals"]["shed_delta"] == 5


def test_controller_scales_cluster_workers(tmp_path):
    """Cluster mode: per-worker session pressure drives add_worker /
    retire_worker through the cluster's drain → hand-off machinery,
    with the drained events handed back (never swallowed) and global
    conservation intact."""
    from har_tpu_torch.serve.cluster import FleetCluster

    clock = FakeClock()
    cluster = FleetCluster(
        _StubModel(), str(tmp_path), workers=2, window=100, hop=50,
        smoothing="ema",
        fleet_config=FleetConfig(
            max_sessions=64, target_batch=8, max_delay_ms=0.0,
        ),
        clock=clock,
    )
    controller = CapacityController(
        cluster=cluster,
        config=AutoscaleConfig(
            sessions_per_worker_high=6, sessions_per_worker_low=2,
            min_workers=2, max_workers=3,
            up_after=1, down_after=1, cooldown_s=0.0,
        ),
        clock=clock,
    )
    for i in range(12):  # 6 per worker: at the high-water mark
        cluster.add_session(i)
        cluster.push(i, np.random.default_rng(i).normal(
            size=(100, 3)).astype(np.float32))
    cluster.poll(force=True)
    action = controller.step()
    assert action == {
        "action": "up", "knob": "workers",
        "added": action["added"], "signals": action["signals"],
    }
    assert len(cluster.workers) == 3
    assert controller.worker_adds == 1
    acct = cluster.accounting()
    assert acct["balanced"]

    # shrink the fleet below the low-water mark: the retire rung fires
    for i in range(10):
        cluster.disconnect_session(i)
    action = controller.step()
    assert action is not None and action["action"] == "down"
    assert action["knob"] == "workers"
    assert len(cluster.workers) == 2
    assert controller.worker_retires == 1
    acct = cluster.accounting()
    assert acct["balanced"] and acct["pending"] == 0
    # the pre-retire drain's events were kept for the drive loop
    assert isinstance(controller.take_events(), list)
    cluster.close()


def test_cluster_disconnect_session_routes_and_unplaces(tmp_path):
    from har_tpu_torch.serve.cluster import FleetCluster

    cluster = FleetCluster(
        _StubModel(), str(tmp_path), workers=2, window=100, hop=50,
        smoothing="ema",
        fleet_config=FleetConfig(
            max_sessions=64, target_batch=8, max_delay_ms=0.0,
        ),
        clock=FakeClock(),
    )
    cluster.add_session("s0")
    cluster.push("s0", np.random.default_rng(0).normal(
        size=(120, 3)).astype(np.float32))
    events = cluster.disconnect_session("s0")
    assert [e.event.t_index for e in events] == [100, 120]
    assert "s0" not in cluster.sessions
    acct = cluster.accounting()
    assert acct["balanced"] and acct["pending"] == 0
    cluster.close()


# ----------------------------------------- autoscaled elastic drives


def test_autoscaled_diurnal_drive_resizes_online_with_conservation():
    """The end-to-end engine story at test scale: a diurnal swing with
    a storm drives the controller up the ladder and back down, every
    resize landing at a dispatch boundary with the conservation law
    balanced in every per-round snapshot and zero undeclared drops."""
    spec = TraceSpec(
        kind="storm", peak_sessions=24, swing=8.0, rounds=40, period=40,
        storms=((26, 0.5),), slow_prob=0.1, slow_rounds=2,
        rate_mix=(1, 2), seed=11,
    )
    server = _server(target_batch=8, max_delay_ms=0.0)
    controller = CapacityController(
        server,
        config=AutoscaleConfig(
            min_target_batch=8, max_target_batch=32, max_depth=2,
            queue_high=1.0, util_low=0.3,
            up_after=1, down_after=2, cooldown_s=0.0,
        ),
        clock=lambda: 0.0,
    )
    balanced_every_round = {"ok": True}

    def on_round(target, r):
        out = controller.on_round(target, r)
        acct = target.stats.accounting()
        balanced_every_round["ok"] = (
            balanced_every_round["ok"] and acct["balanced"]
        )
        return out

    events, report = drive_trace(
        server, TrafficTrace(spec), on_round=on_round
    )
    assert server.stats.resizes >= 2
    assert server.stats.scale_ups >= 1
    assert server.stats.scale_downs >= 1
    assert balanced_every_round["ok"]
    acct = server.stats.accounting()
    assert acct["balanced"] and acct["pending"] == 0
    assert undeclared_drops(server.stats.snapshot()) == 0
    assert server.stats.enqueued == server.stats.scored
    assert len(events) == server.stats.scored


def test_declared_sheds_catalogue_matches_engine_reasons():
    """The smoke's shed whitelist stays anchored to real engine reason
    strings — a renamed shed reason must break this pin, not silently
    reclassify drops as 'declared'."""
    import inspect

    from har_tpu_torch.serve import engine as engine_mod

    src = inspect.getsource(engine_mod)
    for reason in DECLARED_SHEDS:
        assert f'"{reason}"' in src, reason
    snap = {"dropped_by_reason": {"slo_shed": 3, "dispatch_failed": 2}}
    assert undeclared_drops(snap) == 2


# ------------------------------------------------------------- CLI


def test_cli_serve_trace_autoscale_end_to_end(capsys):
    from har_tpu_torch.cli import main

    rc = main(
        [
            "serve", "--device", "cpu", "--sessions", "12",
            "--trace", "storm",
            "--trace-rounds", "16", "--autoscale",
        ]
    )
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["trace"] == "storm"
    assert out["balanced"] is True
    assert out["undeclared_drops"] == 0
    assert out["storm_disconnects"] > 0
    assert out["autoscale"]["mode"] == "engine"
    # the printed spec is the replayable artifact: it rebuilds a trace
    replay = TrafficTrace.from_spec(out["trace_spec"])
    assert replay.schedule[0]["connect"]  # trough cohort connects


def test_cli_serve_trace_rejects_incompatible_modes():
    """``--trace`` refuses the steady-load modes and a fleet cluster
    with the JAX package's SystemExit."""
    from har_tpu_torch.cli import main

    for flag in (["--adapt"], ["--monitor"], ["--inject-drift", "0.5"],
                 ["--workers", "2"]):
        with pytest.raises(SystemExit):
            main(["serve", "--device", "cpu", "--sessions", "8",
                  "--trace", "diurnal", *flag])


def test_elastic_smoke_verdict_green():
    """The elastic check, run in-process: 10x swing + storm + online
    resizes (a mesh rung on the CPU repeated twice) + cluster worker
    add/retire, zero windows lost, conservation balanced in every
    snapshot.  Its bench lane (item 16, ported) serves the same swing
    statically and autoscaled: the autoscaled run beats the best static
    one on p99 or shed rate, conservation balanced in every
    configuration."""
    from har_tpu_torch.serve.traffic.smoke import (
        elastic_smoke,
        elastic_traffic_benchmark,
    )

    out = elastic_smoke(device="cpu")
    assert out["ok"] is True
    assert out["windows_lost"] == 0
    assert out["resizes"] >= 2
    assert out["scale_ups"] >= 1 and out["scale_downs"] >= 1
    assert out["mesh_devices"] >= 2
    assert out["worker_adds"] >= 1 and out["worker_retires"] >= 1
    assert out["balanced_every_round"] is True
    bench = elastic_traffic_benchmark(smoke=True)
    assert set(bench) == {
        "trace", "swing", "dispatch_cost_model", "configs", "best_static_p99_ms",
        "best_static_shed_rate", "windows_per_sec_parity", "parity_floor",
        "parity_checked", "beats_static", "contract_ok"}
    assert set(bench["configs"]) == {"static_floor", "static_ceiling", "autoscaled"}
    assert bench["swing"] >= 8.0 and bench["parity_checked"] is False
    assert bench["beats_static"] is True and bench["contract_ok"] is True
    assert bench["configs"]["autoscaled"]["resizes"] >= 2
    assert all(c["contract_ok"] and c["windows_per_sec_median"] > 0
               for c in bench["configs"].values())


def test_controller_mesh_ladder_names_item_14():
    """The ladder's mesh rungs: past target_batch and pipeline depth, the
    controller resizes onto the rung's mesh (``mesh_for``, a serving mesh
    of 8 CPU entries here) and the server scores through the sharded
    scorer; scale-down walks back off the mesh first.  Without
    ``mesh_for`` the JAX package's ValueError stays."""
    from har_tpu_torch.parallel.mesh import create_serving_mesh
    from har_tpu_torch.serve import JitDemoModel

    server = FleetServer(
        JitDemoModel(window=100, device="cpu"), window=100, hop=50, smoothing="ema",
        config=FleetConfig(max_sessions=64, target_batch=16, max_delay_ms=0.0),
    )
    built = []

    def mesh_for(d):
        built.append(d)
        return create_serving_mesh(dp=d, tp=1, devices=["cpu"] * d)

    controller = CapacityController(
        server,
        config=AutoscaleConfig(
            min_target_batch=16, max_target_batch=32, min_depth=1, max_depth=2,
            mesh_ladder=(1, 8), up_after=1, down_after=1, cooldown_s=0.0,
        ),
        mesh_for=mesh_for, clock=lambda: 0.0,
    )
    server.stats.queue_depth = 10_000
    ups = [controller.step() for _ in range(4)]
    assert [(a or {}).get("knob") for a in ups] == [
        "target_batch", "pipeline_depth", "mesh", None,
    ]
    assert ups[2]["to"] == 8 and built == [8]
    for i in range(4):
        server.add_session(i)
        server.push(i, np.random.default_rng(i).normal(size=(100, 3)).astype(np.float32))
    assert len(server.flush()) == 4
    assert server.scorer.kind == "sharded" and server.scorer.devices == 8
    server.stats.queue_depth = 0
    server.stats.utilization = 0.05
    downs = [controller.step() for _ in range(4)]
    assert [(a or {}).get("knob") for a in downs] == [
        "mesh", "pipeline_depth", "target_batch", None,
    ]
    assert downs[0]["to"] == 1
    server.push(0, np.zeros((100, 3), np.float32))
    server.flush()
    assert server.scorer.kind == "device"
    assert server.stats.resizes == 6
    with pytest.raises(ValueError, match="mesh_for"):
        CapacityController(_server(), config=AutoscaleConfig(mesh_ladder=(1, 2)))


def test_disconnect_cohort_flush_respects_global_queue_bound():
    """A mass-cohort disconnect's partial-window flushes honor the same
    max_queue_windows backpressure bound push enforces: the overshoot
    sheds stalest fleet-wide as a DECLARED backpressure shed (the
    documented overload behavior) instead of ballooning the queue, and
    conservation stays balanced."""
    server = _server(
        max_sessions=64, target_batch=8, max_queue_windows=6,
    )
    rng = np.random.default_rng(3)
    for i in range(8):
        server.add_session(i)
        server.push(i, rng.normal(size=(120, 3)).astype(np.float32))
        server.poll(force=True)  # drain as we go: pushes never shed
    assert server.stats.dropped_total == 0
    events = server.disconnect_sessions(range(8))
    # 8 flushed partials against a bound of 6: exactly the overshoot
    # shed, the remainder scored at the settle
    assert server.stats.dropped.get("backpressure") == 2
    assert len(events) == 6
    acct = server.stats.accounting()
    assert acct["balanced"] and acct["pending"] == 0
    assert all(i not in server._sessions for i in range(8))


def test_disc_replay_rederives_cohort_overflow_shed(tmp_path):
    """The flush-time backpressure shed re-derives on replay exactly
    like push-time sheds do: a crash after a cohort disconnect's acks
    (remove records lost) recovers with the same declared sheds, the
    same scores, zero pending — never scoring a window the live run
    shed or dropping one it scored."""
    server = FleetServer(
        _StubModel(), window=100, hop=50, smoothing="ema",
        config=FleetConfig(
            max_sessions=64, target_batch=8, max_delay_ms=0.0,
            max_queue_windows=6,
        ),
        journal=FleetJournal(
            str(tmp_path / "j"), JournalConfig(flush_every=10_000)
        ),
    )
    rng = np.random.default_rng(5)
    for i in range(8):
        server.add_session(i)
        server.push(i, rng.normal(size=(120, 3)).astype(np.float32))
        server.poll(force=True)
    events = server.disconnect_sessions(range(8))
    assert server.stats.dropped.get("backpressure") == 2
    assert len(events) == 6
    # SIGKILL: disc records + acks are durable (the settle's poll
    # flushed them); the trailing remove records are the lost suffix
    server.journal.kill()

    restored = FleetServer.restore(str(tmp_path / "j"), _StubModel())
    acct = restored.stats.accounting()
    assert acct["balanced"] and acct["pending"] == 0
    assert restored.stats.dropped.get("backpressure") == 2
    assert restored.flush() == []  # nothing re-emits, nothing strands
    # the lost removes are the documented crash window: the sessions
    # survive with flushed assemblers, and a re-issued disconnect is a
    # clean no-op flush (idempotent) followed by the eviction
    assert restored.disconnect_sessions(range(8)) == []
    assert restored.stats.accounting()["balanced"]


def test_controller_scales_down_on_full_idle():
    """A load collapse (every session gone, nothing dispatching) is
    scale-down evidence even though the utilization gauge is frozen at
    the last batch's fill — idleness itself, measured as a zero scored
    delta, starts the down streak."""
    server = _server(target_batch=16)
    controller = CapacityController(
        server,
        config=AutoscaleConfig(
            min_target_batch=16, max_target_batch=32,
            up_after=1, down_after=2, cooldown_s=0.0,
        ),
        clock=lambda: 0.0,
    )
    server.add_session(0)
    server.push(0, np.zeros((100 * 16, 3), np.float32))
    server.poll(force=True)
    server.stats.queue_depth = 10_000
    assert controller.step() is not None  # scaled up to 32
    server.stats.queue_depth = 0
    # the fleet goes silent: the gauge stays at the last batch's fill
    # (well above util_low), but nothing scores between steps — down
    # evidence anyway
    assert server.stats.utilization > 0.5
    assert controller.step() is None  # streak 1 of 2
    action = controller.step()
    assert action is not None and action["action"] == "down"
    assert action["signals"]["idle"] is True
    assert server.config.target_batch == 16
