"""Pipelined fleet dispatch (har_tpu_torch.serve.dispatch).

The JAX package's dispatch pins (tests/test_dispatch.py) on the port, with
``JitDemoModel`` on the CPU; the mesh-sharded cases run on a serving mesh
that repeats the CPU 8 times (``parallel.mesh.create_serving_mesh``), as
the JAX tests run on the 8-device dry-run mesh, and the sharded run is
also held to ``har_tpu``'s on that mesh.

Pins the contracts the dispatch-plane overhaul ships on:

  1. bit-identity — a pipelined (depth 2) fleet emits the EXACT event
     stream a synchronous (depth 1) fleet emits at N=64 under the
     FakeClock + DispatchFaults harness: same decisions, same
     probabilities, same per-session order (strict FIFO retire);
  2. sharded scoring — a >1-device mesh scores the same decisions as a
     single device (labels/raw labels/drift bit-equal; probabilities to
     1e-6 — a shard's GEMM runs over fewer rows, the same reduction-order
     drift the tp-vs-single training pin documents), under the devices × pow2
     pad policy with the log2-bounded compiled-program budget;
  3. the staging arena — windows staged once at enqueue, batch assembly
     by gather, slots recycled, snapshot format unchanged;
  4. vectorized host data plane — single-pass ingest guard equivalent
     to the two-pass reference on poisoned streams, batched smoother
     equivalent to step-by-step;
  5. sharding-honest device calibration — calibrate_device measures the
     padded shapes the sharded path actually emits.
"""

import numpy as np
import pytest
import torch

from har_tpu_torch.serve import (
    DispatchFaults,
    FakeClock,
    FleetConfig,
    FleetServer,
    JitDemoModel,
    StagingArena,
    drive_fleet,
    make_scorer,
    synthetic_sessions,
)
from har_tpu_torch.parallel.mesh import create_serving_mesh
from har_tpu_torch.serve.dispatch import (
    DeviceScorer,
    HostScorer,
    ModelParallelScorer,
    ShardedScorer,
)
from har_tpu_torch.serving import _Smoother, finite_rows, pad_pow2, pad_shard

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


def _recordings(n, n_samples=450, seed=0):
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=(n_samples, 3)).astype(np.float32)
        for _ in range(n)
    ]


def _mesh(dp=8, tp=1):
    """A dp × tp serving mesh over the CPU repeated."""
    return create_serving_mesh(dp=dp, tp=tp, devices=["cpu"] * (dp * tp))


def _assert_label_equal_probs_close(d1, d2, atol=1e-6):
    assert d1.keys() == d2.keys()
    for sid in d1:
        a, b = d1[sid], d2[sid]
        assert [x[:4] for x in a] == [y[:4] for y in b]  # labels/drift
        for x, y in zip(a, b):
            np.testing.assert_allclose(
                np.frombuffer(x[4]), np.frombuffer(y[4]), atol=atol
            )


def _decisions(events):
    """Per-session decision-field sequences (latency excluded)."""
    out = {}
    for fe in events:
        ev = fe.event
        out.setdefault(fe.session_id, []).append(
            (ev.t_index, ev.label, ev.raw_label, ev.drift,
             ev.probability.tobytes())
        )
    return out


# ------------------------------------------------------- bit-identity


@pytest.mark.parametrize("smoothing", ["ema", "vote"])
def test_pipelined_bit_identical_to_synchronous_n64(smoothing):
    """THE pipelining pin: depth 2 vs depth 1 at N=64 under FakeClock +
    DispatchFaults (stalls on the fake clock + transient failures
    absorbed by the retry path) — event streams identical per session,
    bitwise, because retire order is strictly FIFO."""
    n = 64
    recs = _recordings(n, n_samples=600, seed=11)

    def run(depth):
        clock = FakeClock()
        server = FleetServer(
            _StubModel(), window=100, hop=50, smoothing=smoothing,
            config=FleetConfig(
                max_sessions=n, target_batch=32, max_delay_ms=0.0,
                retries=1, pipeline_depth=depth,
            ),
            fault_hook=DispatchFaults(
                stall_every=3, stall_ms=1.0, fail_every=5,
                fake_clock=clock,
            ),
            clock=clock,
        )
        for i in range(n):
            server.add_session(i)
        events = []
        cursors = [0] * n
        rng = np.random.default_rng(7)
        while any(c < len(recs[i]) for i, c in enumerate(cursors)):
            for i in range(n):
                if cursors[i] >= len(recs[i]):
                    continue
                step = int(rng.integers(20, 120))
                server.push(i, recs[i][cursors[i]: cursors[i] + step])
                cursors[i] += step
            events.extend(server.poll(force=True))
            clock.advance(0.01)
        events.extend(server.flush())
        return server, events

    s1, ev1 = run(1)
    s2, ev2 = run(2)
    d1, d2 = _decisions(ev1), _decisions(ev2)
    assert d1.keys() == d2.keys()
    for sid in d1:
        assert d1[sid] == d2[sid]
    # same totals, same accounting, both balanced
    for s in (s1, s2):
        acct = s.stats.accounting()
        assert acct["balanced"] and acct["pending"] == 0
    assert s1.stats.scored == s2.stats.scored
    # the depth-2 run genuinely pipelined (tickets stacked ≥2 deep)
    assert max(s2.stats.inflight_depth) >= 2
    assert max(s1.stats.inflight_depth) == 1


def test_carried_ticket_retires_on_next_poll():
    """With pipeline_depth 2, an unforced poll leaves the last launched
    ticket in flight (the device crunches through the next delivery
    round); its events arrive with the next poll, FIFO-intact, and
    flush() always drains."""
    clock = FakeClock()
    server = FleetServer(
        _StubModel(), window=10, hop=10, smoothing="none",
        config=FleetConfig(
            target_batch=4, max_delay_ms=0.0, pipeline_depth=2,
        ),
        clock=clock,
    )
    server.add_session(0)
    server.push(0, np.zeros((10 * 8, 3), np.float32))  # 8 windows due
    ev1 = server.poll()
    # two batches of 4: the first retires in-poll, the second carries
    assert len(ev1) == 4
    acct = server.stats.accounting()
    assert acct["pending"] == 4  # carried ticket windows: un-acked
    ev2 = server.poll()  # nothing new due — retires the carried ticket
    assert len(ev2) == 4
    assert [e.event.t_index for e in ev1 + ev2] == [
        10 * (i + 1) for i in range(8)
    ]
    acct = server.stats.accounting()
    assert acct["balanced"] and acct["pending"] == 0
    assert server.flush() == []


# ---------------------------------------------------- sharded scoring


def test_pad_shard_policy():
    for k, shards, want in (
        (5, 8, 8), (8, 8, 8), (9, 8, 16), (17, 8, 32), (100, 8, 128),
        (5, 1, 8), (6, 2, 8),
    ):
        got = pad_shard(np.zeros((k, 2), np.float32), shards)
        assert len(got) == want, (k, shards)
        assert len(got) % shards == 0
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    np.testing.assert_array_equal(pad_shard(x, 1), pad_pow2(x))
    # padding repeats the last row
    np.testing.assert_array_equal(pad_shard(x, 8)[5:], np.tile(x[-1:], (3, 1)))


def test_sharded_scoring_matches_single_device_and_program_budget():
    """Mesh-sharded dispatch: decisions equal the single-device run's
    (probs to 1e-6), batches pad to devices × pow2, and the program
    count stays log2-bounded."""
    mesh = _mesh(8)
    n = 48
    model = JitDemoModel(device="cpu")
    recordings, _ = synthetic_sessions(n, windows_per_session=2, seed=5)

    def run(m):
        server = FleetServer(
            model, window=200, hop=200, smoothing="ema",
            config=FleetConfig(max_sessions=n, target_batch=64),
            mesh=m,
        )
        for i in range(n):
            server.add_session(i)
        events, _ = drive_fleet(server, recordings, seed=5)
        return server, events

    s1, ev1 = run(None)
    s8, ev8 = run(mesh)
    assert isinstance(s8.scorer, ShardedScorer)
    assert s8.scorer.devices == 8
    _assert_label_equal_probs_close(_decisions(ev1), _decisions(ev8))
    target = 64
    budget = int(np.log2(target)) + 1
    for shape in s8.scorer.compiled_shapes:
        assert shape % 8 == 0
    assert len(s8.scorer.compiled_shapes) <= budget
    assert s8.scorer.program_count() <= budget + len(s1.scorer.compiled_shapes)
    # every device saw the same window share, stamped in the stats
    dw = s8.stats.device_windows
    assert len(dw) == 8 and len(set(dw.values())) == 1


def test_sharded_fleet_matches_jax_sharded_fleet():
    """The same sharded fleet in both packages, on 8 devices under a
    FakeClock: equal decisions (probabilities within 1e-6), equal
    batches and equal per-device window shares."""
    import jax

    import har_tpu.serve as jax_serve
    from har_tpu.parallel.mesh import create_mesh

    n = 24
    runs = {}
    for pkg, serve, model, mesh in (
        ("port", __import__("har_tpu_torch.serve", fromlist=["x"]),
         JitDemoModel(device="cpu"), _mesh(8)),
        ("jax", jax_serve, jax_serve.JitDemoModel(),
         create_mesh(dp=8, tp=1, devices=jax.devices()[:8])),
    ):
        clock = serve.FakeClock()
        server = serve.FleetServer(
            model, window=200, hop=200, smoothing="ema", clock=clock,
            config=serve.FleetConfig(max_sessions=n, target_batch=16,
                                     max_delay_ms=0.0),
            mesh=mesh,
        )
        for i in range(n):
            server.add_session(i)
        recordings, _ = serve.synthetic_sessions(n, windows_per_session=2, seed=3)
        events, _ = serve.drive_fleet(server, recordings, seed=3)
        runs[pkg] = (server, _decisions(events))
    _assert_label_equal_probs_close(runs["port"][1], runs["jax"][1])
    port, jx = runs["port"][0], runs["jax"][0]
    assert port.stats.batch_sizes == jx.stats.batch_sizes
    assert port.stats.device_windows == jx.stats.device_windows
    assert port.stats_snapshot()["devices"] == jx.stats_snapshot()["devices"] == 8


def test_scorer_selection_policy():
    """make_scorer routing: a host model gets HostScorer with or without
    a mesh (host models cannot shard — fall back, never crash), a device
    model the async DeviceScorer on one device and ShardedScorer on an
    8-device mesh."""
    mesh = _mesh(8)
    assert isinstance(make_scorer(_StubModel(), None), HostScorer)
    assert isinstance(make_scorer(_StubModel(), mesh), HostScorer)
    jit_model = JitDemoModel(device="cpu")
    assert isinstance(make_scorer(jit_model, None), DeviceScorer)
    sharded = make_scorer(jit_model, mesh)
    assert isinstance(sharded, ShardedScorer)
    assert not isinstance(sharded, ModelParallelScorer)
    assert sharded.kind == "sharded" and sharded.model_axis_shards == 1


def test_async_device_scorer_matches_transform():
    """DeviceScorer launch+fetch == model.transform bitwise (same ops,
    same order) — what makes pipelined serving of a jitted model
    bit-identical to the synchronous engine."""
    model = JitDemoModel(device="cpu")
    scorer = make_scorer(model, None)
    x = np.random.default_rng(3).normal(
        size=(16, 200, 3)
    ).astype(np.float32)
    got = scorer.fetch(scorer.launch(x), 16)
    want = np.asarray(model.transform(x).probability[:16], np.float64)
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------- staging arena


def test_arena_stage_gather_recycle_grow():
    arena = StagingArena(4, 2, capacity=8)
    rng = np.random.default_rng(0)
    wins = rng.normal(size=(30, 4, 2)).astype(np.float32)
    slots = [arena.put(w) for w in wins[:8]]
    assert arena.in_use == 8
    np.testing.assert_array_equal(arena.gather(slots), wins[:8])
    # grow on demand, previous contents intact
    more = arena.put_block(wins[8:20])
    assert arena.grows >= 1
    np.testing.assert_array_equal(arena.gather(slots), wins[:8])
    np.testing.assert_array_equal(arena.gather(more), wins[8:20])
    # recycle: freed slots are reused, not leaked
    for s in slots:
        arena.free(s)
    cap_before = arena.capacity
    reused = [arena.put(w) for w in wins[20:28]]
    assert arena.capacity == cap_before
    np.testing.assert_array_equal(arena.gather(reused), wins[20:28])
    st = arena.state()
    assert st["capacity"] == arena.capacity and st["in_use"] == arena.in_use


def test_fleet_snapshot_format_unchanged_by_arena(tmp_path):
    """The arena is process-local staging: snapshots still carry the
    stacked ``pending`` array (gathered at snapshot time), so the
    on-disk format is the pre-arena one."""
    from har_tpu_torch.serve.journal import load_journal

    server = FleetServer(
        _StubModel(), window=10, hop=10, smoothing="none",
        config=FleetConfig(target_batch=64, max_delay_ms=1e9),
        journal=str(tmp_path / "j"),
    )
    server.add_session("a")
    server.push("a", np.ones((10 * 3, 3), np.float32))  # 3 pending
    server.write_snapshot()
    state, arrays, _records = load_journal(str(tmp_path / "j"))
    assert arrays["pending"].shape == (3, 10, 3)
    np.testing.assert_array_equal(
        arrays["pending"], np.ones((3, 10, 3), np.float32)
    )
    assert [m[1] for m in state["pending"]] == [10, 20, 30]
    # arena sizing rides the provider hook (observability only)
    assert "staging_arena" in state["extra"]


# ------------------------------------------- vectorized host data plane


def test_finite_rows_single_pass_equivalent_on_poisoned_streams():
    """The one-reduction guard classifies NaN / ±Inf / out-of-range rows
    exactly like the two-pass reference, for every max_abs mode."""
    rng = np.random.default_rng(42)
    for _ in range(30):
        x = rng.normal(size=(50, 3)).astype(np.float32) * 10
        for _ in range(8):
            r, c = rng.integers(0, 50), rng.integers(0, 3)
            x[r, c] = rng.choice(
                np.asarray([np.nan, np.inf, -np.inf, 5e6, -7e6, 0.5],
                           np.float32)
            )
        for max_abs in (1e6, 100.0, None):
            bad = ~np.isfinite(x).all(axis=-1)
            if max_abs is not None:
                with np.errstate(invalid="ignore"):
                    bad |= (np.abs(x) > max_abs).any(axis=-1)
            got, n_bad = finite_rows(x, max_abs)
            assert n_bad == int(bad.sum())
            np.testing.assert_array_equal(got, x[~bad])


@pytest.mark.parametrize("mode", ["ema", "vote", "none"])
def test_smoother_update_many_equals_step(mode):
    rng = np.random.default_rng(9)
    probs = rng.random(size=(40, 5))
    probs /= probs.sum(axis=1, keepdims=True)
    a = _Smoother(mode, 0.4, 5)
    b = _Smoother(mode, 0.4, 5)
    many = a.update_many(probs)
    one = [b.step(p) for p in probs]
    for (l1, r1, d1), (l2, r2, d2) in zip(many, one):
        assert l1 == l2 and r1 == r2
        np.testing.assert_array_equal(d1, d2)


def test_assembler_vectorized_burst_equals_sequential_chunks():
    """One whole-recording push (vectorized strided path) produces the
    same windows, ring state and t_indices as sample-dribble pushes."""
    from har_tpu_torch.serving import _WindowAssembler

    rng = np.random.default_rng(4)
    stream = rng.normal(size=(977, 3)).astype(np.float32)
    for window, hop in ((100, 40), (64, 64), (50, 7)):
        burst = _WindowAssembler(window, hop, 3)
        drip = _WindowAssembler(window, hop, 3)
        got = burst.consume(stream)
        want = []
        for s in range(0, len(stream), 13):
            want.extend(drip.consume(stream[s: s + 13]))
        assert [t for t, _, _ in got] == [t for t, _, _ in want]
        for (_, wa, da), (_, wb, db) in zip(got, want):
            assert da == db
            np.testing.assert_array_equal(wa, wb)
        np.testing.assert_array_equal(burst._ring, drip._ring)


# -------------------------------------- sharding-honest calibration


def test_calibrate_device_measures_sharded_emitted_shapes():
    """Under a mesh, calibrate_device rounds every size through the
    devices × pow2 policy and measures the SHARDED program, so events'
    device_ms keys match the dispatched padded shapes."""
    mesh = _mesh(8)
    n = 20
    model = JitDemoModel(device="cpu")
    server = FleetServer(
        model, window=200, hop=200, smoothing="none",
        config=FleetConfig(max_sessions=n, target_batch=64),
        mesh=mesh,
    )
    recordings, _ = synthetic_sessions(n, windows_per_session=1, seed=1)
    for i in range(n):
        server.add_session(i)
    drive_fleet(server, recordings, seed=1)
    # devices x pow2 → 8 * pow2(ceil(20/8)=3→4) = 32
    assert set(server.stats.batch_sizes) == {32}
    cal = server.calibrate_device(iters=2)
    assert 32 in cal and 8 in cal
    assert all(b % 8 == 0 for b in cal)
    for i in range(n):
        server.push(i, recordings[i])
    events = server.flush()
    assert events and all(e.event.device_ms is not None for e in events)
    assert events[0].event.device_ms == round(cal[32]["p50_ms"] / 20, 4)


def test_calibrate_device_host_stub_still_raises():
    server = FleetServer(_StubModel(), window=10, hop=10)
    with pytest.raises(ValueError):
        server.calibrate_device()


# ------------------------------------------------- config validation


def test_pipeline_depth_validated():
    with pytest.raises(ValueError, match="pipeline_depth"):
        FleetConfig(pipeline_depth=0)
    assert FleetConfig(pipeline_depth=2).pipeline_depth == 2


# ------------------------------------------------- elastic resize


@pytest.mark.parametrize("depth", [1, 2])
def test_resize_during_flight_bit_identical_and_balanced(depth):
    """THE elastic pin (har_tpu_torch.serve.traffic): a run that resizes
    target_batch mid-stream — at depth 2 the resize lands while a
    carried ticket is still in flight — emits the EXACT event stream of
    a no-resize run (row-independent scores + strict FIFO retire make
    batch geometry invisible), with zero drops and the conservation law
    balanced in every per-round snapshot."""
    n = 16
    recs = _recordings(n, n_samples=800, seed=21)

    def run(resize_at):
        clock = FakeClock()
        server = FleetServer(
            _StubModel(), window=100, hop=50, smoothing="ema",
            config=FleetConfig(
                max_sessions=n, target_batch=8, max_delay_ms=0.0,
                pipeline_depth=depth,
            ),
            clock=clock,
        )
        for i in range(n):
            server.add_session(i)
        events, snaps = [], []
        cursors = [0] * n
        rng = np.random.default_rng(3)
        rnd = 0
        while any(c < len(recs[i]) for i, c in enumerate(cursors)):
            for i in range(n):
                if cursors[i] >= len(recs[i]):
                    continue
                step = int(rng.integers(30, 90))
                server.push(i, recs[i][cursors[i]: cursors[i] + step])
                cursors[i] += step
            if resize_at is not None and rnd == resize_at:
                # between polls at depth 2 a carried ticket is STILL IN
                # FLIGHT: the resize applies now (engine idle), the
                # flying ticket retires on its old batch geometry
                server.resize(target_batch=32)
            # unforced: depth 2 carries up to depth-1 tickets across
            events.extend(server.poll())
            snaps.append(server.stats.accounting())
            clock.advance(0.01)
            rnd += 1
        events.extend(server.flush())
        snaps.append(server.stats.accounting())
        return server, events, snaps

    sA, evA, snapsA = run(resize_at=4)
    sB, evB, snapsB = run(resize_at=None)
    assert all(s["balanced"] for s in snapsA + snapsB)
    assert sA.stats.dropped_total == sB.stats.dropped_total == 0
    dA, dB = _decisions(evA), _decisions(evB)
    assert dA.keys() == dB.keys()
    for sid in dA:
        assert dA[sid] == dB[sid]
    assert sA.stats.resizes == 1 and sA.stats.scale_ups == 1
    assert sA.config.target_batch == 32
    assert sB.stats.resizes == 0
    final = sA.stats.accounting()
    assert final["balanced"] and final["pending"] == 0


def test_resize_mesh_mid_run_matches_single_device_run():
    """An online mesh re-shard (1 device → 8-device mesh) at a dispatch
    boundary: decisions stay label-equal to the never-resized
    single-device run (probs to 1e-6), zero drops, and the post-resize
    scorer really is sharded over the new placement."""
    mesh = _mesh(8)
    n = 24
    model = JitDemoModel(device="cpu")
    recordings, _ = synthetic_sessions(n, windows_per_session=4, seed=9)
    halves = [(r[: len(r) // 2], r[len(r) // 2:]) for r in recordings]

    def run(resize_mesh):
        server = FleetServer(
            model, window=200, hop=200, smoothing="ema",
            config=FleetConfig(max_sessions=n, target_batch=32),
        )
        for i in range(n):
            server.add_session(i)
        ev1, _ = drive_fleet(server, [h[0] for h in halves], seed=9)
        if resize_mesh is not None:
            server.resize(mesh=resize_mesh)
        ev2, _ = drive_fleet(server, [h[1] for h in halves], seed=10)
        return server, ev1 + ev2

    s1, ev_flat = run(None)
    s8, ev_resized = run(mesh)
    assert isinstance(s8.scorer, ShardedScorer)
    assert s8.scorer.devices == 8
    assert s8.stats.resizes == 1
    assert s1.stats.dropped_total == s8.stats.dropped_total == 0
    _assert_label_equal_probs_close(_decisions(ev_flat), _decisions(ev_resized))
    for s in (s1, s8):
        acct = s.stats.accounting()
        assert acct["balanced"] and acct["pending"] == 0


def test_resize_from_dispatch_tap_defers_to_boundary():
    """A resize issued from inside a dispatch tap (i.e. mid-dispatch)
    must NOT mutate capacity under the batch being finalized: it stages,
    and applies at that dispatch's end — the same boundary discipline
    as swap_model."""
    server = FleetServer(
        _StubModel(), window=10, hop=10, smoothing="none",
        config=FleetConfig(target_batch=4, max_delay_ms=0.0),
    )
    server.add_session(0)
    seen = []

    def tap(sids, windows, probs):
        if not seen:
            server.resize(target_batch=16)
            # deferred: the config is untouched inside the dispatch
            seen.append(server.config.target_batch)
        return 0

    server.set_dispatch_tap(tap)
    server.push(0, np.zeros((10 * 4, 3), np.float32))
    server.poll(force=True)
    assert seen == [4]
    assert server.config.target_batch == 16
    assert server.stats.resizes == 1
    acct = server.stats.accounting()
    assert acct["balanced"] and acct["pending"] == 0


def test_resize_validates_and_counts_directions():
    server = FleetServer(
        _StubModel(), window=10, hop=10, smoothing="none",
        config=FleetConfig(target_batch=8, max_delay_ms=0.0),
    )
    with pytest.raises(ValueError):
        server.resize(target_batch=0)
    with pytest.raises(ValueError):
        server.resize(pipeline_depth=0)
    up = server.resize(target_batch=16)
    assert up["dir"] == 1
    down = server.resize(target_batch=8)
    assert down["dir"] == -1
    flat = server.resize(target_batch=8)  # no capacity change
    assert flat["dir"] == 0
    assert server.stats.resizes == 3
    assert server.stats.scale_ups == 1
    assert server.stats.scale_downs == 1


def test_dispatch_fill_utilization_gauge_tracks_last_batch():
    """stats.utilization is the live fill fraction of the most recent
    dispatch (k / target_batch) — the controller's scale-down signal."""
    server = FleetServer(
        _StubModel(), window=10, hop=10, smoothing="none",
        config=FleetConfig(target_batch=8, max_delay_ms=0.0),
    )
    server.add_session(0)
    server.push(0, np.zeros((10 * 2, 3), np.float32))  # 2 of 8 slots
    server.poll(force=True)
    assert server.stats.utilization == pytest.approx(2 / 8)
    server.push(0, np.zeros((10 * 8, 3), np.float32))  # a full batch
    server.poll(force=True)
    assert server.stats.utilization == pytest.approx(1.0)


def test_staged_resizes_compose_at_one_boundary():
    """Two resize() calls staged inside the same dispatch compose —
    the second reads its unspecified knobs from the staged request, so
    a tap issuing target_batch then pipeline_depth lands ONE combined
    resize instead of silently reverting the first."""
    server = FleetServer(
        _StubModel(), window=10, hop=10, smoothing="none",
        config=FleetConfig(target_batch=4, max_delay_ms=0.0),
    )
    server.add_session(0)
    staged = []

    def tap(sids, windows, probs):
        if not staged:
            server.resize(target_batch=32)
            second = server.resize(pipeline_depth=2)
            staged.append(second)
        return 0

    server.set_dispatch_tap(tap)
    server.push(0, np.zeros((10 * 4, 3), np.float32))
    server.poll(force=True)
    # the second call's normalized request carried the first's knob
    assert staged[0]["target_batch"] == 32
    assert server.config.target_batch == 32
    assert server.config.pipeline_depth == 2
    assert server.stats.resizes == 1  # one composed boundary resize
    assert server.stats.scale_ups == 1


# ------------------------------------------------------ fused hot loop


def _labels(events):
    out = {}
    for fe in events:
        ev = fe.event
        out.setdefault(fe.session_id, []).append(
            (ev.t_index, ev.label, ev.raw_label, ev.drift,
             round(float(ev.probability[ev.label]), 12))
        )
    return out


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_fused_label_equal_to_unfused_n64(depth):
    """THE fused acceptance pin: the fused + depth-N path emits the
    same (t_index, label, raw_label, drift) stream — and the same
    decision confidence — as the unfused synchronous path at N=64
    under FakeClock + DispatchFaults, at every ring depth 1-4.  Event
    probabilities off the decision label are the compact surrogate by
    design (dispatch.compact_probs), so the pin is label equality, not
    probability bit-identity."""
    from har_tpu_torch.serve import FakeClock

    n = 64
    recs = _recordings(n, n_samples=450, seed=31)
    model = JitDemoModel(device="cpu", window=100)

    def run(fused, d):
        clock = FakeClock()
        server = FleetServer(
            model, window=100, hop=50, smoothing="vote",
            config=FleetConfig(
                max_sessions=n, target_batch=32, max_delay_ms=0.0,
                retries=1, pipeline_depth=d, fused=fused,
            ),
            fault_hook=DispatchFaults(
                stall_every=3, stall_ms=1.0, fail_every=5,
                fake_clock=clock,
            ),
            clock=clock,
        )
        for i in range(n):
            server.add_session(i)
        events = []
        cursors = [0] * n
        rng = np.random.default_rng(7)
        while any(c < len(recs[i]) for i, c in enumerate(cursors)):
            for i in range(n):
                if cursors[i] >= len(recs[i]):
                    continue
                step = int(rng.integers(20, 120))
                server.push(i, recs[i][cursors[i]: cursors[i] + step])
                cursors[i] += step
            events.extend(server.poll(force=True))
            clock.advance(0.01)
        events.extend(server.flush())
        return server, events

    s0, ev0 = run(False, 1)
    s1, ev1 = run(True, depth)
    l0, l1 = _labels(ev0), _labels(ev1)
    assert l0.keys() == l1.keys()
    for sid in l0:
        assert l0[sid] == l1[sid]
    # the fused run really ran fused, and really fetched less
    assert s1.stats.fused_dispatches == s1.stats.dispatches > 0
    assert s1.stats.fetch_bytes_saved > 0
    assert s1.stats.fetch_bytes < s0.stats.fetch_bytes
    assert s0.stats.fused_dispatches == 0
    for s in (s0, s1):
        acct = s.stats.accounting()
        assert acct["balanced"] and acct["pending"] == 0
    if depth >= 2:
        assert max(s1.stats.inflight_depth) >= 2


def test_fused_requires_eligible_smoothing_and_device_scorer():
    """fused=True is a REQUEST: EMA smoothing (needs the full
    probability vector) and host-only models serve unfused, silently
    and correctly — the knob never changes what EMA events contain."""
    model = JitDemoModel(device="cpu", window=20)
    server = FleetServer(
        model, window=20, hop=20, smoothing="ema",
        config=FleetConfig(target_batch=4, max_delay_ms=0.0, fused=True),
    )
    server.add_session(0)
    server.push(0, np.zeros((20 * 4, 3), np.float32))
    server.poll(force=True)
    assert server.stats.fused_dispatches == 0
    assert server.stats.dispatches == 1
    # host stub: fused ineligible regardless of smoothing
    host = FleetServer(
        _StubModel(), window=20, hop=20, smoothing="none",
        config=FleetConfig(target_batch=4, max_delay_ms=0.0, fused=True),
    )
    host.add_session(0)
    host.push(0, np.zeros((20 * 4, 3), np.float32))
    host.poll(force=True)
    assert host.stats.fused_dispatches == 0
    assert host.stats.dispatches == 1


def test_compact_probs_contract():
    """argmax(out[i]) is STRICTLY the device label (even on the exact
    top == 1/C tie), the decision confidence is exactly the device's
    top probability, and rows sum to 1 up to fp rounding."""
    from har_tpu_torch.serve.dispatch import compact_probs

    labels = np.asarray([2, 0, 5, 3])
    top = np.asarray([0.9, 1.0 / 6.0, 0.400001, 1.0])
    out = compact_probs(labels, top, 6)
    assert out.shape == (4, 6)
    np.testing.assert_array_equal(out.argmax(axis=1), labels)
    np.testing.assert_allclose(out.sum(axis=1), 1.0, atol=1e-9)
    np.testing.assert_array_equal(out[np.arange(4), labels], top)
    # single-class degenerate
    one = compact_probs(np.zeros(3, np.intp), np.ones(3), 1)
    np.testing.assert_array_equal(one, np.ones((3, 1)))


def test_arena_gather_into_exact_fit_and_padding():
    """gather_into writes straight into the preallocated slab: tail
    rows repeat the last gathered row (pad_pow2 semantics), and the
    exact-fit case touches only the gathered rows."""
    arena = StagingArena(4, 2, capacity=8)
    rng = np.random.default_rng(1)
    wins = rng.normal(size=(6, 4, 2)).astype(np.float32)
    slots = [arena.put(w) for w in wins]
    slab = np.empty((8, 4, 2), np.float32)
    out = arena.gather_into(slots, slab)
    assert out is slab
    np.testing.assert_array_equal(slab[:6], wins)
    np.testing.assert_array_equal(slab[6], wins[-1])
    np.testing.assert_array_equal(slab[7], wins[-1])
    # exact fit: the tail fill is skipped entirely
    exact = np.full((6, 4, 2), np.nan, np.float32)
    arena.gather_into(slots, exact)
    np.testing.assert_array_equal(exact, wins)


def test_pad_exact_fit_skips_the_copy_and_compile_count_unchanged():
    """Satellite pin: both pad policies return the input UNCHANGED
    (same object — no copy) when the batch already sits on the padded
    ladder, and a fleet emitting only exact-fit batches compiles the
    same single program either way."""
    x = np.zeros((32, 2), np.float32)
    assert pad_pow2(x) is x
    assert pad_shard(x, 8) is x
    assert pad_shard(x, 1) is x
    model = JitDemoModel(device="cpu", window=10)
    server = FleetServer(
        model, window=10, hop=10, smoothing="none",
        config=FleetConfig(target_batch=8, max_delay_ms=0.0),
    )
    server.add_session(0)
    for _ in range(3):  # three exact 8-window batches
        server.push(0, np.zeros((10 * 8, 3), np.float32))
        server.poll(force=True)
    assert set(server.stats.batch_sizes) == {8}
    assert server.scorer.compiled_shapes == {8}


def test_fused_slab_pool_bounded_and_recycled():
    """Fused staging, both halves of the contract: exact-fit
    FIFO-contiguous batches ride the ZERO-COPY fast path (the device
    gets the staging slice itself — no slab is ever acquired), while
    padded batches fall back to the per-shape slab pool, bounded at
    pipeline_depth slabs and recycled at retire — either way,
    steady-state fused serving allocates nothing per dispatch."""
    model = JitDemoModel(device="cpu", window=10)
    server = FleetServer(
        model, window=10, hop=10, smoothing="none",
        config=FleetConfig(
            target_batch=4, max_delay_ms=0.0, pipeline_depth=3,
            fused=True,
        ),
    )
    server.add_session(0)
    for _ in range(6):
        server.push(0, np.zeros((10 * 8, 3), np.float32))
        server.poll(force=True)
    server.flush()
    assert server.stats.fused_dispatches == server.stats.dispatches >= 12
    # exact-fit in-order rounds: zero-copy, so NO slab was ever needed
    assert server._slab_pool == {}
    # a partial batch (3 windows -> pad 4) cannot ride the view: it
    # takes the pooled-slab path, bounded per shape
    for _ in range(4):
        server.push(0, np.zeros((10 * 3, 3), np.float32))
        server.poll(force=True)
    server.flush()
    pool = server._slab_pool
    assert set(pool) == {4}
    assert 1 <= len(pool[4]) <= 3
    acct = server.stats.accounting()
    assert acct["balanced"] and acct["pending"] == 0


def test_fused_survives_dispatch_faults_and_session_removal():
    """Fused retry path: transient launch failures re-dispatch the
    SAME slab; a session removed while its fused ticket flies drops
    cleanly (no event, no double free, slab recycled)."""
    from har_tpu_torch.serve import FakeClock

    model = JitDemoModel(device="cpu", window=10)
    clock = FakeClock()
    server = FleetServer(
        model, window=10, hop=10, smoothing="none",
        config=FleetConfig(
            target_batch=4, max_delay_ms=0.0, pipeline_depth=2,
            retries=1, fused=True,
        ),
        fault_hook=DispatchFaults(fail_every=3, fake_clock=clock),
        clock=clock,
    )
    server.add_session(0)
    server.add_session(1)
    for _ in range(4):
        server.push(0, np.zeros((10 * 4, 3), np.float32))
        server.push(1, np.ones((10 * 4, 3), np.float32))
        server.poll()  # unforced: tickets carry
    # remove session 1 while a ticket may be in flight
    server.remove_session(1)
    server.flush()
    acct = server.stats.accounting()
    assert acct["balanced"] and acct["pending"] == 0
    assert server.stats.dispatch_retries > 0
    assert not server._slab_pool or all(
        len(v) <= 2 for v in server._slab_pool.values()
    )


def test_calibrate_device_measures_fused_program():
    """Satellite pin: a fused engine calibrates the FUSED program at
    the emitted shapes (the measurement carries fused=True), so
    device_ms attribution reflects what actually dispatches; the host
    stub ValueError is unchanged."""
    model = JitDemoModel(device="cpu", window=10)
    server = FleetServer(
        model, window=10, hop=10, smoothing="none",
        config=FleetConfig(target_batch=4, max_delay_ms=0.0, fused=True),
    )
    server.add_session(0)
    server.push(0, np.zeros((10 * 4, 3), np.float32))
    server.poll(force=True)
    cal = server.calibrate_device(iters=2)
    assert all(d["fused"] for d in cal.values())
    assert 4 in cal
    # events after calibration carry the fused program's device share
    server.push(0, np.zeros((10 * 4, 3), np.float32))
    events = server.flush()
    assert events and events[0].event.device_ms is not None
    # unfused engine measures the bare logits program
    server2 = FleetServer(
        model, window=10, hop=10, smoothing="none",
        config=FleetConfig(target_batch=4, max_delay_ms=0.0),
    )
    server2.add_session(0)
    server2.push(0, np.zeros((10 * 4, 3), np.float32))
    server2.poll(force=True)
    cal2 = server2.calibrate_device(iters=2)
    assert all(not d["fused"] for d in cal2.values())
    with pytest.raises(ValueError):
        FleetServer(_StubModel(), window=10, hop=10).calibrate_device()


# ------------------------------------------------------------ int8 tier


def test_make_scorer_int8_tier():
    """tier="int8" quantizes the model behind the same scorer
    interface (weights int8 on device as program inputs), an already-
    int8 model passes through, a host model raises, and an unknown
    tier is refused."""
    from har_tpu_torch.quantize import Int8ServingModel, quantize_serving

    model = JitDemoModel(device="cpu")
    scorer = make_scorer(model, None, tier="int8")
    assert isinstance(scorer, DeviceScorer)
    assert isinstance(scorer.model, Int8ServingModel)
    assert scorer.model.size_report()["ratio"] < 0.3
    # int8 leaves really are the device params
    kinds = {s.kind for s in scorer.model.stored}
    assert "q8" in kinds
    # already-quantized passthrough
    q = quantize_serving(model)
    assert make_scorer(q, None, tier="int8").model is q
    with pytest.raises(ValueError):
        make_scorer(_StubModel(), None, tier="int8")
    with pytest.raises(ValueError, match="tier"):
        make_scorer(model, None, tier="fp4")


def test_int8_tier_agreement_with_f32_fleet():
    """The int8 tier through the full fused+deep fleet path agrees
    with the f32 path on live labels (weight rounding may flip a
    rare boundary window — the shadow gate exists for exactly that, so
    the pin is a high agreement floor, not bitwise equality)."""
    from har_tpu_torch.quantize import quantize_serving

    model = JitDemoModel(device="cpu")
    n = 32
    recordings, _ = synthetic_sessions(n, windows_per_session=3, seed=13)

    def run(m, fused, depth):
        server = FleetServer(
            m, window=200, hop=200, smoothing="vote",
            config=FleetConfig(
                max_sessions=n, target_batch=16, pipeline_depth=depth,
                fused=fused,
            ),
        )
        for i in range(n):
            server.add_session(i)
        events, _ = drive_fleet(server, recordings, seed=13)
        return server, events

    s_f32, ev_f32 = run(model, False, 1)
    s_int8, ev_int8 = run(quantize_serving(model), True, 3)
    assert s_int8.stats.fused_dispatches == s_int8.stats.dispatches > 0
    a = [(fe.session_id, fe.event.t_index, fe.event.label)
         for fe in ev_f32]
    b = [(fe.session_id, fe.event.t_index, fe.event.label)
         for fe in ev_int8]
    assert len(a) == len(b)
    agreement = float(np.mean([x == y for x, y in zip(a, b)]))
    assert agreement >= 0.97
    acct = s_int8.stats.accounting()
    assert acct["balanced"] and acct["pending"] == 0


# ------------------------------------------------ depth 3→1 downsize


def test_resize_depth_3_to_1_downsize_while_two_tickets_fly():
    """Satellite pin: a depth 3→1 downsize staged while TWO carried
    tickets are still in flight — both retire on their old geometry,
    the pipe re-bounds immediately, and the event stream is
    bit-identical to a never-resized depth-3 run."""
    n = 8
    recs = _recordings(n, n_samples=900, seed=23)

    def run(resize_at):
        from har_tpu_torch.serve import FakeClock

        clock = FakeClock()
        server = FleetServer(
            _StubModel(), window=100, hop=50, smoothing="ema",
            config=FleetConfig(
                max_sessions=n, target_batch=4, max_delay_ms=0.0,
                pipeline_depth=3,
            ),
            clock=clock,
        )
        for i in range(n):
            server.add_session(i)
        events, snaps = [], []
        cursors = [0] * n
        rng = np.random.default_rng(5)
        rnd = 0
        saw_two_inflight = False
        while any(c < len(recs[i]) for i, c in enumerate(cursors)):
            for i in range(n):
                if cursors[i] >= len(recs[i]):
                    continue
                step = int(rng.integers(30, 90))
                server.push(i, recs[i][cursors[i]: cursors[i] + step])
                cursors[i] += step
            if resize_at is not None and rnd == resize_at:
                # two carried tickets fly at depth 3 between polls
                saw_two_inflight = len(server._inflight) >= 2
                server.resize(pipeline_depth=1, target_batch=4)
            events.extend(server.poll())  # unforced: tickets carry
            snaps.append(server.stats.accounting())
            clock.advance(0.01)
            rnd += 1
        events.extend(server.flush())
        snaps.append(server.stats.accounting())
        return server, events, snaps, saw_two_inflight

    sA, evA, snapsA, two = run(resize_at=6)
    sB, evB, snapsB, _ = run(resize_at=None)
    assert two, "harness: no two tickets were in flight at the resize"
    assert all(s["balanced"] for s in snapsA + snapsB)
    assert sA.stats.dropped_total == sB.stats.dropped_total == 0
    dA, dB = _decisions(evA), _decisions(evB)
    assert dA.keys() == dB.keys()
    for sid in dA:
        assert dA[sid] == dB[sid]
    assert sA.config.pipeline_depth == 1
    assert sA.stats.resizes == 1 and sA.stats.scale_downs == 1
    final = sA.stats.accounting()
    assert final["balanced"] and final["pending"] == 0


def test_vote_smoother_survives_stale_wider_votes():
    """Pin: a vote deque can hold labels from before a swap
    to a NARROWER model — the integer counting must mirror
    np.bincount(minlength=C)'s auto-extension (stale vote still
    counted, no IndexError in the retire loop)."""
    sm = _Smoother("vote", 0.4, 5)
    l1, r1, d1 = sm.step(np.asarray([0.1, 0.1, 0.1, 0.7]))
    assert (l1, r1) == (3, 3)
    # post-swap: 2-class probabilities, vote 3 still in the deque
    l2, r2, d2 = sm.step(np.asarray([0.6, 0.4]))
    assert r2 == 0
    assert len(d2) == 4  # bincount-compatible width: stale label kept
    np.testing.assert_allclose(d2, [0.5, 0.0, 0.0, 0.5])
    assert l2 == 0  # tie breaks toward the newest label achieving max


def test_fused_program_cache_dies_with_model():
    """The fused-program cache lives ON the model that owns the device
    program, so a swapped-out incumbent takes its fused program with it
    — including models whose forward closes over ``self`` (the
    NeuralModel pattern, which a weak-key table value would pin alive
    forever)."""
    import gc
    import weakref

    import torch

    class _SelfRefModel:
        # the forward closes over self, as a NeuralModel's module does
        num_classes = 3

        def __init__(self):
            self.w = torch.ones((30, 3))

        def device_program(self):
            from har_tpu_torch.serve.dispatch import DeviceProgram

            return DeviceProgram(
                self, lambda x: x.reshape(x.shape[0], -1) @ self.w,
                torch.device("cpu"), (self.w,),
            )

    model = _SelfRefModel()
    scorer = make_scorer(model, None, window=10)
    x = np.zeros((4, 10, 3), np.float32)
    labels, top = scorer.fetch_fused(scorer.launch_fused(x), 4)
    assert labels.shape == (4,) and top.shape == (4,)
    assert getattr(model, "_har_fused_cache", None), (
        "fused program not cached on the model"
    )
    # a second scorer over the same model reuses the cached program
    scorer2 = make_scorer(model, None, window=10)
    assert scorer2._fused_fn() is scorer._fused_fn()
    ref = weakref.ref(model)
    del model, scorer, scorer2
    gc.collect()
    assert ref() is None, "fused cache kept the swapped-out model alive"


def test_program_count_covers_the_fused_jit():
    """Pin: a fused engine compiles its shapes on the fused
    jit — program_count must count them (the compile-budget pin would
    otherwise be blind for the fused tier)."""
    model = JitDemoModel(device="cpu", window=10)
    scorer = make_scorer(model, None, window=10)
    base = scorer.program_count()
    for k in (4, 8):
        x = np.zeros((k, 10, 3), np.float32)
        scorer.fetch_fused(scorer.launch_fused(x), k)
    got = scorer.program_count()
    assert got is not None and base is not None
    assert got >= base + 2  # the two fused shapes joined the count


# ------------------------------------------- the port against har_tpu

FLEET_WINDOW, FLEET_HOP = 100, 50
PROB_TOL_DEMO = 1e-6  # float32 MLP: XLA's and torch's CPU GEMMs round apart
PROB_TOL_TRANSFORMER = 1e-4  # the f32 transformer, as the serving tests pin


def _narrow_transformer(seed=4):
    """(port model, har_tpu model): a 1-layer, embed-16 float32
    transformer with flax's parameters carried over (random_pair)."""
    from tests.test_torch_serving import random_pair

    port, jax_model, _ = random_pair(
        "transformer", window=FLEET_WINDOW, classes=6, seed=seed,
        kwargs=dict(embed_dim=16, num_heads=2, num_layers=1),
    )
    return port, jax_model


def _demo_pair(seed=1729):
    import har_tpu.serve as jax_serve

    return (JitDemoModel(window=FLEET_WINDOW, seed=seed, device="cpu"),
            jax_serve.JitDemoModel(window=FLEET_WINDOW, seed=seed))


def _fleet_run(pkg, model, *, smoothing="ema", depth=1, fused=False,
               sessions=24, wps=3, seed=11):
    """One package's fleet over seeded sessions under a FakeClock:
    ``{(session, t_index): (label, raw_label, drift, probability)}`` and
    the server."""
    import importlib

    serve = importlib.import_module(f"{pkg}.serve")
    clock = serve.FakeClock()
    server = serve.FleetServer(
        model, window=FLEET_WINDOW, hop=FLEET_HOP, smoothing=smoothing,
        config=serve.FleetConfig(max_sessions=sessions, target_batch=16,
                                 max_delay_ms=0.0, pipeline_depth=depth,
                                 fused=fused),
        clock=clock,
    )
    for i in range(sessions):
        server.add_session(i)
    recordings, _ = serve.synthetic_sessions(
        sessions, windows_per_session=wps, window=FLEET_WINDOW, seed=seed)
    events, _ = serve.drive_fleet(server, recordings, seed=seed)
    out = {(fe.session_id, fe.event.t_index): (
        fe.event.label, fe.event.raw_label, fe.event.drift,
        fe.event.probability) for fe in events}
    assert len(out) == len(events)
    acct = server.stats.accounting()
    assert acct["balanced"] and acct["pending"] == 0 and acct["dropped"] == 0
    return out, server


def _assert_fleets_agree(ours, theirs, atol, labels_equal=True):
    assert ours.keys() == theirs.keys() and ours
    worst = 0.0
    for key, (label, raw, drift, p) in ours.items():
        label2, raw2, drift2, p2 = theirs[key]
        if labels_equal:
            assert (label, raw, drift) == (label2, raw2, drift2), key
        worst = max(worst, float(np.abs(p - p2).max()))
    assert worst <= atol, worst
    return worst


def test_jit_demo_weights_equal_jax():
    """Both packages draw the demo MLP's weights with the same numpy
    generator: bit-equal float32 in the same (in, out) layout."""
    ours, theirs = _demo_pair()
    assert set(ours.params) == set(theirs.params) == {"w1", "b1", "w2"}
    for name in ("w1", "b1", "w2"):
        a = ours.params[name].detach().numpy()
        b = np.asarray(theirs.params[name])
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("smoothing, depth, fused", [
    ("ema", 1, False), ("vote", 3, True), ("none", 2, False),
])
def test_jit_demo_fleet_matches_jax(smoothing, depth, fused):
    """The same weights served by both fleets on the same schedule:
    labels equal, probabilities within 1e-6 (the fused runs compare the
    compact surrogate each package builds from its top probability)."""
    ours_model, jax_model = _demo_pair()
    ours, server = _fleet_run("har_tpu_torch", ours_model, smoothing=smoothing,
                              depth=depth, fused=fused)
    theirs, _ = _fleet_run("har_tpu", jax_model, smoothing=smoothing,
                           depth=depth, fused=fused)
    assert server.scorer.kind == "device"
    assert server.stats.fused_dispatches == (server.stats.dispatches if fused else 0)
    _assert_fleets_agree(ours, theirs, PROB_TOL_DEMO)


@pytest.mark.parametrize("smoothing, depth, fused", [
    ("ema", 1, False), ("none", 3, True),
])
def test_transformer_fleet_matches_jax(smoothing, depth, fused):
    """A narrow float32 transformer with flax's parameters carried over:
    the port's fleet (K2's plain version on the CPU) against har_tpu's
    (its Pallas kernel in interpret mode): labels equal, probabilities
    within 1e-4."""
    ours_model, jax_model = _narrow_transformer()
    ours, server = _fleet_run("har_tpu_torch", ours_model, smoothing=smoothing,
                              depth=depth, fused=fused, sessions=12)
    theirs, _ = _fleet_run("har_tpu", jax_model, smoothing=smoothing,
                           depth=depth, fused=fused, sessions=12)
    assert server.scorer.kind == "device"
    _assert_fleets_agree(ours, theirs, PROB_TOL_TRANSFORMER)


def test_device_scorer_probabilities_equal_transform_transformer():
    """Depth-1 fleet probabilities are the model's own ``transform`` on
    the same padded batch, bit for bit (same softmax expression)."""
    ours_model, _ = _narrow_transformer()
    scorer = make_scorer(ours_model, None, window=FLEET_WINDOW)
    x = np.random.default_rng(5).normal(size=(8, FLEET_WINDOW, 3)).astype(np.float32)
    got = scorer.fetch(scorer.launch(x), 8)
    np.testing.assert_array_equal(
        got, np.asarray(ours_model.transform(x).probability, np.float64))
    assert scorer.device_labels == ("cpu",)


def _stored_equal(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.kind == b.kind
        np.testing.assert_array_equal(a.value, np.asarray(b.value))
        if a.kind == "q8":
            assert a.value.dtype == np.int8 and a.scale.dtype == np.float32
            np.testing.assert_array_equal(a.scale, np.asarray(b.scale))


@pytest.mark.parametrize("family", ["demo", "transformer"])
def test_int8_serving_stored_values_bit_equal_to_jax(family):
    """quantize_serving quantizes every >=2-dim float leaf with the
    shared _q8: the stored int8 values and scales equal har_tpu's leaf
    for leaf, and so does the size report."""
    from har_tpu.quantize import quantize_serving as jax_quantize_serving
    from har_tpu_torch.quantize import Int8ServingModel, quantize_serving

    ours_model, jax_model = _demo_pair() if family == "demo" else _narrow_transformer()
    ours, theirs = quantize_serving(ours_model), jax_quantize_serving(jax_model)
    assert isinstance(ours, Int8ServingModel)
    _stored_equal(ours.stored, theirs.stored)
    assert ours.size_report() == theirs.size_report()
    assert ours.num_classes == theirs.num_classes
    assert ours.size_report()["quantized_kernels"] >= 2
    # the int8 tensors stay int8 where they live
    assert {t.dtype for t in ours.inner.tensors} >= {torch.int8}


@pytest.mark.parametrize("family", ["demo", "transformer"])
def test_int8_fleet_matches_jax_int8_fleet_and_own_f32(family):
    """The int8 tier through the fused, pipelined fleet: labels equal
    har_tpu's int8 fleet's (probabilities within the family's f32
    tolerance), and at least 97% equal to the port's own f32 fleet."""
    from har_tpu.quantize import quantize_serving as jax_quantize_serving
    from har_tpu_torch.quantize import quantize_serving

    ours_model, jax_model = _demo_pair() if family == "demo" else _narrow_transformer()
    tol = PROB_TOL_DEMO if family == "demo" else PROB_TOL_TRANSFORMER
    kw = dict(smoothing="none", depth=3, fused=True, sessions=16)
    ours, server = _fleet_run("har_tpu_torch", quantize_serving(ours_model), **kw)
    theirs, _ = _fleet_run("har_tpu", jax_quantize_serving(jax_model), **kw)
    assert server.stats.fused_dispatches == server.stats.dispatches > 0
    _assert_fleets_agree(ours, theirs, tol)
    f32, _ = _fleet_run("har_tpu_torch", ours_model, smoothing="none", sessions=16)
    agreement = np.mean([ours[k][0] == f32[k][0] for k in f32])
    assert agreement >= 0.97


def test_int8_serving_refuses_host_models_and_artifacts(tmp_path):
    from har_tpu_torch.export import export_model, load_exported
    from har_tpu_torch.quantize import quantize_serving

    with pytest.raises(ValueError):
        quantize_serving(_StubModel())
    with pytest.raises(ValueError):
        make_scorer(_StubModel(), None, tier="int8")
    ours_model, _ = _narrow_transformer()
    art = load_exported(export_model(ours_model, str(tmp_path / "art")), "cpu")
    with pytest.raises(ValueError, match="nothing to quantize"):
        quantize_serving(art)
    with pytest.raises(ValueError, match="nothing to quantize"):
        make_scorer(art, None, tier="int8")


def test_exported_artifact_serves_through_device_scorer(tmp_path):
    """A loaded ``predict.pt2`` routes to DeviceScorer with the fused
    loop declined; its launch plus fetch is within 1e-6 of its own
    ``transform`` (the program's softmax runs inside it, the fleet's on
    the fetched logits), and a fleet serves it with the checkpoint's
    labels."""
    from har_tpu_torch.export import export_model, load_exported

    ours_model, _ = _narrow_transformer()
    art = load_exported(export_model(ours_model, str(tmp_path / "art")), "cpu")
    scorer = make_scorer(art, None, window=FLEET_WINDOW)
    assert isinstance(scorer, DeviceScorer) and scorer.supports_fused is False
    assert scorer.params_bytes() == {"total": 0, "per_device": 0}
    x = np.random.default_rng(6).normal(size=(8, FLEET_WINDOW, 3)).astype(np.float32)
    np.testing.assert_allclose(scorer.fetch(scorer.launch(x), 8),
                               art.transform(x).probability, rtol=0, atol=1e-6)
    served, server = _fleet_run("har_tpu_torch", art, smoothing="vote", fused=True,
                                sessions=8)
    assert server.stats.fused_dispatches == 0  # declined, served unfused
    live, _ = _fleet_run("har_tpu_torch", ours_model, smoothing="vote", sessions=8)
    _assert_fleets_agree(served, live, 1e-6)


def test_no_host_fallback_for_a_device_model():
    """make_scorer serves on the host only what has no device program:
    any other error building the device path propagates, and a
    temperature-scaled model (logits post-processed on the host) is the
    one wrapper left to HostScorer, as in har_tpu."""
    from har_tpu_torch.ops.calibration import TemperatureScaledModel

    class _Broken:
        num_classes = 3

        def device_program(self):
            raise RuntimeError("the device program failed to build")

    with pytest.raises(RuntimeError, match="failed to build"):
        make_scorer(_Broken(), None)
    ours_model, _ = _narrow_transformer()
    assert isinstance(make_scorer(TemperatureScaledModel(ours_model, 1.5), None),
                      HostScorer)


def test_kernel_failure_raises_out_of_cli_serve(tmp_path, monkeypatch):
    """A K2 failure inside a dispatched batch is not absorbed as shed
    windows: ``serve`` raises it."""
    from har_tpu_torch import checkpoint, cli
    from har_tpu_torch.models import transformer
    from tests.test_torch_serving import random_pair

    port, _, kwargs = random_pair(
        "transformer", window=200, classes=6, seed=4,
        kwargs=dict(embed_dim=16, num_heads=2, num_layers=1))
    ckpt = checkpoint.save_model(str(tmp_path / "ckpt"), port, "transformer",
                                 kwargs, input_shape=(200, 3))

    def failing(q, k, v):
        raise RuntimeError("flash attention kernel failed")

    monkeypatch.setattr(transformer, "flash_attention", failing)
    with pytest.raises(RuntimeError, match="dispatch") as info:
        cli.main(["serve", "--device", "cpu", "--sessions", "4",
                  "--checkpoint", ckpt])
    assert "flash attention kernel failed" in str(info.value.__cause__)


@pytest.mark.parametrize("fused", [False, True])
def test_slab_rewritten_after_launch_leaves_the_ticket_unchanged(fused):
    """The staging copy is synchronous: rewriting the host slab right
    after ``launch`` returns (as a recycled slab or a re-staged arena
    slot would be) cannot change that ticket's result."""
    model = JitDemoModel(device="cpu", window=10)
    scorer = make_scorer(model, None, window=10)
    x = np.random.default_rng(8).normal(size=(8, 10, 3)).astype(np.float32)
    launch = scorer.launch_fused if fused else scorer.launch
    fetch = scorer.fetch_fused if fused else scorer.fetch
    want = fetch(launch(x.copy()), 8)
    slab = x.copy()
    handle = launch(slab)
    slab[:] = 1e3  # the next round's windows land in the same slab
    got = fetch(handle, 8)
    for a, b in zip(got if fused else (got,), want if fused else (want,)):
        np.testing.assert_array_equal(a, b)


def test_pipeline_smoke_on_one_device():
    """The pipelined-dispatch check (depth 3, fused, smoothing none)
    against synchronous depth 1, with the demo MLP and with a narrow
    transformer: identical decisions, confidences within 1e-6."""
    from har_tpu_torch.serve import fleet_pipeline_smoke

    out = fleet_pipeline_smoke(sessions=16, device="cpu", tunnel_rtt_ms=0.0)
    assert out["ok"], out
    assert out["devices"] == 1 and out["fused_dispatches"] > 0
    # the hot path batch-sharded over 8 devices, as the JAX package's
    # smoke shards it on its dry-run mesh
    out = fleet_pipeline_smoke(sessions=16, device="cpu", tunnel_rtt_ms=0.0, mesh=_mesh(8))
    assert out["ok"], out
    assert out["devices"] == 8 and out["dispatch_backend"] == "sharded"
    transformer, _ = _narrow_transformer()
    out = fleet_pipeline_smoke(sessions=12, model=transformer, window=FLEET_WINDOW,
                               target_batch=4)
    assert out["ok"], out
    # each leg on its own FakeClock (how chip_smoke.py runs it on the
    # card): the ring's depth stands in for the unmeasurable overlap
    out = fleet_pipeline_smoke(sessions=12, model=transformer, window=FLEET_WINDOW,
                               target_batch=4, fake_clock=True)
    assert out["ok"], out
    assert max(map(int, out["inflight_depth"])) > 1
