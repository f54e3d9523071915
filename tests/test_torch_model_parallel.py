"""Model-parallel serving of the port on a 2D (batch × model) serving mesh.

Ports ``tests/test_model_parallel.py``'s serving pins.  The port's meshes
are single-controller ``ServingMesh``es that repeat the CPU (2×4, 2×2),
as the JAX tests lay 2×4 over the 8-device dry-run mesh; ``har_tpu``'s
runs here on that mesh, on the same weights:

  1. serving equivalence — a ``ModelParallelScorer`` on 2×4 emits
     label-equal decisions (probs to 1e-6) vs the port's single device at
     every ticket-ring depth 1-4 under FakeClock + DispatchFaults, and vs
     ``har_tpu``'s 2×4 scorer on the same ``JitDemoModel`` weights (probs
     to 1e-5);
  2. the pad policy pads per BATCH-shard count (3 due windows → 4 rows);
  3. ``calibrate_device`` measures the placed program at the emitted
     (dp × pow2) shapes;
  4. the selection policy (host model → HostScorer, indivisible hidden
     dims or heads → ShardedScorer), ``params_bytes`` per device strictly
     below the total and equal to ``har_tpu``'s;
  5. composition — the int8 tier (``INT8_RULES``) and the fused loop;
  6. placement is a runtime resource — ``resize`` onto and off 2×4, the
     kill matrix and the randomized kill property behind 2×2;
  7. the transformer under ``TRANSFORMER_RULES`` at tp 2 and 4, and with
     patches or packed windows on 2×2: logits within 1e-5 of the
     unsharded module and of ``har_tpu``'s 2D scorer, with K2 run once a
     layer on each device's heads (layers × dp × tp a dispatch);
  8. what has no tensor-parallel forward in the port (a sequence-sharded
     transformer, which har_tpu cannot serve either; an int8 artifact
     without its leaf record) refuses a model axis; replicas on a second
     device are made when the scorer is built;
  9. CNN1D and BiLSTM (float32) and the int8 tiers of MLP, CNN1D, BiLSTM
     and the transformer on 2x2 and 1x4: har_tpu's scorer kind, labels,
     probabilities to 1e-5, params_bytes and every leaf's spec, K2 on
     each device's heads; CNN1D and the int8 transformer through the
     whole fleet on 2x2;
 10. each family's float and int8 artifact, exported by each package,
     on 2x1, 2x2, 1x2 and 1x4: the same pins against har_tpu's scorer,
     K2 on each device's heads for the int8 transformer, each device
     holding only its blocks; the int8 transformer artifact through the
     fleet on 2x2.
"""

import jax
import numpy as np
import pytest
import torch

import har_tpu.serve as jax_serve
from har_tpu.parallel.mesh import create_mesh as jax_create_mesh
from har_tpu_torch.parallel.mesh import create_serving_mesh
from har_tpu_torch.serve import (
    DispatchFaults,
    FakeClock,
    FleetConfig,
    FleetServer,
    JitDemoModel,
    drive_fleet,
    make_scorer,
    model_parallel_smoke,
    synthetic_sessions,
)
from har_tpu_torch.serve.dispatch import (
    DeviceScorer,
    HostScorer,
    ModelParallelScorer,
    ShardedScorer,
)

torch.set_num_threads(1)


def _mesh(dp, tp):
    return create_serving_mesh(dp=dp, tp=tp, devices=["cpu"] * (dp * tp))


def _jax_mesh(dp, tp):
    return jax_create_mesh(dp=dp, tp=tp, devices=jax.devices()[: dp * tp])


def _decisions(events):
    out = {}
    for fe in events:
        ev = fe.event
        out.setdefault(fe.session_id, []).append(
            (ev.t_index, ev.label, ev.raw_label, ev.drift,
             ev.probability.tobytes())
        )
    return out


def _assert_label_equal_probs_close(d1, d2, atol=1e-6):
    assert d1.keys() == d2.keys()
    for sid in d1:
        a, b = d1[sid], d2[sid]
        assert [x[:4] for x in a] == [y[:4] for y in b]  # labels/drift
        for x, y in zip(a, b):
            np.testing.assert_allclose(
                np.frombuffer(x[4]), np.frombuffer(y[4]), atol=atol
            )


def _ring_run(serve, model, mesh, depth, n=12):
    """The JAX pin's schedule: ragged pushes under FakeClock +
    DispatchFaults, in either package."""
    rng = np.random.default_rng(31)
    recs = [rng.normal(size=(500, 3)).astype(np.float32) for _ in range(n)]
    clock = serve.FakeClock()
    server = serve.FleetServer(
        model, window=100, hop=50, smoothing="ema",
        config=serve.FleetConfig(
            max_sessions=n, target_batch=16, max_delay_ms=0.0,
            retries=1, pipeline_depth=depth,
        ),
        fault_hook=serve.DispatchFaults(
            stall_every=3, stall_ms=1.0, fail_every=5, fake_clock=clock,
        ),
        clock=clock,
        mesh=mesh,
    )
    for i in range(n):
        server.add_session(i)
    events = []
    cursors = [0] * n
    step_rng = np.random.default_rng(7)
    while any(c < len(recs[i]) for i, c in enumerate(cursors)):
        for i in range(n):
            if cursors[i] >= len(recs[i]):
                continue
            step = int(step_rng.integers(20, 120))
            server.push(i, recs[i][cursors[i]: cursors[i] + step])
            cursors[i] += step
        events.extend(server.poll(force=True))
        clock.advance(0.01)
    events.extend(server.flush())
    return server, events


# ------------------------------------------- serving equivalence pin


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_model_parallel_matches_single_device_at_ring_depths(depth):
    """THE model-parallel pin: a 2×4 (batch × model) mesh serves
    label-equal decisions (probs to 1e-6) vs the single-device run, at
    every ticket-ring depth, under FakeClock + DispatchFaults."""
    import har_tpu_torch.serve as serve

    model = JitDemoModel(window=100, device="cpu")
    s1, ev1 = _ring_run(serve, model, None, 1)
    s2, ev2 = _ring_run(serve, model, _mesh(2, 4), depth)
    assert isinstance(s2.scorer, ModelParallelScorer)
    assert s2.scorer.model_axis_shards == 4
    assert s2.scorer.devices == 2  # batch shards only
    _assert_label_equal_probs_close(_decisions(ev1), _decisions(ev2))
    for s in (s1, s2):
        acct = s.stats.accounting()
        assert acct["balanced"] and acct["pending"] == 0
    assert s1.stats.scored == s2.stats.scored
    if depth >= 2:
        assert max(s2.stats.inflight_depth) >= 2
    assert s2.stats_snapshot()["model_axis_shards"] == 4
    assert s1.stats_snapshot()["model_axis_shards"] == 1


def test_model_parallel_matches_jax_model_parallel():
    """The same 2×4 schedule in both packages on the same JitDemoModel
    weights: equal labels, raw labels and drift, probabilities within
    1e-5, the same batches and the same snapshot's mesh fields."""
    import har_tpu_torch.serve as serve

    sp, evp = _ring_run(serve, JitDemoModel(window=100, device="cpu"), _mesh(2, 4), 2)
    sj, evj = _ring_run(jax_serve, jax_serve.JitDemoModel(window=100), _jax_mesh(2, 4), 2)
    assert type(sj.scorer).__name__ == type(sp.scorer).__name__ == "ModelParallelScorer"
    _assert_label_equal_probs_close(_decisions(evp), _decisions(evj), atol=1e-5)
    assert sp.stats.batch_sizes == sj.stats.batch_sizes
    assert sp.stats.device_windows == sj.stats.device_windows
    for key in ("devices", "model_axis_shards"):
        assert sp.stats_snapshot()[key] == sj.stats_snapshot()[key]


def test_pad_policy_pads_per_batch_shard_count():
    """3 due windows on a 2×4 mesh pad to dp × pow2 = 4 rows — NOT to
    the 8-row full-device batch a 1D mesh would emit."""
    model = JitDemoModel(device="cpu")
    server = FleetServer(
        model, window=200, hop=200, smoothing="none",
        config=FleetConfig(max_sessions=4, target_batch=16),
        mesh=_mesh(2, 4),
    )
    for i in range(3):
        server.add_session(i)
        server.push(i, np.zeros((200, 3), np.float32))
    events = server.flush()
    assert len(events) == 3
    assert set(server.stats.batch_sizes) == {4}
    assert len(server.stats.device_windows) == 8
    assert all(v > 0 for v in server.stats.device_windows.values())


def test_calibrate_device_measures_model_parallel_emitted_shapes():
    """Under a 2D mesh, calibrate_device times the PLACED model-parallel
    program at the dp × pow2 shapes the dispatcher actually emits, and
    device_ms stamps from it."""
    n = 20
    model = JitDemoModel(device="cpu")
    server = FleetServer(
        model, window=200, hop=200, smoothing="none",
        config=FleetConfig(max_sessions=n, target_batch=64),
        mesh=_mesh(2, 4),
    )
    recordings, _ = synthetic_sessions(n, windows_per_session=1, seed=1)
    for i in range(n):
        server.add_session(i)
    drive_fleet(server, recordings, seed=1)
    # 20 windows → dp(2) × pow2(ceil(20/2)=10 → 16) = 32 rows
    assert set(server.stats.batch_sizes) == {32}
    cal = server.calibrate_device(iters=2)
    assert 32 in cal and 2 in cal
    assert all(b % 2 == 0 for b in cal)
    for i in range(n):
        server.push(i, recordings[i])
    events = server.flush()
    assert events and all(e.event.device_ms is not None for e in events)
    assert events[0].event.device_ms == round(cal[32]["p50_ms"] / 20, 4)


def test_scorer_selection_policy_2d():
    """make_scorer routing: tp>1 → ModelParallelScorer; a host model
    falls back to HostScorer; an indivisible hidden dim falls back to
    the batch-only ShardedScorer (never crashes)."""
    mesh = _mesh(2, 4)
    assert isinstance(make_scorer(JitDemoModel(device="cpu"), mesh), ModelParallelScorer)
    dp_only = _mesh(8, 1)
    scorer = make_scorer(JitDemoModel(device="cpu"), dp_only)
    assert isinstance(scorer, ShardedScorer) and not isinstance(scorer, ModelParallelScorer)
    from tests.test_torch_fleet_dispatch import _StubModel

    assert isinstance(make_scorer(_StubModel(), mesh), HostScorer)
    # hidden=254 does not divide tp=4: the divisibility check refuses
    # the placement and the policy degrades to batch-only sharding
    scorer = make_scorer(JitDemoModel(hidden=254, device="cpu"), mesh)
    assert isinstance(scorer, ShardedScorer)
    assert not isinstance(scorer, ModelParallelScorer)
    assert scorer.kind == "sharded" and scorer.model_axis_shards == 1


def test_params_bytes_per_device_strictly_below_single_device():
    mesh = _mesh(2, 4)
    model = JitDemoModel(device="cpu")
    sb = make_scorer(model, None).params_bytes()
    pb = make_scorer(model, mesh).params_bytes()
    assert sb["per_device"] == sb["total"]
    assert pb["total"] == sb["total"]
    assert pb["per_device"] < sb["per_device"]
    assert pb["per_device"] < 0.6 * sb["total"]
    # the same accounting as har_tpu's on the same shapes
    jax_pb = jax_serve.make_scorer(jax_serve.JitDemoModel(), _jax_mesh(2, 4)).params_bytes()
    assert pb == jax_pb


def test_int8_tier_composes_with_model_parallel():
    """The int8 tier's leaf list shards positionally through INT8_RULES:
    same labels as the single-device int8 fleet (probs to 1e-6), with the
    per-device footprint split."""
    from har_tpu_torch.parallel.rules import INT8_RULES
    from har_tpu_torch.quantize import quantize_serving

    n = 12
    q = quantize_serving(JitDemoModel(device="cpu"))
    recordings, _ = synthetic_sessions(n, windows_per_session=2, seed=3)

    def run(m):
        server = FleetServer(
            q, window=200, hop=200, smoothing="ema",
            config=FleetConfig(max_sessions=n, target_batch=16),
            mesh=m,
        )
        for i in range(n):
            server.add_session(i)
        events, _ = drive_fleet(server, recordings, seed=3)
        return server, events

    s1, ev1 = run(None)
    s2, ev2 = run(_mesh(2, 4))
    assert isinstance(s2.scorer, ModelParallelScorer)
    assert s2.scorer.rules is INT8_RULES
    pb = s2.scorer.params_bytes()
    assert pb["per_device"] < pb["total"]
    _assert_label_equal_probs_close(_decisions(ev1), _decisions(ev2))


def test_fused_hot_loop_label_equal_on_2d_mesh():
    """The fused program composes with model-parallel placement: label
    equality with the unfused 2D-mesh run (the fused contract)."""
    n = 12
    model = JitDemoModel(device="cpu")
    recordings, _ = synthetic_sessions(n, windows_per_session=3, seed=8)

    def run(fused):
        server = FleetServer(
            model, window=200, hop=200, smoothing="vote",
            config=FleetConfig(max_sessions=n, target_batch=16, fused=fused),
            mesh=_mesh(2, 4),
        )
        for i in range(n):
            server.add_session(i)
        events, _ = drive_fleet(server, recordings, seed=8)
        return server, events

    s_plain, ev_plain = run(False)
    s_fused, ev_fused = run(True)
    assert isinstance(s_fused.scorer, ModelParallelScorer)
    assert s_fused.stats_snapshot()["fused_dispatches"] > 0
    d_plain, d_fused = _decisions(ev_plain), _decisions(ev_fused)
    assert d_plain.keys() == d_fused.keys()
    for sid in d_plain:
        assert [x[:2] for x in d_plain[sid]] == [y[:2] for y in d_fused[sid]]


def test_model_parallel_smoke_verdict_green():
    out = model_parallel_smoke(sessions=16, device="cpu")
    assert out["ok"], out
    assert out["mesh"] == "2x4" and out["model_axis_shards"] == 4
    assert out["params_bytes_per_device"] < out["params_bytes_single"]


# -------------------------------------------------- elastic + chaos


def test_resize_onto_and_off_2d_mesh_matches_never_resized():
    """Mid-run resize ONTO the 2×4 mesh and later OFF it again: the
    event stream stays label-equal (probs to 1e-6) to the never-resized
    single-device run."""
    n = 12
    model = JitDemoModel(device="cpu")
    recordings, _ = synthetic_sessions(n, windows_per_session=6, seed=9)
    thirds = [
        (r[: len(r) // 3], r[len(r) // 3: 2 * len(r) // 3], r[2 * len(r) // 3:])
        for r in recordings
    ]

    def run(resize):
        server = FleetServer(
            model, window=200, hop=200, smoothing="ema",
            config=FleetConfig(max_sessions=n, target_batch=16),
        )
        for i in range(n):
            server.add_session(i)
        ev, kinds = [], []
        for k, seed in ((0, 9), (1, 10), (2, 11)):
            if resize and k == 1:
                server.resize(mesh=_mesh(2, 4))  # onto the 2D mesh
            if resize and k == 2:
                server.resize(mesh=None)  # and off again
            got, _ = drive_fleet(server, [t[k] for t in thirds], seed=seed)
            ev.extend(got)
            kinds.append(server.scorer.kind)
        return server, ev, kinds

    s_flat, ev_flat, _ = run(False)
    s_resized, ev_resized, kinds = run(True)
    assert kinds == ["device", "model_parallel", "device"]
    assert s_resized.stats.resizes == 2
    assert isinstance(s_resized.scorer, DeviceScorer)
    assert not isinstance(s_resized.scorer, ShardedScorer)
    assert s_flat.stats.dropped_total == s_resized.stats.dropped_total == 0
    _assert_label_equal_probs_close(_decisions(ev_flat), _decisions(ev_resized))
    for s in (s_flat, s_resized):
        acct = s.stats.accounting()
        assert acct["balanced"] and acct["pending"] == 0


def _kill_points():
    from har_tpu_torch.serve.chaos import ENGINE_KILL_POINTS, KILL_POINTS

    return KILL_POINTS + ENGINE_KILL_POINTS


@pytest.mark.parametrize("point", _kill_points())
def test_kill_matrix_green_with_model_parallel_scorer(point):
    """Every engine kill point recovers behind the 2D mesh: restore
    re-places the weights through the SAME rule table and the recovered
    stream completes the reference run exactly."""
    from har_tpu_torch.serve.chaos import run_kill_point

    out = run_kill_point(point, sessions=4, seed=1, mesh=_mesh(2, 2))
    assert out["ok"], out


@pytest.mark.parametrize("seed", [11, 23])
def test_randomized_kill_property_green_with_model_parallel(seed):
    from har_tpu_torch.serve.chaos import run_random_kill

    out = run_random_kill(seed, mesh=_mesh(2, 2))
    assert out["ok"], out


# ------------------------------------------- the transformer, TRANSFORMER_RULES


def _transformer_pair(**options):
    from tests.test_torch_serving import random_pair

    port, jax_model, _ = random_pair(
        "transformer", window=24, classes=6, seed=3,
        kwargs=dict(embed_dim=32, num_heads=4, num_layers=2, **options),
    )
    return port, jax_model


@pytest.mark.parametrize("tp", [2, 4])
def test_transformer_model_parallel_logits(tp, monkeypatch):
    """TRANSFORMER_RULES at tp 2 and 4 on a 2 × tp mesh: the scorer's
    logits equal the unsharded module's and har_tpu's 2D scorer's within
    1e-5 (float32), K2 runs once a layer on each device's heads, and the
    per-device weights shrink."""
    import har_tpu_torch.ops.flash_attention as flash
    from har_tpu_torch.parallel.rules import TRANSFORMER_RULES

    port, jax_model = _transformer_pair()
    x = np.random.default_rng(5).normal(size=(6, 24, 3)).astype(np.float32)
    single = make_scorer(port, None, window=24)
    scorer = make_scorer(port, _mesh(2, tp), window=24)
    assert isinstance(scorer, ModelParallelScorer)
    assert scorer.rules is TRANSFORMER_RULES and scorer.model_axis_shards == tp
    calls = []
    real = flash.flash_attention_fwd
    monkeypatch.setattr(flash, "flash_attention_fwd",
                        lambda q, k, v, lse: calls.append(q.shape) or real(q, k, v, lse))
    padded = scorer.pad(x)
    got = scorer.launch(padded).numpy()
    layers = len(port.inner.module.blocks)
    assert len(calls) == layers * 2 * tp
    assert {c[2] for c in calls} == {4 // tp}  # each device's heads
    want = single.launch(single.pad(x)).numpy()
    np.testing.assert_allclose(got[: len(x)], want[: len(x)], atol=1e-5)
    jax_scorer = jax_serve.make_scorer(jax_model, _jax_mesh(2, tp), window=24)
    assert type(jax_scorer).__name__ == "ModelParallelScorer"
    jax_logits = np.asarray(jax_scorer.launch(jax_scorer.pad(x)))
    np.testing.assert_allclose(got[: len(x)], jax_logits[: len(x)], atol=1e-5)
    pb = scorer.params_bytes()
    assert pb["per_device"] < pb["total"] == single.params_bytes()["total"]


@pytest.mark.parametrize("option", [dict(patch_size=2), dict(window_pack=2)],
                         ids=["patch_size", "window_pack"])
def test_transformer_model_parallel_patched_and_packed(option, monkeypatch):
    """A transformer that embeds patches of 2 steps, and one that packs 2
    windows into a sequence (5 rows a shard: a padding window), on 2x2:
    the placed copy runs the model's own forward, its logits within 1e-5
    of the unsharded module's and of har_tpu's 2D scorer, K2 (the segment
    route when packed) once a layer on each device's heads."""
    import har_tpu_torch.ops.flash_attention as flash

    port, jax_model = _transformer_pair(**option)
    x = np.random.default_rng(7).normal(size=(10, 24, 3)).astype(np.float32)
    single = make_scorer(port, None, window=24)
    scorer = make_scorer(port, _mesh(2, 2), window=24)
    assert isinstance(scorer, ModelParallelScorer)
    calls = []
    real = flash.flash_attention_fwd
    monkeypatch.setattr(flash, "flash_attention_fwd",
                        lambda q, k, v, lse: calls.append(q.shape) or real(q, k, v, lse))
    padded = scorer.pad(x)
    got = scorer.launch(padded).numpy()
    assert len(calls) == 2 * 2 * 2 and {c[2] for c in calls} == {2}
    want = single.launch(single.pad(x)).numpy()
    np.testing.assert_allclose(got[: len(x)], want[: len(x)], atol=1e-5)
    jax_scorer = jax_serve.make_scorer(jax_model, _jax_mesh(2, 2), window=24)
    assert type(jax_scorer).__name__ == "ModelParallelScorer"
    jax_logits = np.asarray(jax_scorer.launch(jax_scorer.pad(x)))
    np.testing.assert_allclose(got[: len(x)], jax_logits[: len(x)], atol=1e-5)


def test_families_without_a_tensor_parallel_forward_refuse_a_model_axis(tmp_path):
    """What has no tensor-parallel forward in the port refuses a mesh
    with a model axis (never served quietly on fewer devices): a
    sequence-sharded transformer (float or int8), and an int8 artifact
    written without the record of its weight leaves (an older export),
    with a message to export it again.  A mesh with data axes only shards
    their batch, as it shards a CNN's, and a float artifact needs no
    record."""
    import json

    from har_tpu_torch.export import export_model, load_exported
    from har_tpu_torch.models.neural import build_model
    from har_tpu_torch.models.neural_classifier import NeuralClassifierModel
    from har_tpu_torch.quantize import quantize_model
    from har_tpu_torch.serve.model_parallel import NoTensorParallelForward
    from har_tpu_torch.train.trainer import NeuralModel
    from tests.test_torch_serving import random_pair

    cnn, _, _ = random_pair("cnn1d", window=24, classes=6, seed=3)
    assert type(make_scorer(cnn, _mesh(4, 1), window=24)) is ShardedScorer
    assert type(make_scorer(cnn, _mesh(2, 2), window=24)) is ModelParallelScorer
    old = export_model(quantize_model(cnn), str(tmp_path / "art8"))
    meta_path = tmp_path / "art8" / "export_meta.json"
    meta = json.loads(meta_path.read_text())
    del meta["int8_leaves"]
    meta_path.write_text(json.dumps(meta))
    art = load_exported(old, "cpu")
    assert art.int8_weights
    with pytest.raises(NoTensorParallelForward, match="export it again"):
        make_scorer(art, _mesh(2, 2), window=24)
    with pytest.raises(NoTensorParallelForward, match="export it again"):
        FleetServer(art, window=24, hop=24, mesh=_mesh(2, 2)).scorer
    assert type(make_scorer(art, _mesh(4, 1), window=24)) is ShardedScorer
    floating = load_exported(export_model(cnn, str(tmp_path / "art")), "cpu")
    assert "int8_leaves" not in floating.meta
    assert type(make_scorer(floating, _mesh(2, 2), window=24)) is ModelParallelScorer
    module = build_model("transformer", 6, in_features=3, embed_dim=32, num_heads=4,
                         num_layers=2, dtype="float32", sp_axis="sp").eval()
    ring = NeuralClassifierModel(NeuralModel(module=module, num_classes=6), None, 6)
    for tier in ("f32", "int8"):
        with pytest.raises(NoTensorParallelForward, match="sequence-sharded"):
            make_scorer(ring, _mesh(1, 2), tier=tier, window=24)


@pytest.mark.parametrize("tier", ["f32", "int8"])
def test_sequence_sharded_transformer_refused_by_both_packages(tier):
    """``Transformer1D(sp_axis=)`` has no serving scorer in either
    package: har_tpu's raises NameError (an unbound axis name) by its
    first launch on one device and on 2x1, 2x2 and 1x2; the port raises
    at once, a ValueError (the unbound mesh axis) where no model axis is
    asked for and NoTensorParallelForward on one."""
    from har_tpu_torch.serve.model_parallel import NoTensorParallelForward
    from tests.test_torch_serving import random_pair

    port, jax_model, _ = random_pair(
        "transformer", window=24, classes=6, seed=3,
        kwargs=dict(embed_dim=32, num_heads=4, num_layers=2, sp_axis="sp"))
    x = np.random.default_rng(5).normal(size=(6, 24, 3)).astype(np.float32)
    for shape in (None, (2, 1), (2, 2), (1, 2)):
        jax_mesh = None if shape is None else _jax_mesh(*shape)
        with pytest.raises(NameError, match="unbound axis name: sp"):
            scorer = jax_serve.make_scorer(jax_model, jax_mesh, tier=tier, window=24)
            scorer.fetch(scorer.launch(scorer.pad(x)), len(x))
        mesh = None if shape is None else _mesh(*shape)
        if shape is not None and shape[1] > 1:
            with pytest.raises(NoTensorParallelForward, match="sequence-sharded"):
                make_scorer(port, mesh, tier=tier, window=24)
        else:
            with pytest.raises(ValueError, match="'sp' is not bound"):
                scorer = make_scorer(port, mesh, tier=tier, window=24)
                scorer.fetch(scorer.launch(scorer.pad(x)), len(x))


# ------------------------- CNN1D, BiLSTM and the neural int8 tiers, har_tpu


# the family/tier combinations har_tpu serves on a model axis, at
# random_pair(window=24, classes=6, seed=3), and their params_bytes
# (total, per device) on 2x2 in both packages
NEW_FAMILIES = {
    "cnn1d-f32": ("cnn1d", "f32", dict(channels=(8, 8)), (9656, 5816)),
    "bilstm-f32": ("bilstm", "f32", dict(hidden=16), (11032, 10636)),
    "mlp-int8": ("mlp", "int8", dict(hidden=(32, 16)), (920, 536)),
    "cnn1d-int8": ("cnn1d", "int8", dict(channels=(8, 8)), (2960, 2052)),
    "bilstm-int8": ("bilstm", "int8", dict(hidden=16), (2776, 2616)),
    "transformer-int8": ("transformer", "int8",
                         dict(embed_dim=32, num_heads=4, num_layers=2), (28600, 15644)),
}


def _padded(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


def _jax_leaf_specs(jax_scorer):
    """har_tpu's resolved specs by '/'-joined flax path (or position)."""
    from jax.sharding import PartitionSpec

    from har_tpu.parallel.rules import tree_path_str

    flat = jax.tree_util.tree_flatten_with_path(
        jax_scorer.param_specs, is_leaf=lambda s: isinstance(s, PartitionSpec))[0]
    leaves = jax.tree_util.tree_flatten_with_path(jax_scorer._inner.params)[0]
    return {tree_path_str(p): _padded(s, np.ndim(leaf))
            for (p, s), (_, leaf) in zip(flat, leaves)}


def _port_leaf_specs(scorer, family, tier, module):
    """The port's specs in har_tpu's terms: an int8 tier's by position;
    a float model's through its flax paths, a Dense weight's spec
    reversed (the kernel is its transpose)."""
    from har_tpu_torch import convert

    if tier == "int8":
        return {k: _padded(s, scorer._tp.tree[k].dim()) for k, s in scorer.param_specs.items()}
    out = {}
    for name, (path, ndim) in convert.flax_leaf_names(family, module).items():
        spec = _padded(scorer.param_specs[name], ndim)
        out[path] = spec[::-1] if path.endswith("/kernel") and ndim == 2 else spec
    return out


@pytest.mark.parametrize("dp,tp", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
@pytest.mark.parametrize("case", list(NEW_FAMILIES))
def test_new_families_match_har_tpu_model_parallel(case, dp, tp, monkeypatch):
    """CNN1D and BiLSTM (float32) and the int8 tiers of MLP, CNN1D, BiLSTM
    and the transformer on a dp x tp mesh: the scorer's kind is
    har_tpu's (model-parallel, or the rung below where a shard does not
    divide), labels equal and probabilities within 1e-5 of har_tpu's
    scorer and of the port's single device, params_bytes equal to
    har_tpu's, every leaf's spec har_tpu's, and K2 once a layer on each
    device's heads."""
    import har_tpu_torch.ops.flash_attention as flash
    from tests.test_torch_serving import random_pair

    family, tier, kwargs, on_2x2 = NEW_FAMILIES[case]
    port, jax_model, _ = random_pair(family, window=24, classes=6, seed=3, kwargs=kwargs)
    x = np.random.default_rng(5).normal(size=(6, 24, 3)).astype(np.float32)
    scorer = make_scorer(port, _mesh(dp, tp), tier=tier, window=24)
    single = make_scorer(port, None, tier=tier, window=24)
    jax_scorer = jax_serve.make_scorer(jax_model, _jax_mesh(dp, tp), tier=tier, window=24)
    assert scorer.kind == jax_scorer.kind
    want = single.fetch(single.launch(single.pad(x)), len(x))
    calls = []
    real = flash.flash_attention_fwd
    monkeypatch.setattr(flash, "flash_attention_fwd",
                        lambda q, k, v, lse: calls.append(q.shape) or real(q, k, v, lse))
    got = scorer.fetch(scorer.launch(scorer.pad(x)), len(x))
    monkeypatch.undo()
    jax_probs = jax_scorer.fetch(jax_scorer.launch(jax_scorer.pad(x)), len(x))
    for ref in (want, jax_probs):
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
        np.testing.assert_allclose(got, ref, atol=1e-5)
    assert scorer.params_bytes() == jax_scorer.params_bytes()
    if (dp, tp) == (2, 2):
        assert scorer.kind == "model_parallel"
        assert tuple(scorer.params_bytes().values()) == on_2x2
    if scorer.kind == "model_parallel":
        module = port.inner.module
        assert _port_leaf_specs(scorer, family, tier, module) == _jax_leaf_specs(jax_scorer)
        layers = len(module.blocks) if family == "transformer" else 0
        assert len(calls) == layers * dp * tp
        if layers:
            assert {c[2] for c in calls} == {module.blocks[0].num_heads // tp}


@pytest.mark.parametrize("case", ["cnn1d-f32", "transformer-int8"])
def test_new_families_fleet_model_parallel_equals_single_device(case):
    """CNN1D (float32) and the int8 transformer served on 2x2 through the
    whole fleet: label-equal to the single device, probabilities within
    1e-6."""
    from har_tpu_torch.quantize import quantize_serving
    from tests.test_torch_serving import random_pair

    family, tier, kwargs, _ = NEW_FAMILIES[case]
    port, _, _ = random_pair(family, window=24, classes=6, seed=3, kwargs=kwargs)
    model = quantize_serving(port) if tier == "int8" else port
    out = model_parallel_smoke(sessions=8, dp=2, tp=2, device="cpu", model=model,
                               window=24, target_batch=8)
    assert out["ok"], out
    assert out["model_axis_shards"] == 2 and out["batch_shards"] == 2


def test_int8_demo_params_bytes_match_har_tpu():
    """The demo MLP's int8 tier counts its stored leaves (int8 kernels and
    the float32 bias), not their scales, as har_tpu does: on one device
    and on 2x4."""
    from har_tpu_torch.quantize import quantize_serving

    q = quantize_serving(JitDemoModel(device="cpu"))
    jax_q = jax_serve.make_scorer(jax_serve.JitDemoModel(), None, tier="int8")
    assert make_scorer(q, None).params_bytes() == jax_q.params_bytes()
    jax_mp = jax_serve.make_scorer(jax_serve.JitDemoModel(), _jax_mesh(2, 4), tier="int8")
    assert make_scorer(q, _mesh(2, 4)).params_bytes() == jax_mp.params_bytes()


def test_replicas_are_made_when_the_scorer_is_built(tmp_path):
    """A data shard on a second device gets its replica when the scorer
    is built, not at its first dispatch: a module is copied there, a
    loaded artifact is loaded there again (``ExportedPredictor.to``), and
    a program that can be neither refuses the mesh at once."""
    import dataclasses

    from har_tpu_torch.export import export_model, load_exported

    two = create_serving_mesh(dp=2, tp=1, devices=["cpu", "meta"])
    scorer = make_scorer(JitDemoModel(device="cpu"), two)
    assert {p.device.type for p in scorer._replicas[torch.device("meta")].parameters()} == {"meta"}
    port, _ = _transformer_pair()
    art = load_exported(export_model(port, str(tmp_path / "art")), "cpu")
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(4, 24, 3)).astype(np.float32))
    torch.testing.assert_close(art.to("cpu").device_call(x), art.device_call(x), rtol=0, atol=0)
    with pytest.raises(ValueError, match="cannot be copied to meta"):
        make_scorer(dataclasses.replace(art, path=None), two, window=24)


def test_transformer_heads_indivisible_fall_back_to_batch_sharding():
    """H % tp != 0 refuses the placement: 4 heads on tp 8 serve
    batch-sharded."""
    port, _ = _transformer_pair()
    scorer = make_scorer(port, _mesh(1, 8), window=24)
    assert isinstance(scorer, DeviceScorer) and not isinstance(scorer, ShardedScorer)
    scorer = make_scorer(port, _mesh(2, 8), window=24)
    assert type(scorer) is ShardedScorer


def test_transformer_fleet_model_parallel_equals_single_device():
    """The narrow transformer served on 2×2 through the whole fleet:
    label-equal to the single device, probabilities within 1e-6."""
    port, _ = _transformer_pair()
    out = model_parallel_smoke(sessions=8, dp=2, tp=2, device="cpu", model=port,
                               window=24, target_batch=8)
    assert out["ok"], out
    assert out["model_axis_shards"] == 2 and out["batch_shards"] == 2


# ------------------------------------ exported artifacts on a model axis


# the four families at the fixture widths, exported by each package from
# the same weights, float32 and int8
ARTIFACT_FAMILIES = {
    "mlp": dict(hidden=(32, 16)),
    "cnn1d": dict(channels=(8, 8)),
    "bilstm": dict(hidden=16),
    "transformer": dict(embed_dim=32, num_heads=4, num_layers=2),
}
ARTIFACTS = [f"{family}-{tier}" for family in ARTIFACT_FAMILIES for tier in ("f32", "int8")]
ARTIFACT_LAYOUTS = [(2, 1), (2, 2), (1, 2), (1, 4)]
# har_tpu's (kind, params_bytes total, per device) of each int8 artifact on
# 2x2 and 1x2; every float artifact is model-parallel with 0 / 0 there
# and on 1x4, where every int8 artifact takes the single-device rung
INT8_ARTIFACT_ON_TP2 = {
    "mlp": (920, 536),
    "cnn1d": (2960, 2052),
    "bilstm": (10456, 10104),
    "transformer": (28600, 15644),
}


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """case -> (the port's artifact loaded on the CPU, har_tpu's, the JAX
    weight list's flax paths), each exported and loaded once."""
    from har_tpu.export import export_model as jax_export_model
    from har_tpu.export import load_exported as jax_load_exported
    from har_tpu.quantize import quantize_model as jax_quantize_model
    from har_tpu_torch.export import export_model, load_exported
    from har_tpu_torch.quantize import quantize_model
    from tests.test_torch_serving import random_pair

    root = tmp_path_factory.mktemp("artifacts")
    out = {}
    for family, kwargs in ARTIFACT_FAMILIES.items():
        port, jax_model, _ = random_pair(family, window=24, classes=6, seed=3, kwargs=kwargs)
        for tier in ("f32", "int8"):
            case = f"{family}-{tier}"
            p, j = port, jax_model
            paths = []
            if tier == "int8":
                p, j = quantize_model(port), jax_quantize_model(jax_model)
                paths = ["/".join(str(getattr(k, "key", k)) for k in path) for path, _ in
                         jax.tree_util.tree_flatten_with_path(jax_model.inner.params)[0]]
            out[case] = (load_exported(export_model(p, str(root / f"port-{case}")), "cpu"),
                         jax_load_exported(jax_export_model(j, str(root / f"jax-{case}"))),
                         paths)
    return out


def _count_k2(monkeypatch):
    """Every K2 forward (the op's plain version on the CPU, whether the
    program's own node or a call on a device's heads runs it): the heads
    each attended on."""
    import har_tpu_torch.ops.flash_attention as flash

    calls = []
    real = flash.attention_with_lse_plain
    monkeypatch.setattr(flash, "attention_with_lse_plain",
                        lambda q, k, v: calls.append(q.shape[2]) or real(q, k, v))
    return calls


@pytest.mark.parametrize("dp,tp", ARTIFACT_LAYOUTS, ids=[f"{d}x{t}" for d, t in ARTIFACT_LAYOUTS])
@pytest.mark.parametrize("case", ARTIFACTS)
def test_exported_artifacts_match_har_tpu_on_a_model_axis(case, dp, tp, exported, monkeypatch):
    """Each family's float and int8 artifact, exported by each package
    from the same weights, on dp x tp: the port's scorer kind,
    params_bytes and every leaf's spec (matched by flax path) are
    har_tpu's; labels equal and probabilities within 1e-5 of har_tpu's
    scorer and of the port's single device; K2 runs layers x dp x tp
    times on H / tp heads each for the int8 transformer on a model axis,
    layers x the data shards for a float one."""
    family, tier = case.rsplit("-", 1)
    art, jax_art, paths = exported[case]
    x = np.random.default_rng(5).normal(size=(6, 24, 3)).astype(np.float32)
    single = make_scorer(art, None, window=24)
    want = single.fetch(single.launch(single.pad(x)), len(x))
    scorer = make_scorer(art, _mesh(dp, tp), window=24)
    jax_scorer = jax_serve.make_scorer(jax_art, _jax_mesh(dp, tp), window=24)
    assert scorer.kind == jax_scorer.kind
    calls = _count_k2(monkeypatch)
    got = scorer.fetch(scorer.launch(scorer.pad(x)), len(x))
    monkeypatch.undo()
    jax_probs = jax_scorer.fetch(jax_scorer.launch(jax_scorer.pad(x)), len(x))
    for ref in (want, jax_probs):
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
        np.testing.assert_allclose(got, ref, atol=1e-5)
    assert scorer.params_bytes() == jax_scorer.params_bytes()
    if tp > 1:
        int8 = tier == "int8"
        kind = "device" if int8 and tp == 4 else "model_parallel"
        assert scorer.kind == kind
        if kind == "model_parallel":
            total, per_device = INT8_ARTIFACT_ON_TP2[family] if int8 else (0, 0)
            assert scorer.params_bytes() == {"total": total, "per_device": per_device}
            specs = {paths[int(k)]: _padded(s, scorer._tp.tree[k].dim())
                     for k, s in scorer.param_specs.items()}
            assert specs == {paths[int(k)]: s for k, s in _jax_leaf_specs(jax_scorer).items()}
    else:
        assert scorer.kind == "sharded"
    heads = ARTIFACT_FAMILIES[family].get("num_heads")
    if heads is None:
        assert calls == []
    else:
        split = scorer.kind == "model_parallel" and tier == "int8"
        shards = {"model_parallel": dp, "sharded": dp, "device": 1}[scorer.kind]
        assert len(calls) == 2 * shards * (tp if split else 1)
        assert set(calls) == {heads // tp if split else heads}


@pytest.mark.parametrize("family", list(ARTIFACT_FAMILIES))
def test_int8_artifact_rows_keep_only_their_blocks(family, exported, monkeypatch):
    """An int8 artifact on 2x2 and 1x2: each device of each row keeps its
    blocks of the split leaves and the replicated leaves, ``per_device``
    bytes of stored values in all (counted by device index: every device
    is the CPU here), and no device a whole copy of a split leaf; every
    dense layer whose kernel is split runs column- or row-parallel on
    the blocks, once a data shard a dispatch."""
    from har_tpu_torch.serve import model_parallel

    art = exported[f"{family}-int8"][0]
    record = art.meta["int8_leaves"]
    parallel = []
    for name in ("_linear_col", "_linear_row"):
        real = getattr(model_parallel, name)
        monkeypatch.setattr(model_parallel, name,
                            lambda *a, real=real, name=name: parallel.append(name) or real(*a))
    x = np.random.default_rng(5).normal(size=(6, 24, 3)).astype(np.float32)
    for dp, tp in ((2, 2), (1, 2)):
        scorer = make_scorer(art, _mesh(dp, tp), window=24)
        assert scorer.kind == "model_parallel"
        parallel.clear()
        scorer.launch(scorer.pad(x))
        split_kernels = sum(
            1 for k, r in enumerate(record)
            if r["path"].endswith("/kernel") and len(r["shape"]) == 2
            and any(e is not None for e in tuple(scorer.param_specs[str(k)])))
        assert split_kernels > 0 and len(parallel) == dp * split_kernels
        placed = scorer._tp.placed
        per_device = scorer.params_bytes()["per_device"]
        split = 0
        for i in range(dp):
            for j in range(tp):
                held = 0
                for r in record:
                    for b in r["buffers"]:
                        block = placed[b["value"]][i, j]
                        held += block.numel() * block.element_size()
                        if block.numel() < int(np.prod(r["shape"])):
                            split += 1
                assert held == per_device
        assert split > 0


def test_int8_artifact_fleet_on_2x2_equals_single_device(exported):
    """The int8 transformer artifact through the whole fleet on 2x2
    (FleetServer): no window dropped, labels equal to one device,
    probabilities within 1e-6."""
    art = exported["transformer-int8"][0]
    out = model_parallel_smoke(sessions=8, dp=2, tp=2, device="cpu", model=art,
                               window=24, target_batch=8)
    assert out["ok"], out
    assert out["dropped"] == 0
    assert out["model_axis_shards"] == 2 and out["batch_shards"] == 2
