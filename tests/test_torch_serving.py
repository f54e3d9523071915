"""Single-stream serving (har_tpu_torch.serving) against har_tpu.serving.

The JAX package's serving pins, in the port: the event schedule,
chunking invariance, offline (``classify_session``) equal to online
streaming, EMA and vote smoothing, reset and latency stats, the
cold-sample contract, ``input_shape`` provenance, input validation,
segment merging and the bounded latency window.  Then, on float32 CNN1D
and transformer parameters carried across by ``convert``, both packages'
``StreamingClassifier`` and ``classify_session`` on the same recording:
t_index, raw and smoothed labels equal, probabilities within 1e-5.  The
CLI's ``stream`` on a saved port checkpoint with ``--device cpu`` prints
JAX's keys and events-CSV header, and its timeline equals JAX's
``StreamingClassifier`` on the same parameters.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import har_tpu.serving as jax_serving
from har_tpu.features.scaler import FittedScaler as JaxScaler
from har_tpu.models.neural import build_model as flax_build
from har_tpu.models.neural_classifier import NeuralClassifierModel as JaxClassifier
from har_tpu.train.trainer import NeuralModel as JaxNeuralModel
from har_tpu_torch import checkpoint, cli, convert, serving
from har_tpu_torch.features.scaler import FittedScaler
from har_tpu_torch.models.base import Predictions
from har_tpu_torch.models.neural import build_model
from har_tpu_torch.models.neural_classifier import NeuralClassifierModel
from har_tpu_torch.serving import StreamingClassifier, classify_session
from har_tpu_torch.train.trainer import NeuralModel

torch.set_num_threads(1)

PROB_TOL = dict(rtol=1e-5, atol=1e-5)
FAMILIES = {
    "cnn1d": dict(channels=(8, 8)),
    "transformer": dict(embed_dim=16, num_heads=2, num_layers=2),
}


def random_pair(name, window=40, channels=3, classes=4, seed=0, kwargs=None, shape=None):
    """(port NeuralClassifierModel, har_tpu NeuralClassifierModel): one
    float32 model of family ``name`` with random parameters (nonzero
    biases and norms) and a random scaler of ``shape`` (default (window,
    channels)), carried into flax by ``convert.neural_params_to_flax``;
    and the kwargs a checkpoint records."""
    shape = (window, channels) if shape is None else shape
    kwargs = dict(FAMILIES[name] if kwargs is None else kwargs,
                  dtype="float32", dropout_rate=0.0)
    module = build_model(name, classes, in_features=shape[-1], **kwargs)
    module.reset_parameters(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(torch.from_numpy(rng.normal(0, 0.1, p.shape).astype(np.float32)))
    module.eval()
    mean = rng.normal(0, 0.5, shape).astype(np.float32)
    std = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    port = NeuralClassifierModel(NeuralModel(module=module, num_classes=classes),
                                 FittedScaler(mean=mean, std=std), classes)
    tree = jax.tree.map(jnp.asarray, convert.neural_params_to_flax(name, module))
    flax_module = flax_build(name, num_classes=classes, **dict(kwargs, dtype=jnp.float32))
    jax_model = JaxClassifier(
        JaxNeuralModel(module=flax_module, params=tree, num_classes=classes),
        JaxScaler(mean=mean, std=std), classes,
    )
    return port, jax_model, kwargs


def recording(n=400, seed=0, channels=3, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, channels)) * scale).astype(np.float32)


class _StubModel:
    """Deterministic stand-in: class = sign pattern of the window mean
    (the JAX tests' stub)."""

    num_classes = 3

    def transform(self, x):
        x = np.asarray(x)
        m = x.mean(axis=(1, 2))
        raw = np.stack([-m, m, np.zeros_like(m)], axis=-1)
        e = np.exp(raw - raw.max(axis=-1, keepdims=True))
        return Predictions.from_raw(raw, e / e.sum(axis=-1, keepdims=True))


class _ContentLabeler:
    """A window whose mean exceeds 0.5 is class 1 at 0.9 confidence, else
    class 0."""

    num_classes = 2

    def transform(self, x):
        hot = np.asarray(x).mean(axis=(1, 2)) > 0.5
        p = np.where(hot[:, None], [[0.1, 0.9]], [[0.9, 0.1]])
        return Predictions.from_raw(np.log(p), p)


def _segmented_recording(labels, hop=10, channels=3):
    return np.concatenate(
        [np.full((hop, channels), float(lab), np.float32) for lab in labels]
    )


def test_event_schedule():
    events = StreamingClassifier(_StubModel(), window=200, hop=20,
                                 smoothing="none").push(recording(1000))
    assert [e.t_index for e in events] == list(range(200, 1001, 20))
    assert all(e.probability.shape == (3,) for e in events)
    assert all(abs(e.probability.sum() - 1.0) < 1e-6 for e in events)


def test_chunking_invariance():
    rec = recording(777)
    ev_whole = StreamingClassifier(_StubModel(), window=200, hop=30,
                                   smoothing="none").push(rec)
    chunked = StreamingClassifier(_StubModel(), window=200, hop=30, smoothing="none")
    ev_chunked, pos = [], 0
    rng = np.random.default_rng(1)
    while pos < len(rec):
        step = int(rng.integers(1, 97))
        ev_chunked.extend(chunked.push(rec[pos : pos + step]))
        pos += step
    assert [e.t_index for e in ev_whole] == [e.t_index for e in ev_chunked]
    assert [e.raw_label for e in ev_whole] == [e.raw_label for e in ev_chunked]
    for a, b in zip(ev_whole, ev_chunked):
        np.testing.assert_allclose(a.probability, b.probability, rtol=1e-6)


def test_offline_equals_online():
    rec = recording(1500, seed=3)
    online = StreamingClassifier(_StubModel(), window=200, hop=50,
                                 smoothing="none").push(rec)
    offline = classify_session(_StubModel(), rec, window=200, hop=50)
    assert len(offline) == len(online)
    np.testing.assert_array_equal(offline.labels, [e.raw_label for e in online])
    np.testing.assert_array_equal(offline.t_index, [e.t_index for e in online])


@pytest.mark.parametrize("name", list(FAMILIES))
def test_offline_equals_online_real_model(name):
    """A real float32 model on the CPU: hop-by-hop batches of one against
    one batched classify_session, smoothing off — labels equal; the
    probabilities agree within 1e-6, not bit for bit, since a batch of 1
    and one of 21 take different CPU convolution and GEMM blockings (the
    stub above holds the bit-for-bit contract of the machinery)."""
    port, _, _ = random_pair(name)
    rec = recording(200, seed=4)
    online = StreamingClassifier(port, window=40, hop=8, smoothing="none").replay(
        rec, calibrate=False)
    offline = classify_session(port, rec, window=40, hop=8)
    np.testing.assert_array_equal(offline.labels, [e.raw_label for e in online])
    np.testing.assert_allclose(offline.probability,
                               np.stack([e.probability for e in online]), rtol=0, atol=1e-6)


def test_ema_smoothing_suppresses_single_flip():
    rec = _segmented_recording([0, 0, 0, 0, 1, 0, 0, 0, 0, 0])
    events = StreamingClassifier(_ContentLabeler(), window=10, hop=10,
                                 smoothing="ema", ema_alpha=0.4).push(rec)
    assert len(events) == 10
    assert events[4].raw_label == 1
    assert all(e.label == 0 for e in events)


def test_vote_smoothing_and_tiebreak():
    sc = StreamingClassifier(_ContentLabeler(), window=10, hop=10,
                             smoothing="vote", vote_depth=3)
    events = sc.push(_segmented_recording([0, 1, 1, 0, 1]))
    assert [e.label for e in events] == [0, 1, 1, 1, 1]
    np.testing.assert_allclose(events[2].probability, [1 / 3, 2 / 3])
    assert all(e.probability[e.label] == e.probability.max() for e in events)


def test_reset_and_latency_stats():
    sc = StreamingClassifier(_StubModel(), window=100, hop=100, smoothing="none")
    assert sc.latency_stats() == {"count": 0}
    events = sc.push(recording(300))
    assert len(events) == 3
    stats = sc.latency_stats()
    assert stats["count"] == 1 and stats["p50_ms"] >= 0
    assert all(e.latency_ms <= stats["max_ms"] + 1e-9 for e in events)
    sc.push(recording(100))
    sc.push(recording(100))
    assert sc.latency_stats()["count"] == 3
    sc.reset()
    assert sc.latency_stats() == {"count": 0}
    assert [e.t_index for e in sc.push(recording(100))] == [100]
    assert sc.latency_stats()["steady_p50_ms"] is not None


def test_single_cold_sample_has_no_steady_latency():
    sc = StreamingClassifier(_StubModel(), window=100, hop=100, smoothing="none")
    sc.push(recording(100))
    assert sc.latency_stats()["count"] == 1
    assert sc.latency_stats()["steady_p50_ms"] is None


def test_from_checkpoint_window_provenance(tmp_path):
    port, _, kwargs = random_pair("cnn1d", window=200)
    ckpt = checkpoint.save_model(str(tmp_path / "ckpt"), port, "cnn1d", kwargs,
                                 input_shape=(200, 3))
    sc = StreamingClassifier.from_checkpoint(ckpt, device="cpu", hop=50)
    assert sc.window == 200 and sc.channels == 3 and sc.hop == 50
    assert StreamingClassifier.from_checkpoint(ckpt, device="cpu", window=None).window == 200
    with pytest.raises(ValueError, match="input_shape"):
        StreamingClassifier.from_checkpoint(ckpt, device="cpu", window=100)


def test_from_checkpoint_runs_on_cuda_by_default(tmp_path, monkeypatch):
    port, _, kwargs = random_pair("cnn1d", window=200)
    ckpt = checkpoint.save_model(str(tmp_path / "ckpt"), port, "cnn1d", kwargs,
                                 input_shape=(200, 3))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        StreamingClassifier.from_checkpoint(ckpt)


def test_from_checkpoint_refuses_classical_models(tmp_path):
    from har_tpu_torch.models.logistic_regression import LogisticRegressionModel

    model = LogisticRegressionModel(coefficients=np.zeros((3, 2), np.float32),
                                    intercept=np.zeros(2, np.float32),
                                    num_classes=2, device="cpu")
    path = checkpoint.save_classical_model(str(tmp_path / "lr"), model)
    with pytest.raises(ValueError, match="neural checkpoints"):
        StreamingClassifier.from_checkpoint(path, device="cpu")


def test_input_validation():
    sc = StreamingClassifier(_StubModel(), window=10, hop=5)
    with pytest.raises(ValueError, match="expected"):
        sc.push(np.zeros((4, 2)))
    with pytest.raises(ValueError, match="smoothing"):
        StreamingClassifier(_StubModel(), smoothing="mean")
    with pytest.raises(ValueError, match="shorter"):
        classify_session(_StubModel(), np.zeros((5, 3)), window=10)


def test_segments_merging():
    res = classify_session(_StubModel(), recording(400, seed=5), window=100, hop=50)
    segs = res.segments()
    assert segs[0][0] == 100 and segs[-1][1] == res.t_index[-1]
    rebuilt = []
    for start, end, label in segs:
        rebuilt.extend([label] * ((end - start) // 50 + 1))
    np.testing.assert_array_equal(rebuilt, res.labels)


def test_latency_window_bounded():
    sc = StreamingClassifier(_StubModel(), window=10, hop=10, smoothing="none")
    cap = sc._latencies.maxlen
    assert cap is not None and cap >= 1024
    rec = recording(10)
    for _ in range(cap + 50):
        sc.push(rec)
    assert sc.latency_stats()["count"] == cap == len(sc._latencies)


def test_replay_helper_matches_chunked_pushes():
    a = StreamingClassifier(_StubModel(), window=100, hop=50, smoothing="none")
    b = StreamingClassifier(_StubModel(), window=100, hop=50, smoothing="none")
    rec = recording(400)
    ev_a = a.replay(rec, calibrate=False)
    ev_b = []
    for i in range(0, len(rec), 50):
        ev_b.extend(b.push(rec[i : i + 50]))
    assert [e.t_index for e in ev_a] == [e.t_index for e in ev_b]
    assert [e.label for e in ev_a] == [e.label for e in ev_b]
    assert a.latency_stats()["count"] == len(ev_a)
    a.replay(rec, calibrate=True)  # the stub has no device forward: skipped
    assert "device_p50_ms" not in a.latency_stats()


def test_batch_mismatched_calibration_not_subtracted():
    port, _, _ = random_pair("cnn1d")
    sc = StreamingClassifier(port, window=40, hop=40, smoothing="none")
    sc.replay(recording(160), calibrate=False)
    sc.device_latency_ms(batch=4, iters=2)
    stats = sc.latency_stats()
    assert stats["device_batch"] == 4 and "device_p50_ms" in stats
    assert "host_overhead_p50_ms" not in stats
    sc.device_latency_ms(batch=1, iters=2)
    stats = sc.latency_stats()
    assert stats["device_batch"] == 1 and "host_overhead_p50_ms" in stats
    assert stats["host_overhead_p50_ms"] == round(
        max(0.0, stats["steady_p50_ms"] - stats["device_p50_ms"]), 3)


def test_device_timing_unwraps_calibrated_wrapper():
    from har_tpu_torch.ops.calibration import TemperatureScaledModel

    port, _, _ = random_pair("cnn1d")
    sc = StreamingClassifier(TemperatureScaledModel(model=port, temperature=1.7),
                             window=40, hop=40, smoothing="none")
    sc.replay(recording(160))
    stats = sc.latency_stats()
    assert stats["device_batch"] == 1 and "host_overhead_p50_ms" in stats
    with pytest.raises(ValueError, match="device timing"):
        serving.device_predict_fn(_StubModel())


def test_device_timing_on_exported_artifact(tmp_path):
    from har_tpu_torch.export import export_model, load_exported

    port, _, _ = random_pair("cnn1d")
    art = load_exported(export_model(port, str(tmp_path / "art")), "cpu")
    sc = StreamingClassifier(art, window=40, hop=40, smoothing="none")
    events = sc.replay(recording(160))
    assert len(events) == 4
    stats = sc.latency_stats()
    assert stats["device_batch"] == 1 and "host_overhead_p50_ms" in stats


def test_classify_session_timing_decomposition():
    port, _, _ = random_pair("cnn1d")
    rec = recording(160)
    res = classify_session(port, rec, window=40, hop=40, timing=True)
    t = res.timing
    assert t["n_windows"] == len(res) == 4 and t["e2e_ms"] > 0
    assert abs(t["per_window_ms"] - t["e2e_ms"] / 4) <= 1e-3
    assert t["device_p50_ms"] is not None and t["device_p50_ms"] > 0
    assert t["host_overhead_ms"] == round(max(0.0, t["e2e_ms"] - t["device_p50_ms"]), 3)
    res2 = classify_session(port, rec, window=40, hop=40)
    assert res2.timing is None
    np.testing.assert_array_equal(res.labels, res2.labels)
    res3 = classify_session(_StubModel(), rec, window=40, hop=40, timing=True)
    assert res3.timing["device_p50_ms"] is None and res3.timing["host_overhead_ms"] is None


def test_host_helpers_equal_jax():
    """finite_rows, pad_pow2 and pad_shard are numpy copies."""
    rec = recording(64, seed=9)
    rec[3, 1] = np.nan
    rec[7, 0] = np.inf
    rec[11, 2] = 2e6
    for max_abs in (1e6, None):
        got, bad = serving.finite_rows(rec, max_abs)
        want, want_bad = jax_serving.finite_rows(rec, max_abs)
        assert bad == want_bad
        np.testing.assert_array_equal(got, want)
    for k in (1, 3, 8, 9):
        np.testing.assert_array_equal(serving.pad_pow2(rec[:k]), jax_serving.pad_pow2(rec[:k]))
        for shards in (1, 2, 4):
            np.testing.assert_array_equal(serving.pad_shard(rec[:k], shards),
                                          jax_serving.pad_shard(rec[:k], shards))


@pytest.mark.parametrize("smoothing", ["ema", "vote", "none"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_stream_matches_jax(name, smoothing):
    """Both packages' StreamingClassifier over the same parameters and
    recording, fed in ragged chunks: t_index, raw and smoothed labels
    equal, probabilities within 1e-5."""
    port, jax_model, _ = random_pair(name)
    rec = recording(240, seed=6, scale=2.0)
    chunks = np.split(rec, [5, 50, 51, 130, 190])
    got = StreamingClassifier(port, window=40, hop=8, smoothing=smoothing)
    want = jax_serving.StreamingClassifier(jax_model, window=40, hop=8, smoothing=smoothing)
    ev_got = [e for c in chunks for e in got.push(c)]
    ev_want = [e for c in chunks for e in want.push(c)]
    assert len(ev_got) == len(ev_want) == (240 - 40) // 8 + 1
    assert [e.t_index for e in ev_got] == [e.t_index for e in ev_want]
    assert [e.raw_label for e in ev_got] == [e.raw_label for e in ev_want]
    assert [e.label for e in ev_got] == [e.label for e in ev_want]
    np.testing.assert_allclose(np.stack([e.probability for e in ev_got]),
                               np.stack([e.probability for e in ev_want]), **PROB_TOL)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_classify_session_matches_jax(name):
    port, jax_model, _ = random_pair(name, seed=1)
    rec = recording(300, seed=7, scale=2.0)
    got = classify_session(port, rec, window=40, hop=20)
    want = jax_serving.classify_session(jax_model, rec, window=40, hop=20)
    np.testing.assert_array_equal(got.t_index, want.t_index)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_allclose(got.probability, want.probability, **PROB_TOL)
    assert got.segments() == want.segments()


def jax_demo_recording():
    """The JAX CLI's demo recording, built as ``har_tpu/cli.py`` builds it."""
    from har_tpu.data.raw_windows import synthetic_raw_stream

    raw = synthetic_raw_stream(n_windows=24, seed=0)
    return np.concatenate(
        [raw.windows[raw.labels == c][:4].reshape(-1, 3) for c in (0, 1, 0)])


def test_cli_stream_matches_jax_streaming(tmp_path, capsys):
    """`stream` on a saved port checkpoint with --device cpu: JAX's JSON
    keys and events header, one event a hop of the demo recording, and
    the timeline, labels and rounded probabilities of har_tpu's
    StreamingClassifier on the same parameters."""
    port, jax_model, kwargs = random_pair("cnn1d", window=200, classes=6, seed=2)
    ckpt = checkpoint.save_model(str(tmp_path / "ckpt"), port, "cnn1d", kwargs,
                                 input_shape=(200, 3))
    events_csv = str(tmp_path / "events.csv")
    assert cli.main(["stream", "--checkpoint", ckpt, "--device", "cpu",
                     "--events-csv", events_csv]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"n_samples", "n_events", "timeline", "latency", "drift",
                        "events_csv"}
    rec = jax_demo_recording()
    np.testing.assert_array_equal(cli.demo_recording(), rec)
    assert out["n_samples"] == 2400 and out["n_events"] == 111
    assert out["latency"]["count"] == 111 and out["drift"] is None
    assert {"device_p50_ms", "host_overhead_p50_ms", "steady_p50_ms"} <= set(out["latency"])
    want = jax_serving.StreamingClassifier(jax_model, window=200, hop=20,
                                           smoothing="ema").replay(rec, calibrate=False)
    jax_sr = jax_serving.SessionResult(
        t_index=np.array([e.t_index for e in want]),
        labels=np.array([e.label for e in want]),
        probability=np.stack([e.probability for e in want]))
    assert out["timeline"] == [{"from_t": a, "to_t": b, "label": lab}
                               for a, b, lab in jax_sr.segments()]
    with open(events_csv) as f:
        rows = [line.strip().split(",") for line in f]
    assert rows[0] == ["t_index", "label", "raw_label", "latency_ms"] + [
        f"p{i}" for i in range(6)]
    assert len(rows) == 112
    assert [(int(r[0]), int(r[1]), int(r[2])) for r in rows[1:]] == [
        (e.t_index, e.label, e.raw_label) for e in want]
    probs = np.array([[float(v) for v in r[4:]] for r in rows[1:]])
    np.testing.assert_allclose(probs, np.stack([e.probability for e in want]),
                               atol=1e-5 + 5e-7)
