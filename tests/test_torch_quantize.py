"""Weight-only int8 quantization (har_tpu_torch.quantize) against
har_tpu.quantize.

Quantizing in flax's layout makes the stored int8 values and scales
bit-equal to ``har_tpu.quantize.quantize_model``'s on the same flax tree,
leaf for leaf in jax.tree_util's order, for every neural family; the
dequantized float32 logits are within 1e-5 of the JAX package's
``QuantizedModel``; the size report is the JAX package's.  On a trained
CNN1D, JAX's contract (``tests/test_quantize.py:33-48``): accuracy within
0.01 of float, probabilities within atol 0.05; the quantized model
streams with the float model's raw labels.  The fleet's int8 tier
(``quantize_serving``, ``tests/test_quantize.py:176-230``) is held to
har_tpu's in tests/test_torch_fleet_dispatch.py, beside the port's fleet
engine (``har_tpu_torch/serve``).
"""

import numpy as np
import pytest
import torch

import har_tpu.quantize as jax_quantize
from har_tpu_torch.data.raw_windows import synthetic_raw_stream
from har_tpu_torch.features.wisdm_pipeline import FeatureSet
from har_tpu_torch.models.neural_classifier import NeuralClassifier
from har_tpu_torch.ops.metrics import evaluate
from har_tpu_torch.quantize import QuantizedModel, quantize_model
from har_tpu_torch.serving import StreamingClassifier
from har_tpu_torch.train.trainer import TrainerConfig
from tests.test_torch_serving import random_pair, recording

torch.set_num_threads(1)

CASES = {
    "mlp": dict(kwargs=dict(hidden=(16, 8)), shape=(13,)),
    "cnn1d": dict(kwargs=dict(channels=(8, 16), norm="rms", pool="stride")),
    "bilstm": dict(kwargs=dict(hidden=8), shape=(16, 3)),
    "transformer": dict(kwargs=dict(embed_dim=16, num_heads=2, num_layers=2)),
    "transformer_patched_scan": dict(kwargs=dict(embed_dim=16, num_heads=2, num_layers=2,
                                                 patch_size=4, scan_layers=True)),
}


def _pair(case, seed=0):
    spec = CASES[case]
    name = case.split("_")[0]
    return random_pair(name, seed=seed, kwargs=spec["kwargs"], shape=spec.get("shape"))


def _x(model, n=6, seed=1):
    shape = np.asarray(model.scaler.mean).shape
    return np.random.default_rng(seed).normal(size=(n, *shape)).astype(np.float32) * 2


@pytest.mark.parametrize("case", list(CASES))
def test_int8_values_and_scales_bit_equal_to_jax(case):
    port, jax_model, _ = _pair(case)
    got = quantize_model(port)
    want = jax_quantize.quantize_model(jax_model)
    assert len(got.stored) == len(want.stored)
    for a, b in zip(got.stored, want.stored):
        assert a.kind == b.kind
        assert a.value.dtype == b.value.dtype and a.value.shape == b.value.shape
        assert a.value.tobytes() == np.asarray(b.value).tobytes()
        if a.kind == "q8":
            assert a.scale.dtype == np.float32 and a.scale.tobytes() == b.scale.tobytes()
    assert got.size_report() == want.size_report()


@pytest.mark.parametrize("case", list(CASES))
def test_dequantized_logits_match_jax(case):
    port, jax_model, _ = _pair(case, seed=2)
    x = _x(port)
    got = quantize_model(port).transform(x)
    want = jax_quantize.quantize_model(jax_model).transform(x)
    np.testing.assert_allclose(got.raw, want.raw, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.probability, want.probability, rtol=1e-5, atol=1e-5)


def test_dequantized_weights_are_the_stored_product():
    """Each torch parameter the quantized forward uses is int8 × scale of
    its flax leaf, moved to torch's layout, bit for bit."""
    port, _, _ = _pair("cnn1d", seed=3)
    q = quantize_model(port)
    from har_tpu_torch.convert import neural_params_from_flax

    want = neural_params_from_flax("cnn1d", q.dequantized_params())
    module = q.predict_fn()
    for i, (name, quantized) in enumerate(module.names):
        w = getattr(module, f"w{i}")
        got = w.float() * getattr(module, f"s{i}") if quantized else w
        assert quantized == (w.dtype == torch.int8)
        torch.testing.assert_close(got, want[name], rtol=0, atol=0)


@pytest.fixture(scope="module")
def trained():
    raw = synthetic_raw_stream(n_windows=512, seed=0)
    model = NeuralClassifier(
        "cnn1d",
        config=TrainerConfig(batch_size=64, epochs=12, learning_rate=5e-3, seed=0),
        model_kwargs={"channels": (16, 16)}, device="cpu",
    ).fit(FeatureSet(features=raw.windows, label=raw.labels.astype(np.int32)))
    return model, raw


def test_quantized_accuracy_near_float(trained):
    model, raw = trained
    q = quantize_model(model)
    y = raw.labels.astype(np.int32)
    float_acc = evaluate(y, model.transform(raw.windows).raw, 6)["accuracy"]
    q_acc = evaluate(y, q.transform(raw.windows).raw, 6)["accuracy"]
    assert float_acc >= 0.9
    assert q_acc >= float_acc - 0.01
    np.testing.assert_allclose(q.transform(raw.windows[:64]).probability,
                               model.transform(raw.windows[:64]).probability, atol=0.05)


def test_size_report_and_int8_kernels(trained):
    model, _ = trained
    q = quantize_model(model)
    assert isinstance(q, QuantizedModel)
    rep = q.size_report()
    assert rep["quantized_kernels"] == 4  # 2 convs + 2 dense
    assert rep["ratio"] < 0.35 and rep["quantized_bytes"] < rep["float_bytes"]
    assert [s.kind for s in q.stored].count("q8") == 4
    for s in q.stored:
        if s.kind == "q8":
            assert s.value.dtype == np.int8 and s.scale.dtype == np.float32
            assert s.scale.shape == (s.value.shape[-1],)
            assert np.abs(s.value).max() <= 127
    buffers = dict(q.predict_fn().named_buffers())
    assert sum(b.dtype == torch.int8 for b in buffers.values()) == 4


def test_quantized_model_serves_and_streams(trained):
    model, raw = trained
    rec = raw.windows[:6].reshape(-1, 3)
    events = StreamingClassifier(quantize_model(model), window=200, hop=200,
                                 smoothing="none").push(rec)
    live = StreamingClassifier(model, window=200, hop=200, smoothing="none").push(rec)
    assert len(events) == 6
    assert [e.raw_label for e in events] == [e.raw_label for e in live]


def test_quantizing_keeps_the_float_module(trained):
    model, raw = trained
    before = {k: v.clone() for k, v in model.inner.module.state_dict().items()}
    quantize_model(model).transform(recording(400).reshape(2, 200, 3))
    for k, v in model.inner.module.state_dict().items():
        assert torch.equal(v, before[k]), k
