"""Predict artifacts through torch.export (har_tpu_torch.export) against
the live models and har_tpu.export.

One artifact (symbolic batch) serves batches 1, 7 and 64 and equals the
live model: labels equal, float32 probabilities within 1e-6.  The port's
artifact and ``har_tpu.export``'s StableHLO artifact from the same
parameters agree within 1e-5 on the CPU.  The exported transformer's
graph holds K2's op (``har_tpu_torch::flash_attention_fwd``) as one node.
The int8 artifact is under 0.7x the float one and equals the live
``QuantizedModel``.  Classical checkpoints, StableHLO artifacts, TPU
platforms and loads on an unlisted device are refused with messages; a
model without a scaler needs ``example_shape``.  The CLI's ``export`` and
``evaluate`` / ``predict --artifact`` give the accuracy and CSV of
``--checkpoint``.  The BiLSTM, whose 200-step recurrence unrolls, exports
at a small T.  The fleet's async dispatch of an artifact
(``tests/test_export.py:272``) waits for the fleet engine.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import har_tpu.export as jax_export
from har_tpu_torch import checkpoint, cli
from har_tpu_torch.export import (
    ExportedPredictor,
    evaluate_artifact,
    export_checkpoint,
    export_model,
    load_exported,
)
from har_tpu_torch.quantize import quantize_model
from tests.test_torch_serving import random_pair, recording

torch.set_num_threads(1)

TIGHT = dict(rtol=1e-6, atol=1e-6)


def _windows(n, window=40, seed=1):
    return recording(n * window, seed=seed, scale=2.0).reshape(n, window, 3)


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


@pytest.mark.parametrize("name", ["cnn1d", "transformer"])
def test_one_artifact_serves_any_batch_and_equals_live(tmp_path, name):
    port, _, _ = random_pair(name, seed=1)
    pred = load_exported(export_model(port, str(tmp_path / "art")), "cpu")
    assert isinstance(pred, ExportedPredictor)
    assert pred.num_classes == 4 and pred.example_shape == (40, 3)
    assert pred.meta["platforms"] == ["cuda", "cpu"]
    for n in (1, 7, 64):
        x = _windows(n, seed=n)
        logits, probs = pred.predict(x)
        live = port.transform(x)
        np.testing.assert_allclose(logits, live.raw, **TIGHT)
        np.testing.assert_allclose(probs, live.probability, **TIGHT)
        np.testing.assert_array_equal(pred.transform(x).prediction, live.prediction)


@pytest.mark.parametrize("name", ["cnn1d", "transformer"])
def test_artifact_matches_jax_artifact(tmp_path, name):
    port, jax_model, _ = random_pair(name, seed=2)
    x = _windows(9, seed=3)
    got = load_exported(export_model(port, str(tmp_path / "port")), "cpu").predict(x)
    want = jax_export.load_exported(
        jax_export.export_model(jax_model, str(tmp_path / "jax"), platforms=("cpu",))
    ).predict(x)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_exported_transformer_holds_the_flash_op(tmp_path):
    port, _, _ = random_pair("transformer", seed=3)
    pred = load_exported(export_model(port, str(tmp_path / "art")), "cpu")
    targets = [str(n.target) for n in pred.program.graph.nodes if n.op == "call_function"]
    flash = [t for t in targets if t.startswith("har_tpu_torch.flash_attention_fwd")]
    assert len(flash) == 2  # one a layer
    assert not any("scaled_dot_product" in t or "bmm" in t for t in targets)


def test_int8_artifact_shrinks_and_equals_live_quantized(tmp_path):
    port, _, _ = random_pair("cnn1d", seed=4, kwargs=dict(channels=(128, 128)))
    fpath = export_model(port, str(tmp_path / "f32"))
    q = quantize_model(port)
    qpath = export_model(q, str(tmp_path / "int8"))
    assert _dir_bytes(qpath) < _dir_bytes(fpath) * 0.7, (_dir_bytes(fpath), _dir_bytes(qpath))
    program = torch.export.load(os.path.join(qpath, "predict.pt2"))
    assert sum(t.dtype == torch.int8 for t in program.state_dict.values()) == 4
    x = _windows(16, seed=5)
    logits, probs = load_exported(qpath, "cpu").predict(x)
    live = q.transform(x)
    np.testing.assert_allclose(logits, live.raw, **TIGHT)
    np.testing.assert_allclose(probs, live.probability, **TIGHT)
    np.testing.assert_allclose(probs, port.transform(x).probability, atol=0.05)


def test_bilstm_exports_at_small_t(tmp_path):
    port, _, _ = random_pair("bilstm", window=12, seed=5, kwargs=dict(hidden=8))
    x = _windows(5, window=12, seed=6)
    logits, probs = load_exported(export_model(port, str(tmp_path / "art")), "cpu").predict(x)
    live = port.transform(x)
    np.testing.assert_allclose(logits, live.raw, **TIGHT)
    np.testing.assert_allclose(probs, live.probability, **TIGHT)


def test_export_without_scaler_needs_shape(tmp_path):
    port, _, _ = random_pair("cnn1d", seed=6)
    bare = port.inner
    with pytest.raises(ValueError, match="example_shape"):
        export_model(bare, str(tmp_path / "art"))
    path = export_model(bare, str(tmp_path / "art2"), example_shape=(40, 3))
    logits, _ = load_exported(path, "cpu").predict(np.zeros((2, 40, 3), np.float32))
    assert logits.shape == (2, 4)


def test_shape_validation_and_platforms(tmp_path):
    port, _, _ = random_pair("cnn1d", seed=7)
    with pytest.raises(ValueError, match="har_tpu"):
        export_model(port, str(tmp_path / "tpu"), platforms=("tpu", "cpu"))
    path = export_model(port, str(tmp_path / "cuda_only"), platforms=("cuda",))
    assert json.load(open(os.path.join(path, "export_meta.json")))["platforms"] == ["cuda"]
    with pytest.raises(ValueError, match="exported for"):
        load_exported(path, "cpu")
    pred = load_exported(export_model(port, str(tmp_path / "art")), "cpu")
    with pytest.raises(ValueError, match="exported for"):
        pred.predict(np.zeros((2, 20, 3), np.float32))


def test_loading_defaults_to_cuda(tmp_path, monkeypatch):
    port, _, _ = random_pair("cnn1d", seed=7)
    path = export_model(port, str(tmp_path / "art"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        load_exported(path)


def test_classical_checkpoint_and_stablehlo_artifact_refused(tmp_path):
    from har_tpu_torch.models.logistic_regression import LogisticRegressionModel

    lr = LogisticRegressionModel(coefficients=np.zeros((3, 2), np.float32),
                                 intercept=np.zeros(2, np.float32), num_classes=2,
                                 device="cpu")
    ckpt = checkpoint.save_classical_model(str(tmp_path / "lr"), lr)
    with pytest.raises(ValueError, match="classical"):
        export_checkpoint(ckpt, str(tmp_path / "art"))
    with pytest.raises(SystemExit, match="classical"):
        cli.main(["export", "--checkpoint", ckpt, "--output", str(tmp_path / "art2")])
    _, jax_model, _ = random_pair("cnn1d", seed=8)
    stablehlo = jax_export.export_model(jax_model, str(tmp_path / "jax"), platforms=("cpu",))
    with pytest.raises(ValueError, match="StableHLO"):
        load_exported(stablehlo, "cpu")


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A float32 CNN1D at T = 200 saved with wisdm_raw provenance (160
    windows, split seed 7 at 0.8), exported float and int8 by the CLI."""
    base = tmp_path_factory.mktemp("export_cli")
    port, _, kwargs = random_pair("cnn1d", window=200, classes=6, seed=9,
                                  kwargs=dict(channels=(64, 64)))
    ckpt = checkpoint.save_model(str(base / "ckpt"), port, "cnn1d", kwargs,
                                 dataset="wisdm_raw", synthetic_rows=160,
                                 input_shape=(200, 3), split_seed=7, train_fraction=0.8)
    outs = {}
    for tag, extra in (("f32", []), ("int8", ["--quantize", "int8"])):
        art = str(base / tag)
        printed = _cli(["export", "--checkpoint", ckpt, "--output", art, *extra])
        outs[tag] = (art, printed)
    return ckpt, outs, base


def _cli(argv):
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_cli_export_meta_and_sizes(saved):
    ckpt, outs, _ = saved
    (f32, f32_out), (int8, int8_out) = outs["f32"], outs["int8"]
    assert f32_out["quantized"] is None and f32_out["bytes"] == _dir_bytes(f32)
    assert int8_out["quantized"]["quantized_kernels"] == 4
    assert int8_out["bytes"] < f32_out["bytes"]  # the 0.7 bound: the wide model above
    meta = json.load(open(os.path.join(f32, "export_meta.json")))
    for key in ("num_classes", "example_shape", "platforms", "outputs", "model_name",
                "dataset", "input_shape", "split_seed", "train_fraction", "synthetic_rows"):
        assert key in meta, key
    assert meta["example_shape"] == [200, 3] and meta["split_seed"] == 7
    assert json.load(open(os.path.join(int8, "export_meta.json")))["quantization"][
        "scheme"] == "int8_weight_only"


def test_cli_evaluate_and_predict_artifact_match_checkpoint(saved):
    ckpt, outs, base = saved
    f32, int8 = outs["f32"][0], outs["int8"][0]
    want = _cli(["evaluate", "--checkpoint", ckpt, "--device", "cpu"])
    got = _cli(["evaluate", "--artifact", f32, "--device", "cpu"])
    assert {k: got[k] for k in want} == want
    assert got["quantized"] is None and got["artifact"] == f32
    q = _cli(["evaluate", "--artifact", int8, "--device", "cpu"])
    assert q["quantized"] == "int8_weight_only" and q["n_test"] == want["n_test"]
    # the int8 artifact scores what the live quantized model scores on the
    # same partition
    from har_tpu_torch.export import _load_artifact_for_scoring
    from har_tpu_torch.ops.metrics import evaluate

    _, test = _load_artifact_for_scoring(int8, None, None, None, None, None, "cpu")
    live = quantize_model(checkpoint.load_model(ckpt, "cpu")).transform(test)
    assert q["accuracy"] == evaluate(test.label, live.raw, 6)["accuracy"]
    a = _cli(["predict", "--checkpoint", ckpt, "--device", "cpu",
              "--output", str(base / "ckpt.csv")])
    b = _cli(["predict", "--artifact", f32, "--device", "cpu",
              "--output", str(base / "art.csv")])
    assert a["n_rows"] == b["n_rows"]
    rows_a = open(base / "ckpt.csv").read().splitlines()
    rows_b = open(base / "art.csv").read().splitlines()
    assert rows_a[0] == rows_b[0]
    assert [r.split(",")[:3] for r in rows_a] == [r.split(",")[:3] for r in rows_b]
    probs_a = np.array([[float(v) for v in r.split(",")[3:]] for r in rows_a[1:]])
    probs_b = np.array([[float(v) for v in r.split(",")[3:]] for r in rows_b[1:]])
    np.testing.assert_allclose(probs_a, probs_b, rtol=1e-5, atol=1e-6)


def test_evaluate_artifact_refuses_a_contradicting_dataset(saved):
    _, outs, _ = saved
    with pytest.raises(ValueError, match="feature view"):
        evaluate_artifact(outs["f32"][0], dataset="wisdm", device="cpu")


def test_cli_export_without_shape_or_scaler_needs_example_shape(tmp_path):
    port, _, kwargs = random_pair("cnn1d", seed=10)
    bare = type(port)(port.inner, None, port.num_classes)
    ckpt = checkpoint.save_model(str(tmp_path / "ckpt"), bare, "cnn1d", kwargs)
    with pytest.raises(SystemExit, match="example_shape"):
        cli.main(["export", "--checkpoint", ckpt, "--output", str(tmp_path / "a")])
    out = _cli(["export", "--checkpoint", ckpt, "--output", str(tmp_path / "b"),
                "--example-shape", "40", "3", "--platforms", "cpu"])
    assert out["platforms"] == ["cpu"]
    assert load_exported(out["artifact"], "cpu").example_shape == (40, 3)
    with pytest.raises(SystemExit):
        cli.main(["export", "--checkpoint", ckpt, "--output", str(tmp_path / "c"),
                  "--example-shape", "40", "3", "--platforms", "tpu"])


def test_jax_devices_untouched():
    """The tests ran har_tpu only on its CPU platform."""
    assert jax.devices()[0].platform == "cpu"


def test_packed_transformer_export_is_refused(tmp_path):
    """window_pack pads the batch to whole packs; export refuses it with
    a message rather than specializing the batch."""
    port, _, _ = random_pair("transformer", seed=11, kwargs=dict(
        embed_dim=16, num_heads=2, num_layers=1, patch_size=4, window_pack=4))
    with pytest.raises(ValueError, match="window_pack"):
        export_model(port, str(tmp_path / "art"))
