"""Confidence calibration (har_tpu_torch.ops.calibration) against
har_tpu.ops.calibration.

ECE within 1e-6 of the JAX package's on the same probabilities;
``fit_temperature`` (the same golden-section search, its NLL in torch
float32 on the CPU where the JAX package uses optax) recovers a known
temperature as the JAX test asserts and lands within 1e-3 (relative) of
the JAX package's T on the same logits; ``calibrate`` keeps the
predictions and refuses vote-probability models; a calibrated model
exports with T baked into the artifact's softmax.
"""

import numpy as np
import pytest
import torch

import har_tpu.ops.calibration as jax_calibration
from har_tpu_torch.models.base import Predictions
from har_tpu_torch.ops.calibration import (
    TemperatureScaledModel,
    calibrate,
    expected_calibration_error,
    fit_temperature,
)
from tests.test_torch_serving import random_pair, recording

torch.set_num_threads(1)


def _synthetic_calibrated(n=20_000, classes=4, seed=0):
    """Labels drawn FROM the predicted distribution → calibrated."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n, classes)) * 1.5
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs = e / e.sum(axis=1, keepdims=True)
    labels = (probs.cumsum(axis=1) < rng.random((n, 1))).sum(axis=1).astype(np.int32)
    return logits.astype(np.float32), probs, labels


@pytest.fixture(scope="module")
def calibrated():
    return _synthetic_calibrated()


def test_ece_near_zero_when_calibrated_and_equal_to_jax(calibrated):
    _, probs, labels = calibrated
    report = expected_calibration_error(probs, labels)
    assert report["ece"] < 0.02
    assert report["bin_count"].sum() == len(labels)
    want = jax_calibration.expected_calibration_error(probs, labels)
    assert abs(report["ece"] - want["ece"]) <= 1e-6
    for key in ("bin_confidence", "bin_accuracy", "bin_count"):
        np.testing.assert_allclose(report[key], want[key], rtol=0, atol=1e-6)


def test_ece_large_when_overconfident(calibrated):
    logits, _, labels = calibrated
    sharp = np.exp(logits * 4.0)
    sharp /= sharp.sum(axis=1, keepdims=True)
    got = expected_calibration_error(sharp, labels)["ece"]
    assert got > 0.15
    assert abs(got - jax_calibration.expected_calibration_error(sharp, labels)["ece"]) <= 1e-6


@pytest.mark.parametrize("sharpen,band", [(4.0, (3.3, 4.8)), (1.0, (0.8, 1.25))])
def test_fit_temperature_recovers_ground_truth_and_matches_jax(calibrated, sharpen, band):
    logits, _, labels = calibrated
    t = fit_temperature(logits * sharpen, labels)
    assert band[0] < t < band[1], t
    want = jax_calibration.fit_temperature(logits * sharpen, labels)
    assert abs(t - want) <= 1e-3 * want, (t, want)


def test_fit_temperature_small_input_equals_jax():
    """On a small input the two NLLs never tie within an ulp at a
    comparison, so every golden-section branch agrees: T is equal."""
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(64, 3)) * 3).astype(np.float32)
    labels = rng.integers(0, 3, 64).astype(np.int32)
    assert fit_temperature(logits, labels) == jax_calibration.fit_temperature(logits, labels)


class _OverconfidentModel:
    num_classes = 4

    def __init__(self, logits):
        self.logits = logits

    def transform(self, data):
        e = np.exp(self.logits - self.logits.max(axis=1, keepdims=True))
        return Predictions.from_raw(self.logits, e / e.sum(axis=1, keepdims=True))


class _Set:
    def __init__(self, labels):
        self.features = np.zeros((len(labels), 1), np.float32)
        self.label = labels


def test_calibrate_improves_ece_and_keeps_predictions():
    logits, _, labels = _synthetic_calibrated(n=8000)
    data = _Set(labels)
    model = _OverconfidentModel((logits * 5.0).astype(np.float32))
    scaled, report = calibrate(model, data)
    assert report["ece_after"] < report["ece_before"] - 0.1
    assert report["temperature"] > 3.0
    np.testing.assert_array_equal(scaled.transform(data).prediction,
                                  model.transform(data).prediction)
    assert isinstance(scaled, TemperatureScaledModel) and scaled.num_classes == 4
    _, want = jax_calibration.calibrate(model, data)
    assert report["ece_before"] == want["ece_before"]
    assert abs(report["temperature"] - want["temperature"]) <= 1e-3 * want["temperature"]
    assert abs(report["ece_after"] - want["ece_after"]) <= 1e-3


def test_calibrate_rejects_vote_probability_models():
    _, probs, labels = _synthetic_calibrated(n=500)

    class _Votes:
        num_classes = 4

        def transform(self, data):
            return Predictions.from_raw(probs, probs)

    with pytest.raises(ValueError, match="votes"):
        calibrate(_Votes(), _Set(labels))


def test_calibrated_model_exports(tmp_path):
    """T bakes into the artifact's softmax; logits stay raw."""
    from har_tpu_torch.export import export_model, load_exported

    port, _, _ = random_pair("cnn1d", seed=4)
    scaled = TemperatureScaledModel(port, 2.5)
    x = recording(8 * 40, seed=2, scale=2.0).reshape(8, 40, 3)
    pred = load_exported(export_model(scaled, str(tmp_path / "art")), "cpu")
    logits, probs = pred.predict(x)
    live = scaled.transform(x)
    np.testing.assert_allclose(logits, live.raw, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(probs, live.probability, rtol=1e-6, atol=1e-6)
    assert not np.allclose(probs, port.transform(x).probability, atol=1e-3)


def test_calibrated_model_streams():
    from har_tpu_torch.serving import StreamingClassifier

    port, _, _ = random_pair("cnn1d", seed=5)
    rec = recording(160, seed=3)
    held = _Set(np.random.default_rng(0).integers(0, 4, 4).astype(np.int32))
    held.features = rec.reshape(4, 40, 3)
    scaled, report = calibrate(port, held)
    assert report["ece_after"] <= report["ece_before"] + 1e-6
    events = StreamingClassifier(scaled, window=40, hop=40, smoothing="none").push(rec)
    assert len(events) == 4
    assert all(abs(e.probability.sum() - 1.0) < 1e-5 for e in events)
