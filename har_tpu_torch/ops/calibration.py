"""Confidence calibration: ECE measurement + temperature scaling.

Port of ``har_tpu/ops/calibration.py``.  The reference reports
accuracy-style metrics only (`Main/main.py:132-195` — no notion of whether
predicted probabilities mean anything).  A deployed recognizer's
probabilities DRIVE decisions (the serving path smooths them; a monitoring
UI thresholds them), and neural nets are routinely overconfident — so the
framework ships the standard remedy:

  ``expected_calibration_error``  — binned |confidence − accuracy| gap,
    the number that says whether "0.9" means 90% (numpy, copied).
  ``fit_temperature``  — the single post-hoc scalar T that minimizes
    validation NLL of ``logits / T`` (Guo et al.'s temperature scaling:
    cannot change argmax, so accuracy is untouched while calibration
    improves).  The same golden-section search over log T as the JAX
    package's; the NLL is optax's ``softmax_cross_entropy_with_integer_
    labels`` written out in torch float32 on the CPU.
  ``TemperatureScaledModel``  — ClassifierModel wrapper applying T
    inside the probability computation, so a calibrated model drops
    into evaluation, serving, or export (T baked into the artifact's
    softmax) unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def expected_calibration_error(
    probability: np.ndarray, labels: np.ndarray, bins: int = 15
) -> dict:
    """Standard top-label ECE with equal-width confidence bins.

    Returns {"ece", "bin_confidence", "bin_accuracy", "bin_count"} so a
    report can render the reliability diagram, not just the scalar.
    """
    probability = np.asarray(probability, np.float64)
    labels = np.asarray(labels)
    conf = probability.max(axis=-1)
    correct = (probability.argmax(axis=-1) == labels).astype(np.float64)
    # right-inclusive bins over (0, 1]; confidence is >= 1/C > 0
    edges = np.linspace(0.0, 1.0, bins + 1)
    idx = np.clip(np.digitize(conf, edges[1:-1], right=True), 0, bins - 1)
    count = np.bincount(idx, minlength=bins).astype(np.float64)
    conf_sum = np.bincount(idx, weights=conf, minlength=bins)
    acc_sum = np.bincount(idx, weights=correct, minlength=bins)
    nonzero = count > 0
    bin_conf = np.where(nonzero, conf_sum / np.maximum(count, 1), 0.0)
    bin_acc = np.where(nonzero, acc_sum / np.maximum(count, 1), 0.0)
    ece = float(
        (count / count.sum() * np.abs(bin_conf - bin_acc)).sum()
    )
    return {
        "ece": ece,
        "bin_confidence": bin_conf,
        "bin_accuracy": bin_acc,
        "bin_count": count.astype(np.int64),
    }


def fit_temperature(
    logits: np.ndarray,
    labels: np.ndarray,
    *,
    bounds: tuple[float, float] = (0.05, 20.0),
    tol: float = 1e-4,
) -> float:
    """The T minimizing mean NLL of ``softmax(logits / T)`` on held-out
    data.  NLL(T) is smooth and unimodal in log T for this 1-D family,
    so golden-section search over log-space converges without gradients
    or state."""
    logits = torch.as_tensor(np.asarray(logits, np.float32))
    labels = torch.as_tensor(np.asarray(labels, np.int64))

    def nll(log_t: float) -> float:
        # log T enters as a float32 scalar, as the JAX package's jitted
        # NLL takes it
        scaled = logits / torch.exp(torch.tensor(log_t, dtype=torch.float32))
        shifted = scaled - scaled.max(dim=-1, keepdim=True).values
        label_logits = shifted.gather(-1, labels[:, None])[:, 0]
        log_norm = torch.log(torch.exp(shifted).sum(dim=-1))
        return float((log_norm - label_logits).mean())

    lo, hi = (float(np.log(b)) for b in bounds)
    inv_phi = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = lo, hi
    c = b - inv_phi * (b - a)
    d = a + inv_phi * (b - a)
    fc, fd = nll(c), nll(d)
    while (b - a) > tol:
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - inv_phi * (b - a)
            fc = nll(c)
        else:
            a, c, fc = c, d, fd
            d = a + inv_phi * (b - a)
            fd = nll(d)
    return float(np.exp((a + b) / 2.0))


@dataclasses.dataclass
class TemperatureScaledModel:
    """ClassifierModel wrapper: probabilities from ``logits / T``.

    Argmax is invariant under positive scaling, so predictions (and
    accuracy) equal the base model's; only the confidence changes.
    Exportable (``har_tpu_torch.export``) when the base is a neural
    model: the temperature bakes into the artifact's softmax.
    """

    model: object
    temperature: float

    @property
    def num_classes(self) -> int:
        return self.model.num_classes

    @property
    def scaler(self):
        # surfaced so export_model derives example_shape as it would
        # from the base model
        return getattr(self.model, "scaler", None)

    def transform(self, data):
        preds = self.model.transform(data)
        return _rescaled(preds, self.temperature)

    def predict_fn(self):
        """The export hook: a module x → (logits, calibrated probs).  The
        base must be a neural model; T bakes in as a constant so the
        artifact ships calibrated."""
        from har_tpu_torch.export import PredictCore

        inner = getattr(self.model, "inner", self.model)
        return PredictCore(inner.module, self.scaler, float(self.temperature))


def _rescaled(preds, temperature: float):
    """Predictions with probabilities recomputed from raw/T — reuses
    the forward pass the caller already paid for."""
    from har_tpu_torch.models.base import Predictions

    scaled = torch.from_numpy(np.asarray(preds.raw, np.float32) / temperature)
    probs = torch.softmax(scaled, dim=-1).numpy()
    return Predictions.from_raw(preds.raw, probs)


def calibrate(model, data, *, bins: int = 15):
    """(TemperatureScaledModel, report) from held-out examples.

    The report carries before/after ECE and the fitted T so callers can
    log the improvement; fitting and measuring on the same held-out set
    is the standard protocol (T is a single scalar — overfit-proof).
    """
    preds = model.transform(data)
    raw = np.asarray(preds.raw, np.float64)
    if raw.size and raw.min() >= -1e-6 and np.allclose(
        raw.sum(axis=-1), 1.0, atol=1e-3
    ):
        # forests/ensembles put vote FRACTIONS in raw
        # (Predictions.from_raw(probs, probs)); softmax(probs/T) over
        # [0,1] values would silently flatten every confidence instead
        # of calibrating it
        raise ValueError(
            "model's raw scores are probabilities (votes), not logits — "
            "temperature scaling applies to logit-producing models "
            "(neural families, logistic regression)"
        )
    labels = np.asarray(
        data.label if hasattr(data, "label") else data[1]
    )
    before = expected_calibration_error(
        preds.probability, labels, bins=bins
    )
    t = fit_temperature(preds.raw, labels)
    scaled = TemperatureScaledModel(model, t)
    # after-ECE from the SAME forward pass: probabilities are a pure
    # function of the logits already in hand
    after = expected_calibration_error(
        _rescaled(preds, t).probability, labels, bins=bins
    )
    return scaled, {
        "temperature": round(t, 4),
        "ece_before": round(before["ece"], 4),
        "ece_after": round(after["ece"], 4),
    }
