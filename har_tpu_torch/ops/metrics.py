"""Evaluation metrics: the host battery that scores every model, and the
device battery.

:func:`evaluate` (float64, host) computes the reference's whole battery in
one pass (reference Main/main.py:132-195): confusion matrix, accuracy,
weighted precision/recall/F1, areaUnderROC / areaUnderPR, rmse/mse/r2/mae
on class indices, and correct/wrong counts.  It is a copy of the host path
of har_tpu/ops/metrics.py::evaluate, and the report and CSVs read it.

:func:`classification_report` and its parts are the same battery as plain
torch functions on device tensors (float32), the counterpart of
har_tpu/ops/metrics.py's jitted battery: an optional boolean mask drops
padded rows, and leading dimensions batch (one battery per fold or grid
point in one call).  No default path calls them yet.

Formulas follow MLlib's MulticlassMetrics / BinaryClassificationMetrics /
RegressionMetrics:
  - weighted P/R/F1 weight per-class scores by true-class frequency;
    per-class precision with an empty predicted-class is 0.
  - areaUnderROC / areaUnderPR via the score-sorted cumulative curve
    (trapezoidal ROC; PR with the (0, p1) anchor point MLlib uses).
  - regression metrics treat (label, prediction) as real numbers — the
    reference applies them to class indices, which we reproduce.
"""

from __future__ import annotations

import numpy as np
import torch

from har_tpu_torch.data.spark_random import scala_int_trie_order


def _weights(like: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if mask is None:
        return torch.ones(like.shape, dtype=torch.float32, device=like.device)
    return mask.to(torch.float32)


def confusion_matrix(
    labels: torch.Tensor,
    predictions: torch.Tensor,
    num_classes: int,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """(..., num_classes, num_classes) float32 counts, rows = true class;
    ``labels``, ``predictions`` and ``mask`` are (..., n)."""
    flat = labels.long() * num_classes + predictions.long()
    counts = torch.zeros(
        (*labels.shape[:-1], num_classes * num_classes),
        dtype=torch.float32, device=labels.device,
    )
    counts.scatter_add_(-1, flat, _weights(labels, mask))
    return counts.reshape(*labels.shape[:-1], num_classes, num_classes)


def multiclass_metrics(cm: torch.Tensor) -> dict[str, torch.Tensor]:
    """Accuracy, weighted precision/recall/F1, per-class scores and counts
    from (..., C, C) confusion matrices."""
    total = cm.sum((-2, -1))
    tp = torch.diagonal(cm, dim1=-2, dim2=-1)
    actual = cm.sum(-1)  # per true class
    predicted = cm.sum(-2)  # per predicted class
    zero = torch.zeros((), dtype=cm.dtype, device=cm.device)
    precision = torch.where(predicted > 0, tp / predicted.clamp(min=1), zero)
    recall = torch.where(actual > 0, tp / actual.clamp(min=1), zero)
    f1 = torch.where(
        precision + recall > 0,
        2 * precision * recall / (precision + recall).clamp(min=1e-30),
        zero,
    )
    weights = actual / total.clamp(min=1).unsqueeze(-1)
    correct = tp.sum(-1)
    return {
        "accuracy": correct / total.clamp(min=1),
        "weightedPrecision": (weights * precision).sum(-1),
        "weightedRecall": (weights * recall).sum(-1),
        "f1": (weights * f1).sum(-1),
        "precision_per_class": precision,
        "recall_per_class": recall,
        "f1_per_class": f1,
        "count_total": total,
        "count_correct": correct,
        "count_wrong": total - correct,
    }


def binary_metrics(
    scores: torch.Tensor,
    positive: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """areaUnderROC and areaUnderPR from (..., n) raw scores.

    ``positive`` is a {0,1} indicator of the positive class.  Sorting the
    scores descending (stable: tied rows keep their order) and
    accumulating TP/FP reproduces MLlib's threshold sweep; ties are
    handled by trapezoids over cumulative counts.
    """
    w = _weights(scores, mask).to(scores.dtype)
    pos = positive.to(scores.dtype) * w
    order = torch.argsort(-scores, dim=-1, stable=True)
    pos_sorted = pos.gather(-1, order)
    w_sorted = w.gather(-1, order)
    tp = pos_sorted.cumsum(-1)
    fp = (w_sorted - pos_sorted).cumsum(-1)
    p = tp[..., -1:].clamp(min=1e-30)
    n = fp[..., -1:].clamp(min=1e-30)
    origin = torch.zeros_like(tp[..., :1])
    tpr = torch.cat([origin, tp / p], -1)
    fpr = torch.cat([origin, fp / n], -1)
    # PR curve: precision at each cut, anchored at recall 0 with the first
    # point's precision (MLlib's (0, p1) anchor)
    prec = tp / (tp + fp).clamp(min=1e-30)
    rec = tp / p
    return {
        "areaUnderROC": torch.trapezoid(tpr, fpr, dim=-1),
        "areaUnderPR": torch.trapezoid(
            torch.cat([prec[..., :1], prec], -1), torch.cat([origin, rec], -1),
            dim=-1,
        ),
    }


def regression_metrics(
    labels: torch.Tensor,
    predictions: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """mse, rmse, mae and r2 of (..., n) predictions as real numbers."""
    w = _weights(labels, mask)
    n = w.sum(-1).clamp(min=1)
    y = labels.to(torch.float32)
    err = (y - predictions.to(torch.float32)) * w
    mse = (err**2).sum(-1) / n
    mean_y = (y * w).sum(-1) / n
    ss_tot = ((y - mean_y.unsqueeze(-1)) ** 2 * w).sum(-1)
    return {
        "mse": mse,
        "rmse": mse.sqrt(),
        "mae": err.abs().sum(-1) / n,
        "r2": 1.0 - (err**2).sum(-1) / ss_tot.clamp(min=1e-30),
    }


def classification_report(
    labels: torch.Tensor,
    raw_scores: torch.Tensor,
    num_classes: int,
    positive_class: int = 1,
    mask: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """The full battery on the tensors' device.

    Args:
      labels: (..., n) integer class labels.
      raw_scores: (..., n, num_classes) raw scores; argmax (the first
        maximum) is the prediction.
      positive_class: the class the binary AUC metrics treat as positive
        (the reference's BinaryClassificationEvaluator reads score
        index 1).
      mask: optional (..., n) booleans; False rows count nowhere.
    """
    predictions = raw_scores.argmax(-1)
    cm = confusion_matrix(labels, predictions, num_classes, mask)
    out: dict[str, torch.Tensor] = {"confusion_matrix": cm}
    out.update(multiclass_metrics(cm))
    out.update(
        binary_metrics(
            raw_scores[..., positive_class],
            (labels == positive_class).to(torch.float32),
            mask,
        )
    )
    out.update(regression_metrics(labels, predictions, mask))
    return out


def evaluate(labels, raw_scores, num_classes, positive_class=1) -> dict[str, float]:
    """Host evaluation battery in float64 — the report/CSV path.

    Computes in double precision from exact integer counts, so the emitted
    values
    equal MLlib's to the last digit (the reference CSVs carry full f64
    reprs).  The binary block reproduces MLlib's
    BinaryClassificationEvaluator semantics on multiclass data exactly
    (reference Main/main.py:135-143 applies it to 6-class labels):
    score = rawPrediction[1], positive = label > 0.5 (every non-class-0
    row!), and ROC/PR curves over DISTINCT thresholds — tie groups form
    one curve point, which changes areaUnderPR vs per-row accumulation.
    """
    # numpy<2 has no np.trapezoid (ADVICE r2: unbounded numpy dep)
    _trapezoid = getattr(np, "trapezoid", None) or np.trapz
    y = np.asarray(labels).astype(np.int64)
    raw = np.asarray(raw_scores, np.float64)
    pred = raw.argmax(-1)
    n = len(y)
    cm = np.zeros((num_classes, num_classes), np.float64)
    np.add.at(cm, (y, pred), 1.0)

    total = cm.sum()
    tp = np.diagonal(cm)
    actual = cm.sum(axis=1)
    predicted = cm.sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(predicted > 0, tp / np.maximum(predicted, 1), 0.0)
        recall = np.where(actual > 0, tp / np.maximum(actual, 1), 0.0)
        f1 = np.where(
            precision + recall > 0,
            2 * precision * recall / np.maximum(precision + recall, 1e-300),
            0.0,
        )
    correct = float(tp.sum())
    # MulticlassMetrics' weighted aggregates fold ``metric(c) * count(c)
    # / labelCount`` over labelCountByClass — a scala immutable HashMap
    # iterated in hash-trie order — so the CSVs' full-f64 reprs only
    # match MLlib with the same per-term arithmetic and the same
    # accumulation order (numpy's pairwise sum differs in the last ulp).
    label_count = max(total, 1.0)
    w_precision = 0.0
    w_recall = 0.0
    w_f1 = 0.0
    for c in scala_int_trie_order(range(num_classes)):
        cnt = float(actual[c])
        w_precision += float(precision[c]) * cnt / label_count
        w_recall += float(recall[c]) * cnt / label_count
        w_f1 += float(f1[c]) * cnt / label_count

    # --- MLlib binary evaluator (distinct-threshold curves) -------------
    scores = raw[:, positive_class]
    pos = (y > 0.5).astype(np.float64)
    order = np.argsort(-scores, kind="stable")
    s_sorted, p_sorted = scores[order], pos[order]
    # last index of each distinct score = one curve point per threshold
    if n:
        last = np.nonzero(np.diff(s_sorted) != 0)[0]
        bounds = np.concatenate([last, [n - 1]])
        tp_c = np.cumsum(p_sorted)[bounds]
        fp_c = (np.arange(1, n + 1, dtype=np.float64) - np.cumsum(p_sorted))[
            bounds
        ]
        p_tot = max(pos.sum(), 1e-300)
        n_tot = max(n - pos.sum(), 1e-300)
        tpr = np.concatenate([[0.0], tp_c / p_tot])
        fpr = np.concatenate([[0.0], fp_c / n_tot])
        auroc = float(_trapezoid(tpr, fpr))
        prec_c = tp_c / np.maximum(tp_c + fp_c, 1e-300)
        rec_c = tp_c / p_tot
        aupr = float(
            _trapezoid(
                np.concatenate([prec_c[:1], prec_c]),
                np.concatenate([[0.0], rec_c]),
            )
        )
    else:  # pragma: no cover - empty input
        auroc = aupr = 0.0

    # --- regression over class indices (reference applies it so) --------
    yf, pf = y.astype(np.float64), pred.astype(np.float64)
    err = yf - pf
    mse = float((err**2).mean()) if n else 0.0
    mae = float(np.abs(err).mean()) if n else 0.0
    ss_tot = float(((yf - yf.mean()) ** 2).sum()) if n else 0.0
    r2 = 1.0 - float((err**2).sum()) / max(ss_tot, 1e-300)

    return {
        "confusion_matrix": cm.tolist(),
        "accuracy": correct / max(total, 1.0),
        "weightedPrecision": w_precision,
        "weightedRecall": w_recall,
        "f1": w_f1,
        "precision_per_class": precision.tolist(),
        "recall_per_class": recall.tolist(),
        "f1_per_class": f1.tolist(),
        "count_total": float(total),
        "count_correct": correct,
        "count_wrong": float(total) - correct,
        "areaUnderROC": auroc,
        "areaUnderPR": aupr,
        "mse": mse,
        "rmse": float(np.sqrt(mse)),
        "mae": mae,
        "r2": r2,
    }
