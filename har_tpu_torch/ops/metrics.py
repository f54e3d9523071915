"""The host evaluation battery (float64) that scores every model.

Computes the reference's whole battery in one pass (reference
Main/main.py:132-195): confusion matrix, accuracy, weighted
precision/recall/F1, areaUnderROC / areaUnderPR, rmse/mse/r2/mae on class
indices, and correct/wrong counts.  A copy of the host path of
har_tpu/ops/metrics.py::evaluate; the jitted device battery there serves
only the CV sweep, which is not ported yet.

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

from har_tpu_torch.data.spark_random import scala_int_trie_order


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
