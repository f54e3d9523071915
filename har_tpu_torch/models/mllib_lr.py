"""Bit-exact replay of MLlib's LogisticRegression training (Spark 2.3).

The reference fits ``LogisticRegression(maxIter=20, regParam=0.3,
elasticNetParam=0)`` (Main/main.py:115) and its published numbers — LR
accuracy 0.6148, the CV headline 0.7145 — are the 20th Breeze iterate of
MLlib's standardized multinomial objective, not an optimum.  This module
reproduces that trajectory exactly:

  1. ``MultivariateOnlineSummarizer`` / ``MultiClassSummarizer``: Welford
     feature statistics and label histogram, folded over the train rows in
     partition order (the captured run used one partition — established by
     the round-2 split replay).
  2. Intercept initialization at the smoothed log class priors
     (log(count+1), mean-centered).
  3. The cost function: ``LogisticAggregator`` (multinomial, standardized,
     guarded divisions) + ``L2Regularization`` on the coefficient entries,
     evaluated sequentially in C++ with fdlibm (JDK StrictMath) exp/log —
     see csrc/mllibmath.cpp.
  4. ``breeze.optimize.LBFGS`` (elasticNet == 0) or ``OWLQN`` (> 0) with
     m=10 and MLlib's convergence checks — har_tpu_torch.models.breeze_optimize.
  5. Back-transformation ``coef / featuresStd`` and the model's
     gemv + pivoted-softmax transform (native ``lr_predict``).

The device fast lane lives in har_tpu_torch.models.logistic_regression;
this is the parity lane that makes the LR/LR-CV report blocks reproducible
byte-for-byte.  It runs on the host, in numpy and C++, as the JAX package's
does: a torch reduction would change the order of the double-precision
operations the trajectory depends on.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from har_tpu_torch.models import _jvm_native
from har_tpu_torch.models._jvm_native import CsrMatrix
from har_tpu_torch.models.breeze_optimize import LBFGS, OWLQN


def prepare_design(table) -> tuple[CsrMatrix, "AssembledRows"]:
    """Assemble the MLlib pipeline's sparse design matrix for a Table.

    Returns (full-table CSR in float64, AssembledRows with labels/uids);
    split paths index into it with spark_split_indices row ids.
    """
    from har_tpu_torch.data.spark_split import assemble_rows

    rows = assemble_rows(table)
    return CsrMatrix.from_rows(rows.sparse, rows.num_features), rows


def summarizer_statistics(
    x: CsrMatrix, labels: np.ndarray, num_classes: int
) -> tuple[np.ndarray, np.ndarray]:
    """(featuresStd, label histogram) via MultivariateOnlineSummarizer /
    MultiClassSummarizer semantics: per-active Welford updates in row
    order, sample variance with the nnz mean-correction term.
    """
    d = x.n_cols
    curr_mean = np.zeros(d)
    curr_m2n = np.zeros(d)
    weight_sum = np.zeros(d)  # per-feature nnz weight
    total_weight = 0.0
    weight_square = 0.0
    indices, values, indptr = x.indices, x.values, x.indptr
    for row in range(x.n_rows):
        for p in range(int(indptr[row]), int(indptr[row + 1])):
            value = float(values[p])
            if value != 0.0:
                idx = int(indices[p])
                prev_mean = curr_mean[idx]
                diff = value - prev_mean
                # weight * diff / (weightSum + weight), weight = 1.0
                new_mean = prev_mean + 1.0 * diff / (weight_sum[idx] + 1.0)
                curr_mean[idx] = new_mean
                curr_m2n[idx] += 1.0 * (value - new_mean) * diff
                weight_sum[idx] += 1.0
        total_weight += 1.0
        weight_square += 1.0 * 1.0

    variance = np.zeros(d)
    denominator = total_weight - (weight_square / total_weight)
    if denominator > 0.0:
        for i in range(d):
            variance[i] = max(
                (
                    curr_m2n[i]
                    + curr_mean[i]
                    * curr_mean[i]
                    * weight_sum[i]
                    * (total_weight - weight_sum[i])
                    / total_weight
                )
                / denominator,
                0.0,
            )
    std = np.sqrt(variance)

    histogram = np.zeros(num_classes)
    for lab in labels:
        histogram[int(lab)] += 1.0
    return std, histogram


@dataclasses.dataclass(frozen=True)
class MLlibLRModel:
    """Original-space model, transform semantics per
    ProbabilisticClassificationModel (raw margins via gemv, pivoted
    softmax, prediction = probability argmax)."""

    coefficient_matrix: np.ndarray  # (k, d) row-major
    intercepts: np.ndarray  # (k,)
    objective_history: tuple[float, ...]

    def transform(self, x: CsrMatrix):
        raw, prob = _jvm_native.lr_predict(
            self.coefficient_matrix, self.intercepts, x
        )
        prediction = np.argmax(prob, axis=1).astype(np.float64)
        return raw, prob, prediction


def fit_mllib_lr(
    x: CsrMatrix,
    labels: np.ndarray,
    num_classes: int = 6,
    max_iter: int = 20,
    reg_param: float = 0.3,
    elastic_net_param: float = 0.0,
    fit_intercept: bool = True,
    tol: float = 1e-6,
) -> MLlibLRModel:
    """LogisticRegression.train (multinomial, standardization=true)."""
    d = x.n_cols
    k = num_classes
    labels = np.ascontiguousarray(labels, np.float64)
    feat_std, histogram = summarizer_statistics(x, labels, k)

    if not 1 <= k <= 64:
        raise ValueError(f"num_classes={k} outside the native kernel's 1..64")
    reg_l1 = elastic_net_param * reg_param
    reg_l2 = (1.0 - elastic_net_param) * reg_param

    size = k * d + (k if fit_intercept else 0)

    # Breeze wraps the MLlib cost in a CachedDiffFunction: the line
    # search's last evaluation IS the accepted iterate, so the state
    # update re-requests the identical x.  Caching the last (x, value,
    # grad) halves the native passes without touching the trajectory.
    last: list = [None, None, None]

    def cost(coef: np.ndarray):
        coef = np.ascontiguousarray(coef)
        if last[0] is not None and np.array_equal(last[0], coef):
            return last[1], last[2]
        grad = np.empty(size)
        loss = _jvm_native.lr_loss_grad(
            coef, x, labels, feat_std, k, fit_intercept, reg_l2, grad
        )
        last[0], last[1], last[2] = coef.copy(), loss, grad
        return loss, grad

    init = np.zeros(size)
    if fit_intercept:
        # rawIntercepts = histogram.map(c => math.log(c + 1)); mean-centered
        raw = [_jvm_native.jvm_log(c + 1) for c in histogram.tolist()]
        raw_sum = 0.0
        for v in raw:
            raw_sum += v
        raw_mean = raw_sum / len(raw)
        for i in range(k):
            init[k * d + i] = raw[i] - raw_mean

    if elastic_net_param == 0.0 or reg_param == 0.0:
        optimizer = LBFGS(max_iter=max_iter, m=10, tolerance=tol)
    else:
        l1 = np.zeros(size)
        l1[: k * d] = reg_l1  # intercepts unpenalized
        optimizer = OWLQN(max_iter=max_iter, m=10, l1reg=l1, tolerance=tol)

    history: list[float] = []
    state = None
    for state in optimizer.iterations(cost, init):
        history.append(state.adjusted_value)
    raw_coef = state.x

    coef_matrix = np.zeros((k, d))
    for j in range(d):
        sj = feat_std[j]
        if sj != 0.0:
            for c in range(k):
                coef_matrix[c, j] = raw_coef[j * k + c] / sj
    if fit_intercept:
        intercepts = raw_coef[k * d :].copy()
        # "The intercepts are never regularized, so we always center the
        # mean" — Spark 2.3 LogisticRegression.train mean-centers the
        # multinomial intercept vector in the final model.  Softmax is
        # shift-invariant, so predictions are unchanged, but rawPrediction
        # and the probability bits match the reference only with this.
        intercept_sum = 0.0
        for v in intercepts.tolist():
            intercept_sum += v
        intercept_mean = intercept_sum / len(intercepts)
        for i in range(k):
            intercepts[i] -= intercept_mean
    else:
        intercepts = np.zeros(k)
    return MLlibLRModel(
        coefficient_matrix=coef_matrix,
        intercepts=intercepts,
        objective_history=tuple(history),
    )
