"""Replay of PySpark's CrossValidator for the bit-exact LR parity lane.

The reference's CV headline (0.7145 — Main/main.py:209-222, result.txt CV
block) comes from ``pyspark.ml.tuning.CrossValidator`` — pure Python
on the client, not Scala: it appends a SQL ``rand(seed)`` column to the training
frame, carves fold f as ``f*h <= r < (f+1)*h`` (h = 1/numFolds), fits every
grid candidate per fold, accumulates ``metric / numFolds`` per candidate,
and refits the arg-best candidate on the full frame.  The evaluator it is
handed is the reference's last-assigned RegressionEvaluator — the MAE
quirk (SURVEY §2 N): selection minimizes mean |prediction - label| over
label indices.

Determinism notes:
  - ``rand(seed)`` is Catalyst's Rand: one XORShiftRandom(seed +
    partitionIndex) double per row; the captured run used one partition.
  - The default seed is ``hash('CrossValidator')`` in the *client's*
    Python.  Under Python 2 (2019-era PySpark) that is the deterministic
    value ``py2_string_hash`` computes, and the selection picks
    (0.1, 0.1) — the candidate whose full-train refit reproduces the CV
    block's 1161/1625 exactly.  Under Python 3 the seed is randomized
    per process; the same candidate wins by a wide MAE margin for most
    seeds (26/30 in a measured sweep, the rest picking (0.1, 0.2)), so
    the committed run is consistent with a py2 client or a typical py3
    seed.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from har_tpu_torch.data.spark_random import bernoulli_draws, py2_string_hash
from har_tpu_torch.models._jvm_native import CsrMatrix
from har_tpu_torch.models.mllib_lr import MLlibLRModel, fit_mllib_lr

#: The reference grid (Main/main.py:202-207): regParam × elasticNetParam.
REFERENCE_GRID: tuple[dict, ...] = tuple(
    {"reg_param": reg, "elastic_net_param": enp}
    for reg in (0.1, 0.3, 0.5)
    for enp in (0.0, 0.1, 0.2)
)


def default_cv_seed() -> int:
    """pyspark HasSeed default for CrossValidator under Python 2."""
    return py2_string_hash("CrossValidator")


@dataclasses.dataclass(frozen=True)
class MLlibCVResult:
    best_params: dict
    best_index: int
    avg_metrics: tuple[float, ...]
    model: MLlibLRModel  # refit of best_params on the full training frame


def _regression_metric(
    pred: np.ndarray, label: np.ndarray, metric: str
) -> float:
    err = label - pred
    if metric == "mae":
        return float(np.mean(np.abs(err)))
    mse = float(np.mean(err * err))
    if metric == "mse":
        return mse
    if metric == "rmse":
        return float(np.sqrt(mse))
    if metric == "r2":
        ss_tot = float(np.sum((label - label.mean()) ** 2))
        return 1.0 - float(np.sum(err * err)) / ss_tot
    raise ValueError(f"unknown metric {metric!r}")


def mllib_cross_validate(
    x_train: CsrMatrix,
    y_train: np.ndarray,
    grid: Sequence[dict] = REFERENCE_GRID,
    num_folds: int = 5,
    seed: int | None = None,
    metric: str = "mae",
    larger_is_better: bool = False,
    max_iter: int = 20,
) -> MLlibCVResult:
    """CrossValidator._fit over the bit-exact MLlib LR trainer."""
    if seed is None:
        seed = default_cv_seed()
    n = x_train.n_rows
    draws = bernoulli_draws(n, seed)
    h = 1.0 / num_folds
    metrics = [0.0] * len(grid)
    all_rows = np.arange(n)
    for fold in range(num_folds):
        lb = fold * h
        ub = (fold + 1) * h
        val_mask = (draws >= lb) & (draws < ub)
        xt = x_train.take(all_rows[~val_mask])
        xv = x_train.take(all_rows[val_mask])
        yt = y_train[~val_mask]
        yv = y_train[val_mask]
        for j, params in enumerate(grid):
            model = fit_mllib_lr(xt, yt, max_iter=max_iter, **params)
            _, _, pred = model.transform(xv)
            metrics[j] += _regression_metric(pred, yv, metric) / num_folds
    best = (
        int(np.argmax(metrics))
        if larger_is_better
        else int(np.argmin(metrics))
    )
    model = fit_mllib_lr(x_train, y_train, max_iter=max_iter, **grid[best])
    return MLlibCVResult(
        best_params=dict(grid[best]),
        best_index=best,
        avg_metrics=tuple(metrics),
        model=model,
    )
