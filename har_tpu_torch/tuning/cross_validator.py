"""K-fold cross-validation with grid search.

Port of ``har_tpu/tuning/cross_validator.py`` (reference
Main/main.py:202-222: 5 folds × the 9-point LR grid = 45 fits + a refit).
An estimator with a vectorized sweep (``cv_scores``: logistic
regression's lanes) scores the whole grid × fold matrix at once; any other
fits once per (grid point, fold) and is scored by the host battery.  The
folds are the JAX package's, row for row: the same numpy permutation.

Reference quirk, reproduced behind a flag: the script hands each
CrossValidator the MAE RegressionEvaluator it assigned last (SURVEY §2 N),
so it selects on MAE over *label indices*; ``selection_metric="mae"``
replicates that, and the default is accuracy.  The exact MLlib replay of
that selection is ``tuning/mllib_cv.py`` (the parity lane's LR-CV).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Mapping, Sequence

import numpy as np

from har_tpu_torch.features.wisdm_pipeline import FeatureSet
from har_tpu_torch.ops.metrics import evaluate

# metrics where lower is better
_MINIMIZE = {"mae", "mse", "rmse"}


def param_grid(**grids: Sequence[Any]) -> list[dict[str, Any]]:
    """ParamGridBuilder: cartesian product of value lists, keys sorted.

    param_grid(reg_param=[0.1, 0.3, 0.5], elastic_net_param=[0.0, 0.1, 0.2])
    is the reference's 9-point LR grid (Main/main.py:202-207).
    """
    if not grids:
        return [{}]
    keys = sorted(grids)
    return [
        dict(zip(keys, combo))
        for combo in itertools.product(*(grids[k] for k in keys))
    ]


def kfold_indices(
    n: int, num_folds: int, seed: int
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Seeded shuffle → num_folds (train_idx, val_idx) pairs."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    folds = np.array_split(perm, num_folds)
    out = []
    for i in range(num_folds):
        val = folds[i]
        train = np.concatenate([f for j, f in enumerate(folds) if j != i])
        out.append((train, val))
    return out


@dataclasses.dataclass(frozen=True)
class CrossValidator:
    estimator: Any  # fit(FeatureSet) -> model with transform and num_classes
    grid: Sequence[Mapping[str, Any]] = (({}),)
    num_folds: int = 5
    selection_metric: str = "accuracy"
    seed: int = 2018

    def fit(self, data: FeatureSet) -> "CrossValidatorModel":
        folds = kfold_indices(len(data), self.num_folds, self.seed)
        grid = list(self.grid) or [{}]
        sign = -1.0 if self.selection_metric in _MINIMIZE else 1.0

        score_matrix = (
            self.estimator.cv_scores(data, folds, grid, self.selection_metric)
            if hasattr(self.estimator, "cv_scores")
            else None
        )
        if score_matrix is not None:
            avg_metrics = [float(m) for m in score_matrix.mean(axis=1)]
        else:
            avg_metrics = []
            for params in grid:
                est = self.estimator.copy_with(**params) if params else self.estimator
                scores = []
                for train_idx, val_idx in folds:
                    model = est.fit(data.take(train_idx))
                    val = data.take(val_idx)
                    preds = model.transform(val)
                    rep = evaluate(val.label, preds.raw, model.num_classes)
                    scores.append(rep[self.selection_metric])
                avg_metrics.append(float(np.mean(scores)))

        best_i = int(np.argmax(sign * np.asarray(avg_metrics)))
        best_params = dict(grid[best_i])
        best_est = (
            self.estimator.copy_with(**best_params) if best_params else self.estimator
        )
        best_model = best_est.fit(data)  # refit on the whole training set
        return CrossValidatorModel(
            best_model=best_model,
            best_params=best_params,
            avg_metrics=avg_metrics,
            grid=[dict(g) for g in grid],
            selection_metric=self.selection_metric,
        )


@dataclasses.dataclass(frozen=True)
class CrossValidatorModel:
    best_model: Any
    best_params: dict[str, Any]
    avg_metrics: list[float]
    grid: list[dict[str, Any]]
    selection_metric: str

    @property
    def num_classes(self) -> int:
        return self.best_model.num_classes

    def transform(self, data) -> Any:
        return self.best_model.transform(data)
