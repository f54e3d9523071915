"""The port's CrossValidator against the JAX package's.

Folds and grids are bit for bit the JAX package's.  The LR sweep (its
fast path: every (reg, fold) fit of an elastic_net_param group as one
batch of lanes) and its generic fit-per-cell path (class-weighted rows)
give the same ``best_params``, and ``avg_metrics`` within one validation
row per fold: a float32 fit may put one borderline row on the other side
(tests/test_torch_logistic_regression.py states the fit's tolerances).
The decision tree's CV is exact: its trees are the JAX package's bit for
bit.  Each JAX sweep compiles once per elastic_net_param group.
"""

import numpy as np
import pytest
import torch

from har_tpu.features.wisdm_pipeline import FeatureSet as JaxFeatureSet
from har_tpu.models.logistic_regression import LogisticRegression as JaxLR
from har_tpu.models.tree import DecisionTreeClassifier as JaxDT
from har_tpu.tuning import cross_validator as jax_cv
from har_tpu_torch.config import DataConfig, RunConfig
from har_tpu_torch.features.wisdm_pipeline import FeatureSet
from har_tpu_torch.models.logistic_regression import LogisticRegression
from har_tpu_torch.models.tree import DecisionTreeClassifier
from har_tpu_torch.runner import REFERENCE_GRIDS, featurize, load_dataset
from har_tpu_torch.tuning import cross_validator as port_cv

torch.set_num_threads(1)

FULL_GRID = REFERENCE_GRIDS["logistic_regression"]
# the MAE sweep and the class-weighted path at fewer grid points
MAE_GRID = dict(reg_param=[0.1, 0.3, 0.5])
SMALL_GRID = dict(reg_param=[0.1, 0.5], elastic_net_param=[0.0, 0.1])


def noisy_table(n=300, d=40, classes=6, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n).astype(np.int32)
    x = rng.normal(0.0, 1.0, (classes, d))[y] + rng.normal(0.0, 3.0, (n, d))
    x[:, :5] = rng.random((n, 5)) < 0.1
    return x.astype(np.float32), y


X, Y = noisy_table()
LR_CASES = {
    "accuracy": (FULL_GRID, "accuracy", {}),
    "mae": (MAE_GRID, "mae", {}),
    "balanced": (SMALL_GRID, "accuracy", {"class_weight": "balanced"}),
}


@pytest.fixture(scope="module")
def jax_lr_cvs():
    """Each JAX CrossValidator once, with its score matrix."""
    out = {}
    for name, (grid, metric, kw) in LR_CASES.items():
        cv = jax_cv.CrossValidator(
            JaxLR(**kw), jax_cv.param_grid(**grid), selection_metric=metric
        )
        model = cv.fit(JaxFeatureSet(X, Y))
        folds = jax_cv.kfold_indices(len(Y), 5, 2018)
        scores = JaxLR(**kw).cv_scores(
            JaxFeatureSet(X, Y), folds, jax_cv.param_grid(**grid), metric
        )
        out[name] = model, scores
    return out


def row_tolerance(metric, folds, num_classes=6):
    """What one validation row per fold can move a fold-averaged score."""
    per_row = 1.0 if metric == "accuracy" else num_classes - 1.0
    return per_row * np.mean([1.0 / len(v) for _, v in folds]) + 1e-6


@pytest.mark.parametrize(
    "n,num_folds,seed", [(300, 5, 2018), (3793, 5, 2018), (17, 3, 7), (10, 10, 0)]
)
def test_kfold_indices_bit_for_bit(n, num_folds, seed):
    got = port_cv.kfold_indices(n, num_folds, seed)
    want = jax_cv.kfold_indices(n, num_folds, seed)
    assert len(got) == len(want) == num_folds
    for (gt, gv), (wt, wv) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gv, wv)
        assert gt.dtype == wt.dtype and gv.dtype == wv.dtype


@pytest.mark.parametrize(
    "grid", [FULL_GRID, {}, MAE_GRID, dict(max_depth=[2, 3], max_bins=[16])]
)
def test_param_grid_bit_for_bit(grid):
    assert port_cv.param_grid(**grid) == jax_cv.param_grid(**grid)


@pytest.mark.parametrize("case", LR_CASES)
def test_lr_cross_validator_matches_jax(case, jax_lr_cvs):
    grid, metric, kw = LR_CASES[case]
    want, want_scores = jax_lr_cvs[case]
    est = LogisticRegression(**kw, device="cpu")
    got = port_cv.CrossValidator(
        est, port_cv.param_grid(**grid), selection_metric=metric
    ).fit(FeatureSet(X, Y))
    folds = port_cv.kfold_indices(len(Y), 5, 2018)
    assert got.best_params == want.best_params
    np.testing.assert_allclose(
        got.avg_metrics, want.avg_metrics, rtol=0, atol=row_tolerance(metric, folds)
    )
    scores = est.cv_scores(FeatureSet(X, Y), folds, port_cv.param_grid(**grid), metric)
    if case == "balanced":  # class-weighted rows take the generic path
        assert scores is None and want_scores is None
        return
    per_fold = np.array([1.0 / len(v) for _, v in folds])
    per_row = 1.0 if metric == "accuracy" else 5.0
    diff = np.abs(scores - want_scores)
    assert (diff <= per_row * per_fold[None] + 1e-6).all(), diff
    # the refit on the whole set is the plain fit at the best params
    refit = est.copy_with(**got.best_params).fit(FeatureSet(X, Y))
    np.testing.assert_array_equal(
        got.transform(FeatureSet(X, Y)).prediction,
        refit.transform(FeatureSet(X, Y)).prediction,
    )


def test_decision_tree_cross_validator_equals_jax(monkeypatch, tmp_path):
    """The generic path over DT's empty grid: 5 fold fits and a refit, each
    tree the JAX package's, so the fold scores are equal exactly."""
    monkeypatch.setenv("HAR_TPU_WISDM_CSV", str(tmp_path / "absent.csv"))
    config = RunConfig(data=DataConfig(synthetic_rows=600))
    train, _, _ = featurize(config, load_dataset(config))
    got = port_cv.CrossValidator(
        DecisionTreeClassifier(device="cpu"), port_cv.param_grid()
    ).fit(train)
    want = jax_cv.CrossValidator(JaxDT(), jax_cv.param_grid()).fit(
        JaxFeatureSet(train.features, train.label)
    )
    assert got.avg_metrics == want.avg_metrics
    assert got.best_params == want.best_params == {}
    np.testing.assert_array_equal(got.best_model.tree.feature, want.best_model.tree.feature)
    assert got.num_classes == want.num_classes
