"""The port's bit-exact MLlib replays against `har_tpu`'s, bit for bit.

Every comparison is exact (``assert_array_equal`` / ``==`` on floats):
the replays run on the host in numpy and the same C++ source, compiled
with the same g++ flags, so the port must reproduce `har_tpu`'s
double-precision trajectory to the last bit.  Inputs come from a numpy
seed or from the synthetic WISDM table's exact design.
"""

import dataclasses

import numpy as np
import pytest
import torch

import har_tpu.runner as jax_runner
from har_tpu.config import DataConfig as JaxDataConfig
from har_tpu.config import RunConfig as JaxRunConfig
from har_tpu.data import spark_random as jax_random
from har_tpu.models import _jvm_native as jax_native
from har_tpu.models import breeze_optimize as jax_breeze
from har_tpu.models import mllib_exact as jax_exact
from har_tpu.models import mllib_lr as jax_lr
from har_tpu.models import mllib_rf as jax_rf
from har_tpu.tuning import mllib_cv as jax_cv
from har_tpu_torch import convert
from har_tpu_torch import runner as port_runner
from har_tpu_torch.config import DataConfig, RunConfig
from har_tpu_torch.data import spark_random as port_random
from har_tpu_torch.models import _jvm_native as port_native
from har_tpu_torch.models import breeze_optimize as port_breeze
from har_tpu_torch.models import mllib_exact as port_exact
from har_tpu_torch.models import mllib_lr as port_lr
from har_tpu_torch.models import mllib_rf as port_rf
from har_tpu_torch.tuning import mllib_cv as port_cv

torch.set_num_threads(1)

ROWS = 600  # synthetic WISDM rows; the spark split leaves ~420 to train
LR_ROWS = 400


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    """(JAX train, JAX test, port train, port test) FeatureSets of the
    synthetic table's spark split, each carrying its exact design."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HAR_TPU_WISDM_CSV", str(tmp_path_factory.getbasetemp() / "absent.csv"))
        jax_cfg = JaxRunConfig(data=JaxDataConfig(synthetic_rows=ROWS))
        port_cfg = RunConfig(data=DataConfig(synthetic_rows=ROWS))
        jtr, jte, _ = jax_runner.featurize(jax_cfg, jax_runner.load_dataset(jax_cfg))
        ptr, pte, _ = port_runner.featurize(port_cfg, port_runner.load_dataset(port_cfg))
    return jtr, jte, ptr, pte


def _csr_pair(splits, rows=LR_ROWS):
    jtr, _, ptr, _ = splits
    idx = np.arange(rows)
    return (
        jtr.exact.x.take(idx), jtr.exact.label[idx],
        ptr.exact.x.take(idx), ptr.exact.label[idx],
    )


def test_exact_design_equal(splits):
    jtr, jte, ptr, pte = splits
    for j, p in ((jtr, ptr), (jte, pte)):
        for field in ("indices", "values", "indptr"):
            np.testing.assert_array_equal(getattr(p.exact.x, field), getattr(j.exact.x, field))
        assert p.exact.x.n_cols == j.exact.x.n_cols
        np.testing.assert_array_equal(p.exact.label, j.exact.label)
        np.testing.assert_array_equal(p.exact.uid, j.exact.uid)


def _smooth_problem(seed=0, n=60, d=5):
    """A logistic loss with an L2 term on seeded data, as numpy: the same
    function object drives both optimizers."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, d))
    y = (rng.random(n) < 0.5).astype(np.float64)

    def f(x):
        z = a @ x
        p = 1.0 / (1.0 + np.exp(-z))
        loss = float(np.sum(np.logaddexp(0.0, z) - y * z)) + 0.05 * float(x @ x)
        return loss, a.T @ (p - y) + 0.1 * x

    return f, d


_STATE_FIELDS = ("x", "value", "grad", "adjusted_value", "adjusted_gradient", "iter",
                 "initial_adj_val", "fval_info", "search_failed", "converged_reason")


@pytest.mark.parametrize("optimizer", ["LBFGS", "OWLQN"])
def test_breeze_state_sequences_equal(optimizer):
    f, d = _smooth_problem()
    kwargs = dict(max_iter=15, m=4, tolerance=1e-9)
    if optimizer == "OWLQN":
        kwargs["l1reg"] = np.full(d, 0.3)
    jax_states = list(getattr(jax_breeze, optimizer)(**kwargs).iterations(f, np.zeros(d)))
    port_states = list(getattr(port_breeze, optimizer)(**kwargs).iterations(f, np.zeros(d)))
    assert len(port_states) == len(jax_states) > 3
    for got, want in zip(port_states, jax_states):
        for field in _STATE_FIELDS:
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)


@pytest.mark.parametrize("elastic_net", [0.0, 0.1])
def test_fit_mllib_lr_bit_exact(splits, elastic_net):
    """L-BFGS (elastic net 0) and OWL-QN (> 0) on 400 rows of the exact
    design: summarizer statistics, coefficients, mean-centred intercepts,
    objective history and predictions."""
    jx, jy, px, py = _csr_pair(splits)
    for got, want in zip(port_lr.summarizer_statistics(px, py, 6),
                         jax_lr.summarizer_statistics(jx, jy, 6)):
        np.testing.assert_array_equal(got, want)
    kwargs = dict(num_classes=6, max_iter=20, reg_param=0.3, elastic_net_param=elastic_net)
    want = jax_lr.fit_mllib_lr(jx, jy, **kwargs)
    got = port_lr.fit_mllib_lr(px, py, **kwargs)
    np.testing.assert_array_equal(got.coefficient_matrix, want.coefficient_matrix)
    np.testing.assert_array_equal(got.intercepts, want.intercepts)
    assert got.objective_history == want.objective_history
    assert len(got.objective_history) > 2
    for g, w in zip(got.transform(px), want.transform(jx)):
        np.testing.assert_array_equal(g, w)


def test_mllib_cross_validate_bit_exact(splits):
    """Fold draws under the py2 CrossValidator seed, every grid point's
    averaged MAE, the winner and its refit."""
    jx, jy, px, py = _csr_pair(splits)
    seed = port_random.py2_string_hash("CrossValidator")
    assert seed == jax_random.py2_string_hash("CrossValidator") == port_cv.default_cv_seed()
    np.testing.assert_array_equal(
        port_random.bernoulli_draws(px.n_rows, seed), jax_random.bernoulli_draws(jx.n_rows, seed)
    )
    want = jax_cv.mllib_cross_validate(jx, jy, max_iter=5)
    got = port_cv.mllib_cross_validate(px, py, max_iter=5)
    assert got.avg_metrics == want.avg_metrics
    assert got.best_index == want.best_index and got.best_params == want.best_params
    np.testing.assert_array_equal(got.model.coefficient_matrix, want.model.coefficient_matrix)
    np.testing.assert_array_equal(got.model.intercepts, want.model.intercepts)


def _node_arrays(tree) -> dict:
    nodes = [tree[k] for k in sorted(tree)]
    return {
        f: np.asarray([getattr(n, f) for n in nodes]) for f in convert.MLLIB_NODE_FIELDS
    }


def test_fit_mllib_rf_bit_exact(splits):
    """5 trees on the training split: every node's arrays and the
    predictions on the test split."""
    jtr, jte, ptr, pte = splits
    jx, px = jax_rf.dense_from_csr(jtr.exact.x), port_rf.dense_from_csr(ptr.exact.x)
    np.testing.assert_array_equal(px, jx)
    for g, w in zip(port_rf.mllib_find_splits(px, 32), jax_rf.mllib_find_splits(jx, 32)):
        np.testing.assert_array_equal(g, w)
    kwargs = dict(num_classes=6, num_trees=5, max_depth=4, max_bins=32,
                  seed=port_rf.default_rf_seed())
    want = jax_rf.fit_mllib_rf(jx, jtr.exact.label, **kwargs)
    got = port_rf.fit_mllib_rf(px, ptr.exact.label, **kwargs)
    assert len(got.trees) == len(want.trees) == 5
    for g, w in zip(got.trees, want.trees):
        ga, wa = _node_arrays(g), _node_arrays(w)
        for f in convert.MLLIB_NODE_FIELDS:
            np.testing.assert_array_equal(ga[f], wa[f], err_msg=f)
    test_x = port_rf.dense_from_csr(pte.exact.x)
    for g, w in zip(got.transform(test_x), want.transform(test_x)):
        np.testing.assert_array_equal(g, w)


def test_exact_estimators_equal(splits):
    """The classifier-protocol wrappers on FeatureSets: the port's
    LogisticRegressionExact and RandomForestExact score the test split as
    har_tpu's do."""
    jtr, jte, ptr, pte = splits
    for jest, pest in (
        (jax_exact.LogisticRegressionExact(max_iter=5),
         port_exact.LogisticRegressionExact(max_iter=5)),
        (jax_exact.RandomForestExact(num_trees=3), port_exact.RandomForestExact(num_trees=3)),
    ):
        jm, pm = jest.fit(jtr), pest.fit(ptr)
        assert pm.num_classes == jm.num_classes and pm.num_trees == jm.num_trees
        jp, pp = jm.transform(jte), pm.transform(pte)
        for field in ("raw", "probability", "prediction"):
            np.testing.assert_array_equal(getattr(pp, field), getattr(jp, field))


def test_models_carried_across(splits):
    """A JAX-fitted exact LR and RF, carried over as arrays, predict the
    test split exactly as they do in har_tpu."""
    jtr, jte, _, pte = splits
    jlr = jax_exact.LogisticRegressionExact(max_iter=5).fit(jtr)
    lr = convert.mllib_lr_from_arrays(
        jlr.inner.coefficient_matrix, jlr.inner.intercepts, jlr.inner.objective_history
    )
    jrf = jax_exact.RandomForestExact(num_trees=4).fit(jtr)
    rf = convert.mllib_rf_from_arrays(
        [_node_arrays(tree) for tree in jrf.inner.trees], jrf.num_classes
    )
    for jax_model, port_model in ((jlr, lr), (jrf, rf)):
        want, got = jax_model.transform(jte), port_model.transform(pte)
        for field in ("raw", "probability", "prediction"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert rf.num_trees == 4 and lr.inner.objective_history == jlr.inner.objective_history


@pytest.mark.parametrize(
    "text", ["", "CrossValidator", "RandomForestClassifier", "a", "héllo ünïcode"]
)
def test_py2_string_hash_equal(text):
    assert port_random.py2_string_hash(text) == jax_random.py2_string_hash(text)


def test_java_random_equal():
    rng = np.random.default_rng(0)
    for seed in [0, 42, -7, *rng.integers(-(2**62), 2**62, 5).tolist()]:
        j, p = jax_rf.JavaRandom(seed), port_rf.JavaRandom(seed)
        assert [p.next_long() for _ in range(20)] == [j.next_long() for _ in range(20)]
        assert [p.next(32) for _ in range(5)] == [j.next(32) for _ in range(5)]


def test_native_draws_equal():
    """rf_poisson_weights and reservoir_sample_range: the same streams."""
    np.testing.assert_array_equal(
        port_native.rf_poisson_weights(12345, 300, 7),
        jax_native.rf_poisson_weights(12345, 300, 7),
    )
    np.testing.assert_array_equal(
        port_native.rf_poisson_weights(99, 50, 3, subsample=0.5),
        jax_native.rf_poisson_weights(99, 50, 3, subsample=0.5),
    )
    for seed, n, k in ((987654321, 200, 14), (5, 3100, 56), (-3, 10, 10)):
        state = port_random.xorshift_hash_seed(seed)
        assert state == jax_random.xorshift_hash_seed(seed)
        np.testing.assert_array_equal(
            port_native.reservoir_sample_range(state, n, k),
            jax_native.reservoir_sample_range(state, n, k),
        )


def test_jvm_math_equal():
    """fdlibm exp/log, the strict left-to-right dot and F2J's dnrm2."""
    rng = np.random.default_rng(1)
    for x in np.concatenate([np.linspace(-700, 700, 301), rng.normal(0, 20, 200)]):
        assert port_native.jvm_exp(x) == jax_native.jvm_exp(x)
    for x in np.concatenate([np.logspace(-300, 300, 301), rng.random(200)]):
        assert port_native.jvm_log(x) == jax_native.jvm_log(x)
    assert repr(port_native.jvm_exp(1.0)) == "2.7182818284590455"
    a, b = rng.normal(size=1001), rng.normal(size=1001)
    assert port_native.ddot(a, b) == jax_native.ddot(a, b)
    assert port_native.dnrm2_f2j(a) == jax_native.dnrm2_f2j(a)


def test_lr_loss_grad_equal(splits):
    """MLlib's LogisticAggregator plus L2 on a seeded coefficient vector:
    the loss and every gradient entry."""
    jx, jy, px, py = _csr_pair(splits, rows=200)
    std, _ = port_lr.summarizer_statistics(px, py, 6)
    coef = np.random.default_rng(2).normal(0, 0.1, 6 * (px.n_cols + 1))
    grads = [np.empty_like(coef), np.empty_like(coef)]
    losses = [
        mod.lr_loss_grad(coef, x, y, std, 6, True, 0.3, g)
        for mod, x, y, g in ((port_native, px, py, grads[0]), (jax_native, jx, jy, grads[1]))
    ]
    assert losses[0] == losses[1]
    np.testing.assert_array_equal(grads[0], grads[1])


def test_exact_estimator_without_design_raises(splits):
    _, _, ptr, _ = splits
    with pytest.raises(ValueError, match="FeatureSet.exact"):
        port_exact.LogisticRegressionExact().fit(dataclasses.replace(ptr, exact=None))
