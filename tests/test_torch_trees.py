"""The port's decision trees and random forests against the JAX package.

Both packages featurize the same synthetic WISDM table (600 rows) and fit
on their own copies.  Decision trees must be bit-identical to the JAX
package's on both of its histogram paths (the XLA one-hot matmul and the
Pallas kernel in interpret mode).  A random forest grown with the JAX
package's bootstrap and feature-score draws, passed in, must be identical
tree for tree; under the port's own generator it gets structural checks.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import har_tpu.runner as jax_runner
from har_tpu.config import DataConfig as JaxDataConfig
from har_tpu.config import RunConfig as JaxRunConfig
from har_tpu.data.synthetic import synthetic_wisdm as jax_synthetic_wisdm
from har_tpu.models.forest import RandomForestClassifier as JaxForest
from har_tpu.models.tree import DecisionTreeClassifier as JaxTree
from har_tpu.models.tree import binize as jax_binize
from har_tpu.models.tree import mllib_split_candidates as jax_candidates
from har_tpu_torch import convert
from har_tpu_torch import runner as port_runner
from har_tpu_torch.config import DataConfig, RunConfig
from har_tpu_torch.data.synthetic import synthetic_wisdm
from har_tpu_torch.models import forest as port_forest
from har_tpu_torch.models import tree as port_tree
from har_tpu_torch.ops.metrics import evaluate

torch.set_num_threads(1)

ROWS = 600


@pytest.fixture(scope="module")
def datasets():
    """(JAX train, JAX test, port train, port test) on the same table."""
    jax_cfg = JaxRunConfig(data=JaxDataConfig(synthetic_rows=ROWS))
    port_cfg = RunConfig(data=DataConfig(synthetic_rows=ROWS))
    jtr, jte, _ = jax_runner.featurize(jax_cfg, jax_synthetic_wisdm(ROWS, seed=2018))
    ptr, pte, _ = port_runner.featurize(port_cfg, synthetic_wisdm(ROWS, seed=2018))
    np.testing.assert_array_equal(jtr.features, ptr.features)
    np.testing.assert_array_equal(jte.label, pte.label)
    return jtr, jte, ptr, pte


def _assert_tree_equal(jax_tree, port_tree_arrays):
    for field in ("feature", "threshold", "leaf_class", "leaf_probs", "leaf_counts"):
        np.testing.assert_array_equal(
            getattr(port_tree_arrays, field), getattr(jax_tree, field), err_msg=field
        )


def test_binize_equals_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(80, 6)).astype(np.float32)
    x[:, 2] = rng.integers(0, 2, size=80)  # a one-hot style column
    x[:, 3] = 1.5  # a constant column: all +inf candidates
    th = jax_candidates(x, 8)
    ours = port_tree.binize(torch.from_numpy(x), torch.from_numpy(th)).numpy()
    theirs = np.asarray(jax_binize(jnp.asarray(x), jnp.asarray(th)))
    assert ours.dtype == np.int32
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(port_tree.mllib_split_candidates(x, 8), th)


@pytest.mark.parametrize("use_pallas_hist", [False, True])
def test_decision_tree_arrays_bit_identical(datasets, use_pallas_hist):
    jtr, _, ptr, _ = datasets
    theirs = JaxTree(use_pallas_hist=use_pallas_hist).fit(jtr)
    ours = port_tree.DecisionTreeClassifier(device="cpu").fit(ptr)
    _assert_tree_equal(theirs.tree, ours.tree)
    assert ours.tree.max_depth == theirs.tree.max_depth == 3
    assert ours.num_nodes == theirs.num_nodes


def _jax_forest_draws(seed, num_trees, n, d, max_depth):
    """har_tpu/models/forest.py:67-71 and tree.py:308-309, drawn out."""
    boot_rng, feat_rng = jax.random.split(jax.random.PRNGKey(seed))
    boot = jax.random.poisson(boot_rng, 1.0, shape=(num_trees, n))
    feat_rngs = jax.random.split(feat_rng, num_trees)
    width = 2**max_depth
    scores = np.stack(
        [
            np.stack(
                [
                    np.asarray(
                        jax.random.uniform(
                            jax.random.fold_in(feat_rngs[t], level), (width, d)
                        )
                    )
                    for t in range(num_trees)
                ]
            )
            for level in range(max_depth)
        ]
    )
    return np.asarray(boot, np.float32), scores


def test_forest_with_injected_draws_is_identical_tree_for_tree(datasets):
    """10 trees: a full chunk of 8 and a last chunk of 2."""
    jtr, _, ptr, _ = datasets
    num_trees, seed = 10, 3
    theirs = JaxForest(num_trees=num_trees, seed=seed, use_pallas_hist=False).fit(jtr)
    boot, scores = _jax_forest_draws(
        seed, num_trees, len(ptr), ptr.num_features, theirs.max_depth
    )
    ours = port_forest.RandomForestClassifier(
        num_trees=num_trees, seed=seed, device="cpu"
    ).fit(ptr, boot=torch.from_numpy(boot), feature_scores=torch.from_numpy(scores))
    for field in ("feature", "threshold", "leaf_probs"):
        np.testing.assert_array_equal(
            getattr(ours, field), getattr(theirs, field), err_msg=field
        )


def test_forest_own_generator_structure(datasets):
    _, _, ptr, pte = datasets
    est = port_forest.RandomForestClassifier(num_trees=8, device="cpu")
    n, d = len(ptr), ptr.num_features
    boot, scores = est.draws(n, d)
    assert boot.shape == (8, n)
    assert abs(float(boot.mean()) - 1.0) < 0.05
    assert scores.shape == (4, 8, 16, d)
    k = math.ceil(math.sqrt(d))
    kth = torch.sort(scores, dim=-1).values[..., k - 1 : k]
    assert bool(((scores <= kth).sum(-1) == k).all())
    # the draws are the seed's: a second estimator gives the same ones
    boot2, scores2 = port_forest.RandomForestClassifier(num_trees=8).draws(n, d)
    assert torch.equal(boot, boot2) and torch.equal(scores, scores2)

    model = est.fit(ptr)
    assert model.feature.shape == (8, 31)
    # every split of every tree uses a feature its node was allowed
    for t in range(8):
        for node in np.nonzero(model.feature[t] >= 0)[0]:
            level = int(math.log2(node + 1))
            slot = node - (2**level - 1)
            feat = int(model.feature[t, node])
            assert scores[level, t, slot, feat] <= kth[level, t, slot, 0]
    acc = evaluate(pte.label, model.transform(pte).raw, model.num_classes)["accuracy"]
    assert acc > 0.4, acc


def test_convert_tree_predicts_like_jax(datasets):
    jtr, jte, _, pte = datasets
    theirs = JaxTree().fit(jtr)
    t = theirs.tree
    ours = convert.tree_from_arrays(
        t.feature, t.threshold, t.leaf_class, t.leaf_probs, t.leaf_counts,
        t.max_depth, device="cpu",
    )
    want, got = theirs.transform(jte), ours.transform(pte)
    np.testing.assert_array_equal(got.prediction, want.prediction)
    np.testing.assert_array_equal(got.probability, want.probability)
    np.testing.assert_array_equal(got.raw, want.raw)


def test_convert_forest_predicts_like_jax(datasets):
    jtr, jte, _, pte = datasets
    theirs = JaxForest(num_trees=8, use_pallas_hist=False).fit(jtr)
    ours = convert.forest_from_arrays(
        theirs.feature, theirs.threshold, theirs.leaf_probs, theirs.max_depth,
        device="cpu",
    )
    want, got = theirs.transform(jte), ours.transform(pte)
    np.testing.assert_array_equal(got.prediction, want.prediction)
    # the mean over trees may sum in another order: last-ulp tolerance
    np.testing.assert_allclose(got.probability, want.probability, rtol=1e-6)


def test_tree_model_needs_cuda_unless_cpu_is_named(datasets, monkeypatch):
    _, _, ptr, _ = datasets
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        port_tree.DecisionTreeClassifier().fit(ptr)


def test_grow_tree_asks_for_each_levels_live_width(datasets, monkeypatch):
    """Level L's histogram is (T, 2**L * C, d*B), from the row-sparse
    entry; the dense entry is off the tree path."""
    _, _, ptr, _ = datasets
    calls = []
    row_sparse = port_tree.hist_ops.hist_rows

    def recording(bins, slot, weight, wc, max_bins):
        out = row_sparse(bins, slot, weight, wc, max_bins)
        calls.append((wc, tuple(out.shape)))
        return out

    def dense(*args):
        raise AssertionError("the tree path called the dense hist")

    monkeypatch.setattr(port_tree.hist_ops, "hist_rows", recording)
    monkeypatch.setattr(port_tree.hist_ops, "hist", dense)
    d, classes = ptr.num_features, int(ptr.label.max()) + 1
    for est, trees in (
        (port_tree.DecisionTreeClassifier(device="cpu"), 1),
        (port_forest.RandomForestClassifier(num_trees=3, device="cpu"), 3),
    ):
        calls.clear()
        est.fit(ptr)
        want = [2**level * classes for level in range(est.max_depth)]
        assert calls == [(wc, (trees, wc, d * 32)) for wc in want]


def test_decision_tree_at_depth_5_bit_identical(datasets):
    jtr, _, ptr, _ = datasets
    theirs = JaxTree(max_depth=5, use_pallas_hist=False).fit(jtr)
    assert (theirs.tree.feature[15:31] >= 0).any()  # level 4 splits
    ours = port_tree.DecisionTreeClassifier(max_depth=5, device="cpu").fit(ptr)
    _assert_tree_equal(theirs.tree, ours.tree)


def test_forest_at_depth_5_with_injected_draws_is_identical(datasets):
    jtr, _, ptr, _ = datasets
    num_trees, seed, depth = 3, 5, 5
    theirs = JaxForest(
        num_trees=num_trees, max_depth=depth, seed=seed, use_pallas_hist=False
    ).fit(jtr)
    assert (theirs.feature[:, 15:31] >= 0).any()  # level 4 splits
    boot, scores = _jax_forest_draws(seed, num_trees, len(ptr), ptr.num_features, depth)
    ours = port_forest.RandomForestClassifier(
        num_trees=num_trees, max_depth=depth, seed=seed, device="cpu"
    ).fit(ptr, boot=torch.from_numpy(boot), feature_scores=torch.from_numpy(scores))
    for field in ("feature", "threshold", "leaf_probs"):
        np.testing.assert_array_equal(
            getattr(ours, field), getattr(theirs, field), err_msg=field
        )
