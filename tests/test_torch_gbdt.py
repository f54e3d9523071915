"""The port's boosted trees against the JAX package's, on the same inputs.

Each level's (g, h) histogram is one ``hist_rows`` call with 2K channels
at the level's live width; on the CPU it takes the plain ``index_add_``
version, which sums rows in their order, where the JAX package's one-hot
``dot_general`` sums them in XLA's blocked order.  The histograms agree
within float32 rounding, so the trees are equal split for split (feature
and split bin exactly, leaf values within rtol 1e-4) unless two splits'
gains tie exactly: two cuts that send a node's rows to the same two sides
(edge bins of different features can isolate the same few rows) may then
be taken either way.  No such tie occurs on these inputs; the default
configuration's test holds the labels.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from har_tpu import runner as jax_runner
from har_tpu.config import ModelConfig as JaxModelConfig
from har_tpu.config import RunConfig as JaxRunConfig
from har_tpu.features.wisdm_pipeline import FeatureSet as JaxFeatureSet
from har_tpu.models.gbdt import GradientBoostedTreesClassifier as JaxGBDT
from har_tpu.models.tree import binize as jax_binize
from har_tpu.models.tree import quantile_thresholds as jax_quantile_thresholds
from har_tpu_torch.convert import gbdt_from_arrays
from har_tpu_torch.features.wisdm_pipeline import FeatureSet
from har_tpu_torch.models import gbdt as port_gbdt
from har_tpu_torch.models.gbdt import GradientBoostedTreesClassifier
from har_tpu_torch.models.tree import binize, quantile_thresholds
from har_tpu_torch.ops import hist as hist_ops

torch.set_num_threads(1)

LEAF_TOL = dict(rtol=1e-4, atol=1e-5)
SMALL = dict(num_rounds=4, max_depth=3)


def _table(n=600, d=7, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n).astype(np.int32)
    centers = rng.normal(size=(classes, d))
    x = (0.8 * centers[y] + rng.normal(size=(n, d))).astype(np.float32)
    return x, y


def _fit_both(x, y, masks=None, **kw):
    jax_model = JaxGBDT(**kw).fit(JaxFeatureSet(x, y))
    port_model = GradientBoostedTreesClassifier(device="cpu", **kw).fit(
        FeatureSet(x, y), masks=masks
    )
    return jax_model, port_model


def assert_same_trees(jax_model, port_model) -> None:
    np.testing.assert_array_equal(port_model.feature, jax_model.feature)
    np.testing.assert_array_equal(port_model.split_bin, jax_model.split_bin)
    np.testing.assert_allclose(port_model.leaf_value, jax_model.leaf_value, **LEAF_TOL)


@pytest.mark.parametrize("max_bins", [32, 10, 8])
def test_quantile_thresholds_and_bins_equal_jax(max_bins):
    x, _ = _table(n=1001, d=9, seed=1)
    x[:, 0] = np.round(x[:, 0])  # repeated values: duplicate thresholds
    x[:, 1] = -1.0  # a constant column, as a PEAK column of '?'
    want = np.asarray(jax_quantile_thresholds(jnp.asarray(x), max_bins))
    got = quantile_thresholds(torch.from_numpy(x), max_bins)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        binize(torch.from_numpy(x), got).numpy(),
        np.asarray(jax_binize(jnp.asarray(x), jnp.asarray(want))),
    )


def test_level0_histogram_equals_dot_general():
    """The level's one hist_rows call (channels g_k, h_k) against the JAX
    package's interleaved (W, 2, d, B) dot_general at level 0: within rtol
    1e-5, with an atol of 1e-6 times the channel's Σ|w| for sums that
    cancel."""
    x, y = _table()
    n, d = x.shape
    classes, max_bins = 4, 32
    thresholds = jax_quantile_thresholds(jnp.asarray(x), max_bins)
    bins = np.array(jax_binize(jnp.asarray(x), thresholds))
    p = np.full((n, classes), 1.0 / classes, np.float32)
    g = p - np.eye(classes, dtype=np.float32)[y]
    h = np.maximum(p * (1 - p), 1e-6).astype(np.float32)
    onehot = jax.nn.one_hot(bins, max_bins, dtype=jnp.float32).reshape(n, d * max_bins)
    width = 1
    base = jax.nn.one_hot(np.zeros(n, np.int32), 2 * width, dtype=jnp.float32)
    slot = torch.zeros((2 * classes, n), dtype=torch.int32)
    gh = torch.from_numpy(np.stack([g.T, h.T], axis=1).reshape(2 * classes, n))
    got = hist_ops.hist_rows(torch.from_numpy(bins), slot, gh, width, max_bins)
    got = got.reshape(classes, 2, width, d, max_bins)
    for k in range(classes):
        m = g[:, k, None] * base + h[:, k, None] * jnp.roll(base, 1, axis=1)
        want = np.asarray(
            jax.lax.dot_general(m, onehot, (((0,), (0,)), ((), ())),
                                preferred_element_type=jnp.float32)
        ).reshape(width, 2, d, max_bins)
        for s, w in ((0, g[:, k]), (1, h[:, k])):
            np.testing.assert_allclose(
                got[k, s].numpy(), want[:, s], rtol=1e-5, atol=1e-6 * np.abs(w).sum()
            )


def test_each_level_is_one_hist_rows_call(monkeypatch):
    """A fit calls hist_rows once a level of every round, with 2K
    channels (g and h of each class tree) at the level's live width."""
    x, y = _table()
    calls = []
    real = hist_ops.hist_rows

    def spy(bins, slot, weight, wc, max_bins):
        calls.append((tuple(slot.shape), wc, max_bins))
        return real(bins, slot, weight, wc, max_bins)

    monkeypatch.setattr(hist_ops, "hist_rows", spy)
    GradientBoostedTreesClassifier(device="cpu", **SMALL).fit(FeatureSet(x, y))
    assert calls == [
        ((8, len(y)), 2**level, 32)
        for _ in range(SMALL["num_rounds"])
        for level in range(SMALL["max_depth"])
    ]


def test_small_configuration_trees_equal():
    x, y = _table()
    jax_model, port_model = _fit_both(x, y, **SMALL)
    np.testing.assert_array_equal(port_model.thresholds, jax_model.thresholds)
    assert_same_trees(jax_model, port_model)
    np.testing.assert_allclose(
        port_model.predict_raw(x), jax_model.predict_raw(x), rtol=1e-5, atol=1e-5
    )


def test_injected_subsample_masks_give_equal_trees():
    """subsample 0.7: the JAX package's own masks (uniform < subsample per
    round, from its round keys) handed to the port's fit."""
    x, y = _table(seed=2)
    kw = dict(SMALL, subsample=0.7, seed=5)
    keys = jax.random.split(jax.random.PRNGKey(kw["seed"]), kw["num_rounds"])
    masks = np.stack([
        np.asarray(jax.random.uniform(key, (len(y),)) < kw["subsample"], np.float32)
        for key in keys
    ])
    assert 0 < masks.mean() < 1
    jax_model, port_model = _fit_both(x, y, masks=masks, **kw)
    assert_same_trees(jax_model, port_model)


def test_subsample_draw_is_seeded_and_all_rows_at_one():
    device = torch.device("cpu")
    assert port_gbdt.subsample_masks(10, 3, 1.0, 0, device) is None
    a = port_gbdt.subsample_masks(1000, 3, 0.5, 7, device)
    assert torch.equal(a, port_gbdt.subsample_masks(1000, 3, 0.5, 7, device))
    assert a.shape == (3, 1000) and 0.4 < float(a.mean()) < 0.6


def test_default_configuration_on_synthetic_wisdm():
    """The runner's numeric view of synthetic_wisdm(5418) (13 columns, the
    spark split) at the defaults (100 rounds, depth 5): the port's
    accuracy within one test row of har_tpu's, labels equal but for at
    most one row in a thousand."""
    cfg = JaxRunConfig(model=JaxModelConfig(name="gbdt"))
    train, test, _ = jax_runner.featurize(cfg, jax_runner.load_dataset(cfg))
    assert train.features.shape == (3793, 13)
    want = JaxGBDT().fit(train).transform(test).prediction
    got = (
        GradientBoostedTreesClassifier(device="cpu")
        .fit(FeatureSet(train.features, train.label))
        .transform(FeatureSet(test.features, test.label))
        .prediction
    )
    acc = [float((p == test.label).mean()) for p in (got, want)]
    assert abs(acc[0] - acc[1]) <= 1 / len(test.label), acc
    assert (got == want).mean() >= 0.999


def test_gbdt_from_arrays_predicts_jax_scores():
    x, y = _table(seed=3)
    jax_model = JaxGBDT(num_rounds=6, max_depth=4).fit(JaxFeatureSet(x, y))
    port = gbdt_from_arrays(
        jax_model.feature, jax_model.split_bin, jax_model.leaf_value,
        jax_model.thresholds, learning_rate=jax_model.learning_rate,
        max_depth=jax_model.max_depth, num_classes=jax_model.num_classes,
        device="cpu",
    )
    x_test, y_test = _table(n=200, seed=4)
    np.testing.assert_allclose(
        port.predict_raw(x_test), jax_model.predict_raw(x_test), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        port.transform(FeatureSet(x_test, y_test)).probability,
        jax_model.transform(JaxFeatureSet(x_test, y_test)).probability,
        rtol=1e-5, atol=1e-6,
    )


def test_cpu_fit_never_launches_the_kernel():
    x, y = _table(n=100)
    before = hist_ops.HIST_ROWS_LAUNCHES
    GradientBoostedTreesClassifier(device="cpu", num_rounds=2, max_depth=2).fit(
        FeatureSet(x, y)
    )
    assert hist_ops.HIST_ROWS_LAUNCHES == before


def test_cuda_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = _table(n=50)
    with pytest.raises(RuntimeError, match="is_available"):
        GradientBoostedTreesClassifier().fit(FeatureSet(x, y))


def test_fields_match_jax():
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxGBDT)}
    port_fields = {f.name: f.default
                   for f in dataclasses.fields(GradientBoostedTreesClassifier)}
    assert port_fields == {**jax_fields, "device": "cuda"}


@pytest.mark.parametrize("model", ["gbdt", "mlp"])
def test_numeric_view_equals_jax(model):
    """The runner's numeric view (10 numeric columns, the PEAK columns
    parsed with '?' as -1) and its spark split, bit for bit."""
    from har_tpu_torch import runner as port_runner
    from har_tpu_torch.config import ModelConfig, RunConfig

    jax_cfg = JaxRunConfig(model=JaxModelConfig(name=model))
    port_cfg = RunConfig(model=ModelConfig(name=model))
    want = jax_runner.featurize(jax_cfg, jax_runner.load_dataset(jax_cfg))
    got = port_runner.featurize(port_cfg, port_runner.load_dataset(port_cfg))
    assert got[2] is None and want[2] is None
    for a, b in zip(got[:2], want[:2]):
        assert a.features.shape[1] == 13
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.label, b.label)
        np.testing.assert_array_equal(a.rows, b.rows)
        assert a.class_names == b.class_names


def test_numeric_view_with_binned_columns_equals_jax():
    """A table that kept the 30 histogram-bin columns (the real CSV loaded
    with drop_binned=False): GBDT's 43-column view, '' and '?' PEAKs -1."""
    from har_tpu.data.wisdm import numeric_feature_view as jax_view
    from har_tpu_torch.data.synthetic import synthetic_wisdm
    from har_tpu_torch.data.wisdm import BINNED_COLUMNS, numeric_feature_view

    base = synthetic_wisdm(n_rows=50, seed=1)
    rng = np.random.default_rng(0)
    columns = {name: np.array(base[name]) for name in base.column_names}
    columns["XPEAK"][:3] = ["?", "", "812.5"]
    for name in BINNED_COLUMNS:
        columns[name] = rng.random(50)
    got, names = numeric_feature_view(columns, include_binned=True)
    want, want_names = jax_view(columns, include_binned=True)
    assert got.shape == (50, 43) and names == want_names
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:3, 10], [-1.0, -1.0, 812.5])
