"""The port's data, feature and metric layers against the JAX package.

These modules are numpy copies, so everything here is held to exact
equality: the table, the fitted vocabularies, the design matrix, the
Spark-exact and Bernoulli split rows, and every number of the evaluation
battery (ties and never-predicted classes included).
"""

import numpy as np
import pytest
import torch

import har_tpu.runner as jax_runner
from har_tpu.config import DataConfig as JaxDataConfig
from har_tpu.config import RunConfig as JaxRunConfig
from har_tpu.data.spark_split import spark_split_indices as jax_split
from har_tpu.data.synthetic import synthetic_wisdm as jax_synthetic_wisdm
from har_tpu.features.wisdm_pipeline import build_wisdm_pipeline as jax_pipeline
from har_tpu.ops.metrics import evaluate as jax_evaluate
from har_tpu_torch import runner as port_runner
from har_tpu_torch.config import DataConfig, RunConfig
from har_tpu_torch.data.csv_loader import read_csv
from har_tpu_torch.data.spark_split import spark_split_indices
from har_tpu_torch.data.synthetic import synthetic_wisdm
from har_tpu_torch.features.wisdm_pipeline import build_wisdm_pipeline
from har_tpu_torch.ops.metrics import evaluate

torch.set_num_threads(1)

ROWS = 600


@pytest.fixture(scope="module")
def tables():
    return jax_synthetic_wisdm(ROWS, seed=2018), synthetic_wisdm(ROWS, seed=2018)


def test_table_equal(tables):
    theirs, ours = tables
    assert ours.schema.names == theirs.schema.names
    assert [t.value for t in ours.schema.types] == [t.value for t in theirs.schema.types]
    for name in theirs.column_names:
        np.testing.assert_array_equal(ours[name], theirs[name])


def test_vocabularies_and_design_matrix_identical(tables):
    theirs_t, ours_t = tables
    theirs = jax_pipeline().fit(theirs_t)
    ours = build_wisdm_pipeline().fit(ours_t)
    assert len(ours.stages) == len(theirs.stages)
    for a, b in zip(ours.stages, theirs.stages):
        assert type(a).__name__ == type(b).__name__
        for attr in ("vocab", "cardinality"):
            if hasattr(b, attr):
                assert getattr(a, attr) == getattr(b, attr)
    np.testing.assert_array_equal(
        ours.transform(ours_t)["features"], theirs.transform(theirs_t)["features"]
    )
    np.testing.assert_array_equal(
        ours.transform(ours_t)["label"], theirs.transform(theirs_t)["label"]
    )


def test_spark_split_rows_identical(tables):
    theirs_t, ours_t = tables
    want = jax_split(theirs_t, [0.7, 0.3], 2018)
    got = spark_split_indices(ours_t, [0.7, 0.3], 2018)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dataset", ["wisdm", "synthetic"])
def test_featurize_split_identical(tables, dataset):
    """Spark-exact split (wisdm) and Bernoulli split (synthetic)."""
    theirs_t, ours_t = tables
    jtr, jte, _ = jax_runner.featurize(
        JaxRunConfig(data=JaxDataConfig(dataset=dataset, synthetic_rows=ROWS)),
        theirs_t,
    )
    ptr, pte, _ = port_runner.featurize(
        RunConfig(data=DataConfig(dataset=dataset, synthetic_rows=ROWS)), ours_t
    )
    for a, b in ((ptr, jtr), (pte, jte)):
        np.testing.assert_array_equal(a.rows, b.rows)
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.label, b.label)
        np.testing.assert_array_equal(a.uid, b.uid)
        assert a.class_names == b.class_names
        # the spark split attaches the replays' float64 design, as JAX's does
        assert (a.exact is None) == (b.exact is None) == (dataset != "wisdm")
        if a.exact is not None:
            for field in ("indices", "values", "indptr"):
                np.testing.assert_array_equal(getattr(a.exact.x, field), getattr(b.exact.x, field))
            np.testing.assert_array_equal(a.exact.label, b.exact.label)
            np.testing.assert_array_equal(a.exact.uid, b.exact.uid)


def test_csv_roundtrip_equal(tmp_path, tables):
    from har_tpu.data.csv_loader import read_csv as jax_read_csv

    _, table = tables
    path = tmp_path / "t.csv"
    names = table.column_names
    with open(path, "w") as f:
        f.write(",".join(names) + "\n")
        for i in range(len(table)):
            f.write(",".join(str(table[c][i]) for c in names) + "\n")
    ours = read_csv(str(path))
    theirs = jax_read_csv(str(path), engine="python")
    assert ours.schema.names == theirs.schema.names
    assert [t.value for t in ours.schema.types] == [t.value for t in theirs.schema.types]
    for name in names:
        np.testing.assert_array_equal(ours[name], theirs[name])


def _battery_cases():
    rng = np.random.default_rng(0)
    n, c = 200, 6
    labels = rng.integers(0, c, size=n)
    # random scores
    yield labels, rng.random((n, c)), c
    # heavy ties: scores from a few distinct leaf distributions
    leaves = rng.random((4, c))
    yield labels, leaves[rng.integers(0, 4, size=n)], c
    # classes 4 and 5 never predicted
    scores = rng.random((n, c))
    scores[:, 4:] = -1.0
    yield labels, scores, c
    # integer count scores (a tree's rawPrediction)
    yield labels, rng.integers(0, 5, size=(n, c)).astype(np.float64), c


@pytest.mark.parametrize("case", range(4))
def test_evaluate_equals_jax(case):
    labels, scores, c = list(_battery_cases())[case]
    want = jax_evaluate(labels, scores, c)
    got = evaluate(labels, scores, c)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key
