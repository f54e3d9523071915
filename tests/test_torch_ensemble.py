"""The port's soft-voting ensembles against the JAX package's.

Members are boosted trees and decision trees whose fitted arrays are
carried across from ``har_tpu`` (``convert``), so both ensembles vote
over the same members: equal probabilities and predictions, with and
without weights.  The estimator side (copy_with, seed_ensemble, the
weight checks) is the JAX package's numpy, compared field by field.
"""

import numpy as np
import pytest
import torch

from har_tpu.features.wisdm_pipeline import FeatureSet as JaxFeatureSet
from har_tpu.models.ensemble import VotingModel as JaxVotingModel
from har_tpu.models.ensemble import seed_ensemble as jax_seed_ensemble
from har_tpu.models.gbdt import GradientBoostedTreesClassifier as JaxGBDT
from har_tpu.models.tree import DecisionTreeClassifier as JaxDT
from har_tpu_torch.convert import gbdt_from_arrays, tree_from_arrays
from har_tpu_torch.features.wisdm_pipeline import FeatureSet
from har_tpu_torch.models.ensemble import VotingClassifier, VotingModel, seed_ensemble
from har_tpu_torch.models.gbdt import GradientBoostedTreesClassifier

torch.set_num_threads(1)


def _table(n, seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, n).astype(np.int32)
    x = (rng.normal(size=(3, 5))[y] + rng.normal(size=(n, 5))).astype(np.float32)
    return x, y


def _members():
    x, y = _table(300, 0)
    jax_models = [JaxGBDT(num_rounds=3, max_depth=3, seed=s).fit(JaxFeatureSet(x, y))
                  for s in (0, 1)] + [JaxDT().fit(JaxFeatureSet(x, y))]
    port_models = [
        gbdt_from_arrays(m.feature, m.split_bin, m.leaf_value, m.thresholds,
                         m.learning_rate, m.max_depth, m.num_classes, device="cpu")
        for m in jax_models[:2]
    ]
    t = jax_models[2].tree
    port_models.append(tree_from_arrays(t.feature, t.threshold, t.leaf_class,
                                        t.leaf_probs, t.leaf_counts, t.max_depth,
                                        device="cpu"))
    return jax_models, port_models


@pytest.mark.parametrize("weights", [None, (1.0, 2.0, 0.5)])
def test_voting_probabilities_equal_jax(weights):
    jax_models, port_models = _members()
    x, y = _table(80, 1)
    want = JaxVotingModel(tuple(jax_models), weights, 3).transform(JaxFeatureSet(x, y))
    got = VotingModel(tuple(port_models), weights, 3).transform(FeatureSet(x, y))
    np.testing.assert_allclose(got.probability, want.probability, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got.prediction, want.prediction)
    np.testing.assert_array_equal(got.raw, got.probability)


def test_fit_votes_over_its_members():
    x, y = _table(200, 2)
    est = seed_ensemble(GradientBoostedTreesClassifier(num_rounds=2, max_depth=2,
                                                       device="cpu"), 3, base_seed=4)
    assert [e.seed for e in est.estimators] == [4, 5, 6]
    model = est.fit(FeatureSet(x, y))
    probs = np.mean([m.transform(FeatureSet(x, y)).probability for m in model.models], 0)
    np.testing.assert_allclose(model.transform(FeatureSet(x, y)).probability, probs,
                               rtol=1e-6)
    # a broadcast param reaches every member, an own field stays
    tuned = est.copy_with(max_depth=3, weights=(1, 1, 2))
    assert [e.max_depth for e in tuned.estimators] == [3, 3, 3]
    assert tuned.weights == (1, 1, 2)
    assert len(jax_seed_ensemble(JaxGBDT(), 3).estimators) == 3


@pytest.mark.parametrize(
    "kwargs,match",
    [(dict(estimators=()), "at least one"),
     (dict(estimators=(1, 2), weights=(1.0,)), "weights for"),
     (dict(estimators=(1, 2), weights=(0.0, 0.0)), "positive sum")],
)
def test_bad_ensembles_raise(kwargs, match):
    with pytest.raises(ValueError, match=match):
        VotingClassifier(**kwargs)
    with pytest.raises(ValueError, match="n >= 1"):
        seed_ensemble(GradientBoostedTreesClassifier(), 0)
