"""Soft-voting ensembles over any Classifier estimators.

Port of ``har_tpu/models/ensemble.py``, copied as it is: it is numpy over
the members' ``transform``, so the members (the port's estimators, on
whatever device each names) do the device work.  MLlib (and hence the
reference, Main/main.py:103-106) has no model-combination layer; the
framework adds one.  Voting is a variance tool, not a guaranteed win.

Members train independently and predict by weighted-average
probability.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from har_tpu_torch.features.wisdm_pipeline import FeatureSet
from har_tpu_torch.models.base import Predictions


@dataclasses.dataclass(frozen=True)
class VotingClassifier:
    """Weighted soft-voting over heterogeneous member estimators."""

    estimators: tuple
    weights: tuple | None = None  # None → uniform

    def __post_init__(self):
        if not self.estimators:
            raise ValueError("VotingClassifier needs at least one estimator")
        if self.weights is not None:
            if len(self.weights) != len(self.estimators):
                raise ValueError(
                    f"{len(self.weights)} weights for "
                    f"{len(self.estimators)} estimators"
                )
            if not all(w >= 0 for w in self.weights) or not any(
                w > 0 for w in self.weights
            ):
                raise ValueError("weights must be >= 0 with a positive sum")

    def copy_with(self, **params) -> "VotingClassifier":
        """Grid-search support: a param broadcast onto every member."""
        own = {f.name for f in dataclasses.fields(self)}
        direct = {k: v for k, v in params.items() if k in own}
        member = {k: v for k, v in params.items() if k not in own}
        new = dataclasses.replace(self, **direct)
        if member:
            new = dataclasses.replace(
                new,
                estimators=tuple(
                    e.copy_with(**member) for e in new.estimators
                ),
            )
        return new

    def fit(self, data: FeatureSet) -> "VotingModel":
        models = tuple(e.fit(data) for e in self.estimators)
        return VotingModel(
            models=models,
            weights=self.weights,
            num_classes=models[0].num_classes,
        )


def seed_ensemble(estimator, n: int, base_seed: int = 0) -> VotingClassifier:
    """n copies of one estimator differing only in ``seed`` — the cheapest
    decorrelation for subsampling learners (GBDT/RF)."""
    if n < 1:
        raise ValueError("seed_ensemble needs n >= 1")
    return VotingClassifier(
        estimators=tuple(
            estimator.copy_with(seed=base_seed + i) for i in range(n)
        )
    )


@dataclasses.dataclass(frozen=True)
class VotingModel:
    models: tuple
    weights: tuple | None
    num_classes: int

    def transform(self, data: FeatureSet) -> Predictions:
        w = (
            np.asarray(self.weights, np.float64)
            if self.weights is not None
            else np.ones(len(self.models))
        )
        w = w / w.sum()
        prob = None
        for wi, m in zip(w, self.models):
            p = np.asarray(m.transform(data).probability, np.float64)
            prob = wi * p if prob is None else prob + wi * p
        prob = prob.astype(np.float32)
        # averaged probabilities are the ensemble's raw scores too: every
        # metric (incl. threshold sweeps) sees the actual voting output
        return Predictions.from_raw(prob, prob)
