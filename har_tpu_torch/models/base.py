"""Estimator/model protocol shared by every classifier, and the
prediction record a model's ``transform`` returns.

Mirrors the shape of the MLlib API the reference drives (estimator.fit →
model.transform, reference Main/main.py:115-130): raw scores,
probabilities and argmax predictions for one batch, as host arrays.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Protocol, runtime_checkable

import numpy as np

if TYPE_CHECKING:
    from har_tpu_torch.features.wisdm_pipeline import FeatureSet


@dataclasses.dataclass(frozen=True)
class Predictions:
    """Per-row outputs, the analogue of MLlib's prediction columns."""

    raw: np.ndarray  # (n, C) rawPrediction (margins / votes)
    probability: np.ndarray  # (n, C)
    prediction: np.ndarray  # (n,) argmax class

    def __len__(self) -> int:
        return len(self.prediction)

    @staticmethod
    def from_raw(raw, probability) -> "Predictions":
        raw = np.asarray(raw)
        probability = np.asarray(probability)
        return Predictions(
            raw=raw,
            probability=probability,
            prediction=np.asarray(probability.argmax(axis=-1), dtype=np.int32),
        )


@runtime_checkable
class ClassifierModel(Protocol):
    num_classes: int

    def transform(self, data: FeatureSet) -> Predictions: ...


@runtime_checkable
class Classifier(Protocol):
    def fit(self, data: FeatureSet) -> ClassifierModel: ...

    def copy_with(self, **params) -> "Classifier": ...
