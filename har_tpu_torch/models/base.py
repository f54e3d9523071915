"""The prediction record every classifier's ``transform`` returns.

Mirrors the shape of the MLlib API the reference drives (estimator.fit →
model.transform, reference Main/main.py:115-130): raw scores,
probabilities and argmax predictions for one batch, as host arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np


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
