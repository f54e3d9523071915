"""Estimator-protocol wrapper around the neural models + Trainer.

Port of ``har_tpu/models/neural_classifier.py``: gives the neural family
the fit/transform surface of the classical models, so the runner and the
report writer treat a neural model as they treat a tree.  Inputs are
standardized over axis 0 (per step and axis for raw windows) by a scaler
fitted on the training rows; ``augment`` names the policy
(``data/augment.py``) the trainer applies to each standardized batch.
The module is built for the width of the rows it is fitted on.  The JAX
package's warm-refit cache (a bench-only optimisation) is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np

from har_tpu_torch.data.augment import build_augment
from har_tpu_torch.features.scaler import FittedScaler, StandardScaler
from har_tpu_torch.models.base import Predictions
from har_tpu_torch.models.neural import build_model
from har_tpu_torch.train.trainer import NeuralModel, Trainer, TrainerConfig


@dataclasses.dataclass(frozen=True)
class NeuralClassifier:
    model_name: str = "transformer"
    config: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)
    model_kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    standardize: bool = True
    num_classes: int | None = None
    # augmentation policy name (data.augment.build_augment): "raw_windows"
    # for raw (B, T, 3) window models, None / "none" for no augmentation
    augment: str | None = None
    device: str = "cuda"

    def copy_with(self, **params) -> "NeuralClassifier":
        """A copy with ``params`` set: the estimator's own fields directly,
        any other name on its TrainerConfig (a CV grid's learning_rate)."""
        known = {f.name for f in dataclasses.fields(self)}
        direct = {k: v for k, v in params.items() if k in known}
        extra = {k: v for k, v in params.items() if k not in known}
        if extra:
            direct["config"] = dataclasses.replace(self.config, **extra)
        return dataclasses.replace(self, **direct)

    def fit(self, data) -> "NeuralClassifierModel":
        x = np.asarray(data.features, np.float32)
        y = np.asarray(data.label, np.int32)
        num_classes = self.num_classes or int(y.max()) + 1
        scaler = StandardScaler().fit(x) if self.standardize else None
        if scaler is not None:
            x = scaler.transform(x)
        module = build_model(
            self.model_name, num_classes=num_classes,
            in_features=x.shape[-1], **self.model_kwargs
        )
        trainer = Trainer(module, self.config, device=self.device,
                          augment=build_augment(self.augment))
        trained = trainer.fit(x, y, num_classes=num_classes)
        return NeuralClassifierModel(
            inner=trained, scaler=scaler, num_classes=num_classes
        )


@dataclasses.dataclass(frozen=True)
class NeuralClassifierModel:
    inner: NeuralModel
    scaler: FittedScaler | None
    num_classes: int

    @property
    def history(self) -> dict | None:
        return self.inner.history

    def transform(self, data) -> Predictions:
        x = data.features if hasattr(data, "features") else data
        x = np.asarray(x, np.float32)
        if self.scaler is not None:
            x = self.scaler.transform(x)
        return self.inner.transform(x)
