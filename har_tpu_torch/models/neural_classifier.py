"""Estimator-protocol wrapper around the neural models + Trainer.

Port of ``har_tpu/models/neural_classifier.py``: gives the neural family
the fit/transform surface of the classical models, so the runner and the
report writer treat a neural model as they treat a tree.  Inputs are
standardized over axis 0 (per step and axis for raw windows) by a scaler
fitted on the training rows; ``augment`` names the policy
(``data/augment.py``) the trainer applies to each standardized batch.
The module is built for the width of the rows it is fitted on.

A repeat ``fit`` on the same ``FeatureSet`` object is a warm refit, as in
the JAX package: it reuses the fitted scaler, the standardized array
(the same ndarray, so the Trainer's staged-path cache finds its copy on
the device) and the Trainer; the module is built anew and the Trainer
re-initialises it from the config's seed and builds a new optimizer, so
the refit is bit-identical to a cold fit and the model an earlier fit
returned keeps its own module.  The fit's history says
``warm_refit``.
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
    model_name: str = "mlp"
    config: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)
    model_kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    standardize: bool = True
    num_classes: int | None = None
    # augmentation policy name (data.augment.build_augment): "raw_windows"
    # for raw (B, T, 3) window models, None / "none" for no augmentation
    augment: str | None = None
    device: str = "cuda"
    # a parallel.mesh mesh of ranks (train.Trainer(mesh=)), or None
    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)
    # warm-refit state, keyed on the FeatureSet object it holds (so its id
    # cannot be recycled); not part of the estimator's value, and a copy
    # (copy_with, dataclasses.replace) starts with an empty one: it may
    # carry another config
    _fit_cache: dict = dataclasses.field(
        default_factory=dict, init=False, compare=False, repr=False
    )

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
        cache = self._fit_cache
        if cache.get("data") is data:
            x, y = cache["x"], cache["y"]
            num_classes, scaler, trainer = cache["num_classes"], cache["scaler"], cache["trainer"]
            trainer.module = self._module(num_classes, x)
        else:
            x = np.asarray(data.features, np.float32)
            y = np.asarray(data.label, np.int32)
            num_classes = self.num_classes or int(y.max()) + 1
            scaler = StandardScaler().fit(x) if self.standardize else None
            if scaler is not None:
                x = scaler.transform(x)
            trainer = Trainer(self._module(num_classes, x), self.config, device=self.device,
                              augment=build_augment(self.augment), mesh=self.mesh)
            cache.clear()
            cache.update(data=data, x=x, y=y, num_classes=num_classes, scaler=scaler,
                         trainer=trainer)
        trained = trainer.fit(x, y, num_classes=num_classes)
        return NeuralClassifierModel(
            inner=trained, scaler=scaler, num_classes=num_classes
        )

    def _module(self, num_classes: int, x: np.ndarray):
        return build_model(self.model_name, num_classes=num_classes,
                           in_features=x.shape[-1], **self.model_kwargs)


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
