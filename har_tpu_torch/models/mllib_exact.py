"""Classifier-protocol wrappers over the bit-exact MLlib replays.

These adapt :mod:`har_tpu_torch.models.mllib_lr` / :mod:`mllib_rf` /
:mod:`har_tpu_torch.tuning.mllib_cv` to the same estimator interface the rest
of the framework uses, so the parity pipeline (har_tpu_torch.parity) can
drive them interchangeably with the device estimators.

They train on the host from the float64 sparse design the spark-exact
split attaches to its FeatureSets (``FeatureSet.exact``) — the float32
device features are fine for the device estimators but have already
dropped the low bits MLlib's trajectory depends on.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from har_tpu_torch.features.wisdm_pipeline import FeatureSet
from har_tpu_torch.models._jvm_native import CsrMatrix
from har_tpu_torch.models.base import Predictions


@dataclasses.dataclass(frozen=True)
class ExactDesign:
    """Float64 sparse rows + labels/uids for one split, in split order."""

    x: CsrMatrix
    label: np.ndarray  # (n,) float64
    uid: np.ndarray  # (n,) int64

    @classmethod
    def build(cls, rows, csr: CsrMatrix, idx: np.ndarray) -> "ExactDesign":
        return cls(
            x=csr.take(idx), label=rows.label[idx], uid=rows.uid[idx]
        )


class DeferredExactDesign:
    """ExactDesign materialized on first use.

    The spark-exact split attaches one of these per split so ordinary
    ``train`` runs never pay the CSR packing; the shared dict caches the
    full-table CSR across the train/test pair."""

    def __init__(self, shared: dict, rows, idx: np.ndarray):
        self._shared = shared
        self._rows = rows
        self._idx = idx
        self._design: ExactDesign | None = None

    def _get(self) -> ExactDesign:
        if self._design is None:
            csr = self._shared.get("csr")
            if csr is None:
                csr = CsrMatrix.from_rows(
                    self._rows.sparse, self._rows.num_features
                )
                self._shared["csr"] = csr
            self._design = ExactDesign.build(self._rows, csr, self._idx)
        return self._design

    @property
    def x(self) -> CsrMatrix:
        return self._get().x

    @property
    def label(self) -> np.ndarray:
        return self._get().label

    @property
    def uid(self) -> np.ndarray:
        return self._get().uid


def require_exact(data: FeatureSet) -> ExactDesign:
    exact = getattr(data, "exact", None)
    if exact is None:
        raise ValueError(
            "this estimator replays MLlib bit-for-bit and needs the "
            "float64 design the spark-exact split attaches "
            "(FeatureSet.exact); use split_method='spark' on the WISDM "
            "one-hot view"
        )
    return exact


@dataclasses.dataclass(frozen=True)
class LogisticRegressionExact:
    """MLlib LogisticRegression, bit-exact (reference Main/main.py:115)."""

    max_iter: int = 20
    reg_param: float = 0.3
    elastic_net_param: float = 0.0
    num_classes: int | None = None

    def copy_with(self, **params) -> "LogisticRegressionExact":
        return dataclasses.replace(self, **params)

    def fit(self, data: FeatureSet) -> "ExactModel":
        from har_tpu_torch.models.mllib_lr import fit_mllib_lr

        design = require_exact(data)
        k = self.num_classes or int(design.label.max()) + 1
        inner = fit_mllib_lr(
            design.x,
            design.label,
            num_classes=k,
            max_iter=self.max_iter,
            reg_param=self.reg_param,
            elastic_net_param=self.elastic_net_param,
        )
        return ExactModel(inner=inner, num_classes=k)


@dataclasses.dataclass(frozen=True)
class RandomForestExact:
    """MLlib RandomForestClassifier, bit-exact (Main/main.py:478).

    The default seed is the one the reference's run effectively used:
    pyspark's HasSeed default ``hash('RandomForestClassifier')`` under
    the Python 2 client (proven by the bit-equal RF probabilities)."""

    num_trees: int = 100
    max_depth: int = 4
    max_bins: int = 32
    seed: int | None = None
    num_classes: int | None = None

    def copy_with(self, **params) -> "RandomForestExact":
        return dataclasses.replace(self, **params)

    @property
    def effective_seed(self) -> int:
        if self.seed is not None:
            return self.seed
        from har_tpu_torch.models.mllib_rf import default_rf_seed

        return default_rf_seed()

    def fit(self, data: FeatureSet) -> "ExactModel":
        from har_tpu_torch.models.mllib_rf import dense_from_csr, fit_mllib_rf

        design = require_exact(data)
        k = self.num_classes or int(design.label.max()) + 1
        inner = fit_mllib_rf(
            dense_from_csr(design.x),
            design.label,
            num_classes=k,
            num_trees=self.num_trees,
            max_depth=self.max_depth,
            max_bins=self.max_bins,
            seed=self.effective_seed,
        )
        return ExactModel(inner=inner, num_classes=k, dense_input=True)


@dataclasses.dataclass(frozen=True)
class ExactModel:
    inner: object  # MLlibLRModel | MLlibRFModel
    num_classes: int
    dense_input: bool = False
    best_params: dict | None = None  # set by CrossValidatorExact

    @property
    def num_trees(self) -> int:
        return len(getattr(self.inner, "trees", ()))

    def transform(self, data: FeatureSet) -> Predictions:
        design = require_exact(data)
        if self.dense_input:
            from har_tpu_torch.models.mllib_rf import dense_from_csr

            raw, prob, pred = self.inner.transform(dense_from_csr(design.x))
        else:
            raw, prob, pred = self.inner.transform(design.x)
        return Predictions(
            raw=raw,
            probability=prob,
            prediction=pred.astype(np.int32),
        )


@dataclasses.dataclass(frozen=True)
class CrossValidatorExact:
    """PySpark CrossValidator over the exact LR trainer, with the
    reference's MAE-evaluator quirk (SURVEY §2 N) as the default."""

    estimator: LogisticRegressionExact = LogisticRegressionExact()
    num_folds: int = 5
    metric: str = "mae"
    seed: int | None = None

    def fit(self, data: FeatureSet) -> ExactModel:
        from har_tpu_torch.tuning.mllib_cv import mllib_cross_validate

        design = require_exact(data)
        k = self.estimator.num_classes or int(design.label.max()) + 1
        result = mllib_cross_validate(
            design.x,
            design.label,
            num_folds=self.num_folds,
            seed=self.seed,
            metric=self.metric,
            max_iter=self.estimator.max_iter,
        )
        return ExactModel(
            inner=result.model,
            num_classes=k,
            best_params=result.best_params,
        )
