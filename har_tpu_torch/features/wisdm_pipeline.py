"""The WISDM feature pipeline, assembled like the reference's.

Reference Main/main.py:51-73: for each PEAK column a StringIndexer +
OneHotEncoder, a label StringIndexer for ACTIVITY, then a VectorAssembler
over the three one-hot vectors plus the 10 numeric columns.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from har_tpu_torch.data.table import Table
from har_tpu_torch.features.assembler import VectorAssembler
from har_tpu_torch.features.one_hot import OneHotEncoder
from har_tpu_torch.features.pipeline import ColumnSpace, Pipeline, PipelineModel
from har_tpu_torch.features.string_indexer import StringIndexer
from har_tpu_torch.data.wisdm import (
    LABEL_COLUMN,
    WISDM_CATEGORICAL_COLUMNS,
    WISDM_NUMERIC_COLUMNS,
)


@dataclasses.dataclass(frozen=True)
class FeatureSet:
    """Host arrays produced by the pipeline; estimators move them to
    their device."""

    features: np.ndarray  # (n, d) float32
    label: np.ndarray  # (n,) int32
    uid: np.ndarray | None = None
    # label id -> display name, from the SAME indexer fit that produced
    # `label` (so reports can never mislabel classes); None when the
    # source has no name vocabulary
    class_names: tuple[str, ...] | None = None
    # original-table row indices this set was carved from (set by the
    # split paths, in sampled-stream order) — lets the report render the
    # reference's train/test show(5) tables; None once re-indexed
    rows: np.ndarray | None = None
    # float64 sparse design for the bit-exact MLlib replay estimators
    # (models/mllib_exact.py), attached by the spark-exact split
    exact: object | None = None

    def __len__(self) -> int:
        return len(self.features)

    @property
    def num_features(self) -> int:
        return self.features.shape[1]

    def take(self, indices: np.ndarray) -> "FeatureSet":
        return FeatureSet(
            features=self.features[indices],
            label=self.label[indices],
            uid=None if self.uid is None else self.uid[indices],
            class_names=self.class_names,
        )

    def split(self, fractions, seed: int) -> list["FeatureSet"]:
        from har_tpu_torch.data.split import split_indices

        return [
            dataclasses.replace(self.take(idx), rows=idx)
            for idx in split_indices(len(self), fractions, seed)
        ]

    def train_test(
        self, train_fraction: float, seed: int
    ) -> tuple["FeatureSet", "FeatureSet"]:
        """Bernoulli train/test split.  Tabular-WISDM paths must go
        through runner.derive_split instead (which routes to the
        spark-exact replay per DataConfig.split_method and falls back
        here) — every evaluation path sharing one derivation is what
        keeps scoring on the same held-out rows."""
        train, test = self.split(
            [train_fraction, 1.0 - train_fraction], seed=seed
        )
        return train, test


def build_wisdm_pipeline(
    categorical: tuple[str, ...] = WISDM_CATEGORICAL_COLUMNS,
    numeric: tuple[str, ...] = WISDM_NUMERIC_COLUMNS,
    label: str = LABEL_COLUMN,
) -> Pipeline:
    stages: list = []
    assembled: list[str] = []
    for col in categorical:
        # spark_hash tie-break: equal-count vocabulary entries keep
        # MLlib's order, so one-hot indices equal the reference's
        # feature vectors bit-for-bit (result.txt:110-137)
        stages.append(
            StringIndexer(
                col, f"{col}_index",
                handle_invalid="keep", tie_break="spark_hash",
            )
        )
        stages.append(OneHotEncoder(f"{col}_index", f"{col}_vec"))
        assembled.append(f"{col}_vec")
    stages.append(StringIndexer(label, "label"))
    stages.append(VectorAssembler(assembled + list(numeric), "features"))
    return Pipeline(stages)


def make_feature_set(
    columns: ColumnSpace, class_names: tuple[str, ...] | None = None
) -> FeatureSet:
    return FeatureSet(
        features=np.ascontiguousarray(columns["features"], dtype=np.float32),
        label=columns["label"].astype(np.int32),
        uid=columns.get("UID"),
        class_names=class_names,
    )


def fit_transform(
    pipeline: Pipeline, train: Table, *others: Table
) -> tuple[PipelineModel, list[FeatureSet]]:
    """Fit on `train`, transform train + others (reference fits the pipeline
    on the full df before splitting — Main/main.py:68-80; callers choose)."""
    model = pipeline.fit(train)
    sets = [make_feature_set(model.transform(t)) for t in (train, *others)]
    return model, sets
