"""Composable feature pipeline.

The MLlib Pipeline the reference builds (reference Main/main.py:68-73) is a
list of estimators/transformers fitted in order, each adding columns to a
DataFrame.  Here the "frame" is a plain ``dict[str, np.ndarray]`` column
space (2-D arrays represent vector columns); fitting is host-side vocabulary
building, and transformation is vectorized numpy feeding device arrays.
All per-row work that MLlib runs on JVM executors becomes array ops.
"""

from __future__ import annotations

from typing import Mapping, Protocol, Union

import numpy as np

from har_tpu_torch.data.table import Table

ColumnSpace = dict[str, np.ndarray]
FrameLike = Union[Table, Mapping[str, np.ndarray]]


def as_columns(frame: FrameLike) -> ColumnSpace:
    if isinstance(frame, Table):
        return {n: frame.column(n) for n in frame.column_names}
    return dict(frame)


class Transformer(Protocol):
    def transform(self, columns: FrameLike) -> ColumnSpace: ...


class Estimator(Protocol):
    def fit(self, columns: FrameLike) -> Transformer: ...


class Pipeline:
    """Ordered stages; estimators are fitted on the running column space."""

    def __init__(self, stages: list):
        self.stages = list(stages)

    def fit(self, frame: FrameLike) -> "PipelineModel":
        columns = as_columns(frame)
        fitted = []
        for stage in self.stages:
            if hasattr(stage, "fit"):
                model = stage.fit(columns)
            else:
                model = stage
            fitted.append(model)
            columns = model.transform(columns)
        return PipelineModel(fitted)


class PipelineModel:
    def __init__(self, stages: list):
        self.stages = list(stages)

    def transform(self, frame: FrameLike) -> ColumnSpace:
        columns = as_columns(frame)
        for stage in self.stages:
            columns = stage.transform(columns)
        return columns
