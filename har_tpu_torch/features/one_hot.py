"""OneHotEncoder with MLlib's dropLast semantics.

The reference's OneHotEncoderEstimator (Main/main.py:52-58) defaults to
``dropLast=true``: a column of cardinality k becomes a (k-1)-dim vector and
the last vocabulary index encodes as all-zeros.  That is what yields
934+1401+755 = 3,090 one-hot dims for the PEAK columns (SURVEY §2 F).

The encoder itself is a pure transformer parameterized by the input
cardinality; ``fit`` just reads the max index, like MLlib's estimator.
"""

from __future__ import annotations

import numpy as np

from har_tpu_torch.features.pipeline import ColumnSpace, FrameLike, as_columns


def one_hot_matrix(
    indices: np.ndarray, cardinality: int, drop_last: bool = True
) -> np.ndarray:
    width = cardinality - 1 if drop_last else cardinality
    out = np.zeros((len(indices), width), dtype=np.float32)
    valid = indices < width
    out[np.nonzero(valid)[0], indices[valid]] = 1.0
    return out


class OneHotEncoder:
    def __init__(self, input_col: str, output_col: str, drop_last: bool = True):
        self.input_col = input_col
        self.output_col = output_col
        self.drop_last = drop_last

    def fit(self, frame: FrameLike) -> "OneHotEncoderModel":
        idx = as_columns(frame)[self.input_col]
        cardinality = int(idx.max()) + 1 if len(idx) else 0
        return OneHotEncoderModel(
            self.input_col, self.output_col, cardinality, self.drop_last
        )


class OneHotEncoderModel:
    def __init__(
        self,
        input_col: str,
        output_col: str,
        cardinality: int,
        drop_last: bool = True,
    ):
        self.input_col = input_col
        self.output_col = output_col
        self.cardinality = cardinality
        self.drop_last = drop_last

    @property
    def width(self) -> int:
        return self.cardinality - 1 if self.drop_last else self.cardinality

    def transform(self, frame: FrameLike) -> ColumnSpace:
        columns = as_columns(frame)
        idx = columns[self.input_col]
        columns[self.output_col] = one_hot_matrix(
            idx, self.cardinality, self.drop_last
        )
        return columns
