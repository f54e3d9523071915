"""VectorAssembler: concatenate vector/numeric columns into one matrix.

Replaces reference Main/main.py:63-66.  Column order is preserved, so for
WISDM the layout is [XPEAK one-hot | YPEAK one-hot | ZPEAK one-hot | 10
numeric] = 3,100 dims, matching the reference's sparse vectors.  Output is a
dense float32 matrix: at this scale a dense design matrix is both smaller
than Spark's JVM sparse rows and the layout the models take.
"""

from __future__ import annotations

import numpy as np

from har_tpu_torch.features.pipeline import ColumnSpace, FrameLike, as_columns


class VectorAssembler:
    def __init__(self, input_cols: list[str], output_col: str = "features"):
        self.input_cols = list(input_cols)
        self.output_col = output_col

    def transform(self, frame: FrameLike) -> ColumnSpace:
        columns = as_columns(frame)
        parts = []
        for name in self.input_cols:
            col = np.asarray(columns[name])
            if col.ndim == 1:
                col = col.astype(np.float32)[:, None]
            parts.append(col.astype(np.float32))
        columns[self.output_col] = np.concatenate(parts, axis=1)
        return columns
