"""Synthetic WISDM-like data for tests and offline development.

Generates a table with the reference's post-drop column layout (UID, 10
numeric summary features, 3 string PEAK features with '?' sentinels, and a
6-class ACTIVITY label).  Class-conditional Gaussians keep the problem learnable so
accuracy-threshold tests are meaningful without shipping the dataset.
"""

from __future__ import annotations

import numpy as np

from har_tpu_torch.data.schema import ColumnType, Schema
from har_tpu_torch.data.table import Table
from har_tpu_torch.data.wisdm import (
    ACTIVITIES,
    LABEL_COLUMN,
    WISDM_CATEGORICAL_COLUMNS,
    WISDM_NUMERIC_COLUMNS,
)


def synthetic_wisdm(
    n_rows: int = 2000,
    seed: int = 0,
    class_weights: tuple[float, ...] = (0.38, 0.30, 0.12, 0.10, 0.06, 0.04),
    peak_cardinality: int = 40,
    missing_peak_fraction: float = 0.02,
) -> Table:
    rng = np.random.default_rng((seed, 20829))
    n_classes = len(ACTIVITIES)
    labels = rng.choice(n_classes, size=n_rows, p=np.asarray(class_weights))

    # class-conditional means spread enough to be mostly separable
    means = rng.normal(0.0, 3.0, size=(n_classes, len(WISDM_NUMERIC_COLUMNS)))
    cols: dict[str, np.ndarray] = {
        "UID": np.arange(1, n_rows + 1, dtype=np.int64)
    }
    names: list[str] = ["UID"]
    types: list[ColumnType] = [ColumnType.INT]
    for j, name in enumerate(WISDM_NUMERIC_COLUMNS):
        vals = means[labels, j] + rng.normal(0.0, 1.0, size=n_rows)
        if name == "XAVG":  # all-zero int column, as in the shipped CSV
            cols[name] = np.zeros(n_rows, dtype=np.int64)
            types.append(ColumnType.INT)
        else:
            cols[name] = vals
            types.append(ColumnType.DOUBLE)
        names.append(name)
    for name in WISDM_CATEGORICAL_COLUMNS:
        # peaks correlate with the class; some rows carry the '?' sentinel
        base = rng.integers(0, peak_cardinality, size=n_rows)
        raw = (base + labels * peak_cardinality) * 25
        strs = raw.astype(str).astype(object)
        missing = rng.random(n_rows) < missing_peak_fraction
        strs[missing] = "?"
        cols[name] = strs
        names.append(name)
        types.append(ColumnType.STRING)
    cols[LABEL_COLUMN] = np.array(
        [ACTIVITIES[k] for k in labels], dtype=object
    )
    names.append(LABEL_COLUMN)
    types.append(ColumnType.STRING)
    return Table(cols, Schema(tuple(names), tuple(types)))

