"""WISDM v1.1 transformed-dataset adapter.

The dataset is 5,418 ten-second windows × 46 columns, 6 activity classes
(reference Main/wisdm_main_ver_0.0/data/wisdm_data.csv; SURVEY §2 S).  The
reference drops ``USER`` and the 30 histogram-bin columns ``X0..Z9``
(reference Main/main.py:22-26), keeping 15 columns: UID, 10 numeric summary
features, 3 string PEAK features, and the ACTIVITY label.
"""

from __future__ import annotations

import numpy as np

from har_tpu_torch.data.csv_loader import read_csv
from har_tpu_torch.data.table import Table

BINNED_COLUMNS = tuple(
    f"{axis}{i}" for axis in ("X", "Y", "Z") for i in range(10)
)

# Numeric feature columns assembled by the reference (Main/main.py:63-66):
# 3,090 one-hot dims + these 10 = the 3,100-dim vectors in result.txt.
# XAVG is all-zero in the shipped CSV but is still assembled.
WISDM_NUMERIC_COLUMNS = (
    "XAVG",
    "YAVG",
    "ZAVG",
    "XABSDEV",
    "YABSDEV",
    "ZABSDEV",
    "XSTDDEV",
    "YSTDDEV",
    "ZSTDDEV",
    "RESULTANT",
)

# Time-between-peaks columns; contain '?' sentinels so they infer as strings
# and are one-hot encoded (reference Main/main.py:51-58).
WISDM_CATEGORICAL_COLUMNS = ("XPEAK", "YPEAK", "ZPEAK")

LABEL_COLUMN = "ACTIVITY"

ACTIVITIES = (
    "Walking",
    "Jogging",
    "Upstairs",
    "Downstairs",
    "Sitting",
    "Standing",
)


def load_wisdm(
    path: str, drop_binned: bool = True, drop_user: bool = True
) -> Table:
    table = read_csv(path)
    drops: list[str] = []
    if drop_user:
        drops.append("USER")
    if drop_binned:
        drops.extend(BINNED_COLUMNS)
    return table.drop(drops) if drops else table



def numeric_feature_view(
    table: Table,
    include_binned: bool = False,
    missing_value: float = -1.0,
) -> tuple[np.ndarray, tuple[str, ...]]:
    """The *numeric* reading of the WISDM features: the 10 numeric columns,
    then the PEAK columns parsed as floats ('?' and '' →
    ``missing_value``) instead of one-hot categories, then, with
    ``include_binned``, the 30 histogram-bin columns.  (n, 13) or (n, 43)
    float32, and the column names."""
    names: list[str] = list(WISDM_NUMERIC_COLUMNS)
    cols = [np.asarray(table[c], np.float64) for c in WISDM_NUMERIC_COLUMNS]
    for c in WISDM_CATEGORICAL_COLUMNS:
        vals = np.array(
            [float(v) if v not in ("?", "") else missing_value for v in table[c]],
            np.float64,
        )
        cols.append(vals)
        names.append(c)
    if include_binned:
        for c in BINNED_COLUMNS:
            cols.append(np.asarray(table[c], np.float64))
            names.append(c)
    return np.stack(cols, axis=1).astype(np.float32), tuple(names)
