"""Seeded random train/test split.

The reference uses ``df.randomSplit([0.7, 0.3], seed=2018)`` (reference
Main/main.py:80), which is per-row Bernoulli sampling — split sizes are
random around the requested fractions (3,793/1,625 in the captured run).  We
keep the same semantics (per-row uniform draw against cumulative fraction
boundaries, deterministic under a seed) rather than exact-count slicing, so
behavior under resampling matches Spark's.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from har_tpu_torch.data.table import Table


def split_indices(
    n: int, fractions: Sequence[float], seed: int
) -> list[np.ndarray]:
    fracs = np.asarray(fractions, dtype=np.float64)
    if np.any(fracs < 0):
        raise ValueError("fractions must be non-negative")
    bounds = np.cumsum(fracs / fracs.sum())
    draws = np.random.default_rng(seed).random(n)
    out = []
    lo = 0.0
    for hi in bounds:
        out.append(np.nonzero((draws >= lo) & (draws < hi))[0])
        lo = hi
    # rows drawing exactly 1.0 cannot occur ([0,1) support), so partitions
    # are exhaustive and disjoint.
    return out


def random_split(
    table: Table, fractions: Sequence[float], seed: int
) -> list[Table]:
    return [table.take(idx) for idx in split_indices(len(table), fractions, seed)]
