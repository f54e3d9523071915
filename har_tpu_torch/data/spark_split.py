"""Row-exact replica of the reference's ``randomSplit`` on the WISDM table.

The reference splits the pipeline-transformed dataframe 70/30 with seed 2018
(reference Main/main.py:80) and lands on 3,793 train / 1,625 test rows
(result.txt:105-106).  Spark's ``Dataset.randomSplit`` first sorts every
partition by all orderable output columns to make sampling deterministic —
and in Spark 2.3/2.4 the assembled ``features`` VectorUDT *is* orderable,
comparing as its sqlType struct ``(type, size, indices[], values[])``.  The
effective sort is therefore::

    (label, sparse-vector indices lexicographic, values lexicographic,
     UID, XAVG..RESULTANT, XPEAK..ZPEAK, ACTIVITY)

after which one XORShiftRandom double per row buckets it (train iff
``x < 0.7``).  The captured run used a single partition.  All of this is
reproduced here and validated row-for-row against result.txt (the ten
shown sample UIDs and every prediction-sample UID land in the right
partition).

The split is a property of the *rows*, so every feature view (one-hot,
numeric, GBDT's binned view) shares the membership this module computes.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Sequence

import numpy as np

from har_tpu_torch.data.spark_random import bernoulli_draws, scala_hashmap_key
from har_tpu_torch.data.table import Table
from har_tpu_torch.data.wisdm import (
    LABEL_COLUMN,
    WISDM_CATEGORICAL_COLUMNS,
    WISDM_NUMERIC_COLUMNS,
)


def mllib_vocab(values: Sequence[str]) -> dict[str, int]:
    """value -> StringIndexer index, bit-faithful to MLlib.

    MLlib sorts ``countByValue().toSeq`` stably by descending count; equal
    counts keep the scala ``immutable.HashMap`` trie iteration order, which
    :func:`scala_hashmap_key` reproduces from the Java string hash.
    """
    counts = Counter(values)
    keys = sorted(counts, key=scala_hashmap_key)
    keys.sort(key=lambda v: -counts[v])
    return {v: i for i, v in enumerate(keys)}


@dataclasses.dataclass(frozen=True)
class AssembledRows:
    """The pipeline-transformed frame exactly as MLlib sees it: per-row
    sparse (indices, values) in float64 (VectorAssembler drops explicit
    zeros, actives ascending), the indexed label, and UID — the inputs
    both the split replay and the bit-exact model replays consume."""

    sparse: list[tuple[tuple[int, ...], tuple[float, ...]]]
    label: np.ndarray  # (n,) float64, StringIndexer frequency-desc ids
    uid: np.ndarray  # (n,) int64
    num_features: int
    nums: list[tuple[float, ...]]  # raw numeric column values per row
    cats: list[tuple[str, ...]]  # raw categorical strings per row
    activity: list[str]


def assemble_rows(table: Table) -> AssembledRows:
    """Reproduce the MLlib pipeline output (Main/main.py:51-73) row by row."""
    cats = [
        [str(v) for v in table[c]] for c in WISDM_CATEGORICAL_COLUMNS
    ]
    vocabs = [mllib_vocab(col) for col in cats]
    # dropLast one-hot: a value at the last index encodes as all zeros
    widths = [len(v) - 1 for v in vocabs]
    offsets = np.concatenate(([0], np.cumsum(widths)))
    numeric = [table[c].astype(np.float64) for c in WISDM_NUMERIC_COLUMNS]
    label_vocab = mllib_vocab([str(v) for v in table[LABEL_COLUMN]])
    activity = [str(v) for v in table[LABEL_COLUMN]]
    uid = (
        np.asarray(table["UID"], dtype=np.int64)
        if "UID" in table.column_names
        else np.zeros(len(table), dtype=np.int64)
    )

    base = int(offsets[-1])
    num_features = base + len(numeric)
    sparse = []
    label = np.zeros(len(table), np.float64)
    nums_out: list[tuple[float, ...]] = []
    for j in range(len(table)):
        idx: list[int] = []
        val: list[float] = []
        for k in range(len(vocabs)):
            rank = vocabs[k][cats[k][j]]
            if rank < widths[k]:
                idx.append(int(offsets[k]) + rank)
                val.append(1.0)
        nums = tuple(float(col[j]) for col in numeric)
        for k, v in enumerate(nums):
            if v != 0.0:
                idx.append(base + k)
                val.append(v)
        sparse.append((tuple(idx), tuple(val)))
        label[j] = float(label_vocab[activity[j]])
        nums_out.append(nums)
    return AssembledRows(
        sparse=sparse,
        label=label,
        uid=uid,
        num_features=num_features,
        nums=nums_out,
        cats=[
            tuple(cats[k][j] for k in range(len(cats)))
            for j in range(len(table))
        ],
        activity=activity,
    )


def spark_sort_order(
    table: Table, rows: AssembledRows | None = None
) -> np.ndarray:
    """Original-row indices in the pre-sampling sorted-stream order.

    Pass a precomputed ``assemble_rows(table)`` to avoid re-running the
    pure-Python assembly when the caller already has one."""
    if rows is None:
        rows = assemble_rows(table)

    keys = []
    for j in range(len(rows.sparse)):
        idx, val = rows.sparse[j]
        keys.append(
            (
                rows.label[j],
                idx,
                val,
                rows.uid[j],
                *rows.nums[j],
                *rows.cats[j],
                rows.activity[j],
            )
        )
    return np.asarray(
        sorted(range(len(keys)), key=keys.__getitem__), dtype=np.int64
    )


def spark_split_indices(
    table: Table,
    fractions: Sequence[float],
    seed: int,
    rows: AssembledRows | None = None,
) -> list[np.ndarray]:
    """Split row indices exactly as the reference's randomSplit would.

    Returned index arrays are in sampled-stream (sorted) order, matching
    the row order Spark's train/test dataframes iterate in — so
    ``show(5)``-style report samples line up with result.txt too.
    """
    order = spark_sort_order(table, rows)
    draws = bernoulli_draws(len(order), seed)
    fracs = np.asarray(fractions, dtype=np.float64)
    if np.any(fracs < 0):
        raise ValueError("fractions must be non-negative")
    bounds = np.cumsum(fracs / fracs.sum())
    out = []
    lo = 0.0
    for hi in bounds:
        out.append(order[(draws >= lo) & (draws < hi)])
        lo = hi
    return out
