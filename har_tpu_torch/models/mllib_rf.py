"""Bit-exact replay of MLlib's RandomForestClassifier (Spark 2.3).

The reference fits ``RandomForestClassifier(numTrees=100, maxDepth=4,
maxBins=32)`` (Main/main.py:478) and lands on 1027/1625 = 0.632
(result.txt RF block).  That number is fully determined by MLlib's
randomness, which this module replays stream-for-stream:

  - **seed**: pyspark's HasSeed default — the Python 2 client's
    ``hash('RandomForestClassifier')`` (``default_rf_seed``).
  - **bagging** (BaggedPoint): one Well19937c seeded with
    seed + partitionIndex + 1 (one partition → seed+1), drawing
    commons-math3 PoissonDistribution(1.0) counts rows-outer/trees-inner
    (native ``rf_poisson_weights``).
  - **feature subsets**: per considered node, in node-stack order,
    ``rng.nextLong()`` from a java.util.Random(seed) LCG seeds a Spark
    XORShiftRandom reservoir sample of ceil(sqrt(3100)) = 56 features
    (native ``reservoir_sample_range``; subset kept in reservoir order —
    split tie-breaking follows it).
  - **node processing order**: a LIFO stack seeded with the 100 roots in
    tree order (so tree 99's root draws first); every
    ``selectNodesToSplit`` group drains the whole stack (the 256 MB
    default never binds at this scale); children are pushed while
    iterating the group's per-tree map in scala immutable.HashMap trie
    order over the improved Int hash (``_scala_int_trie_order``), left
    child before right.
  - **splits**: the same MLlib findSplits midpoints the exact DT lane
    uses, here in float64; binning via binarySearch semantics.
  - **split selection**: per-node Gini gains computed in MLlib's exact
    arithmetic order (sequential 1 - Σ freq² impurity, left-assoc gain),
    ``maxBy`` keeping the first max over split index within a feature
    and subset position across features; a split is invalid when a child
    holds < minInstancesPerNode weight or gain < minInfoGain.
  - **prediction**: per-tree leaf class counts normalized then summed in
    tree order (normalized votes), probability = votes / Σ votes,
    prediction = first-argmax — RandomForestClassificationModel semantics.

All bin statistics are sums of integer-valued doubles, so they are exact
regardless of accumulation order — the replay's determinism rests wholly
on the RNG streams and the scalar arithmetic above, which is why the
heavy counting can vectorize through numpy while staying bit-faithful.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from har_tpu_torch.data.spark_random import (
    py2_string_hash,
    scala_int_trie_order as _scala_int_trie_order,
    xorshift_hash_seed,
)
from har_tpu_torch.models import _jvm_native
from har_tpu_torch.models._jvm_native import CsrMatrix

_MASK48 = (1 << 48) - 1
_DOUBLE_MIN_VALUE = -np.finfo(np.float64).max  # java Double.MinValue


def default_rf_seed() -> int:
    """The seed the reference run effectively used.

    pyspark's HasSeed mixin overrides the Scala default with
    ``hash(type(self).__name__)`` computed in the CLIENT's Python —
    under the Python 2 client that is this deterministic value, and it
    reproduces the captured RF block bit-for-bit (the Scala-side
    class-name-hash default never applies through pyspark)."""
    return py2_string_hash("RandomForestClassifier")


class JavaRandom:
    """java.util.Random's 48-bit LCG (scala.util.Random wraps it)."""

    def __init__(self, seed: int):
        self._s = (seed ^ 0x5DEECE66D) & _MASK48

    def next(self, bits: int) -> int:
        self._s = (self._s * 0x5DEECE66D + 0xB) & _MASK48
        r = self._s >> (48 - bits)
        return r - (1 << bits) if r >= (1 << (bits - 1)) else r

    def next_long(self) -> int:
        hi = self.next(32)
        lo = self.next(32)
        return (hi << 32) + lo  # both signed; matches ((long)hi << 32) + lo


def mllib_find_splits(
    x_dense: np.ndarray, max_bins: int
) -> list[np.ndarray]:
    """Per-feature float64 split thresholds (RandomForest.findSplits).

    n=3793 < max(maxBins², 10000), so Spark samples nothing; candidates
    come from the full column (midpoints of adjacent distinct values,
    stride-walked when there are more than maxBins-1 of them).
    """
    n, d = x_dense.shape
    num_splits = max_bins - 1
    out: list[np.ndarray] = []
    for j in range(d):
        vals, counts = np.unique(x_dense[:, j], return_counts=True)
        possible = len(vals) - 1
        if possible <= 0:
            out.append(np.empty(0, np.float64))
            continue
        mids = (vals[:-1] + vals[1:]) / 2.0
        if possible <= num_splits:
            out.append(mids.astype(np.float64))
            continue
        stride = float(n) / (num_splits + 1)
        chosen: list[float] = []
        current = int(counts[0])
        target = stride
        for idx in range(1, len(vals)):
            prev = current
            current += int(counts[idx])
            if abs(prev - target) < abs(current - target):
                chosen.append(float(mids[idx - 1]))
                target += stride
        out.append(np.asarray(chosen, np.float64))
    return out


def _gini_and_counts(stats: np.ndarray):
    """(impurity, weightSum, countLong) per MLlib GiniCalculator: impurity
    via the sequential 1 - Σ freq² loop, count = sum truncated to long.
    stats: (..., C) exact-integer doubles."""
    total = stats.sum(axis=-1)
    impurity = np.ones_like(total)
    safe = np.where(total > 0, total, 1.0)
    for c in range(stats.shape[-1]):
        freq = stats[..., c] / safe
        impurity = impurity - freq * freq
    impurity = np.where(total == 0.0, 0.0, impurity)
    return impurity, total


@dataclasses.dataclass
class _Node:
    id: int
    stats: np.ndarray  # (C,) weighted class counts
    is_leaf: bool = True
    feature: int = -1
    threshold: float = 0.0
    split_bin: int = -1


@dataclasses.dataclass(frozen=True)
class MLlibRFModel:
    trees: list[dict[int, _Node]]  # per tree: node id -> node
    num_classes: int

    def transform(self, x_dense: np.ndarray):
        n = x_dense.shape[0]
        k = self.num_classes
        votes = np.zeros((n, k))
        for tree in self.trees:  # _trees.foreach: tree order
            node_ids = np.ones(n, np.int64)
            # walk to leaves (raw-value comparisons, value <= threshold)
            for _ in range(32):
                active = [
                    (nid, node)
                    for nid, node in tree.items()
                    if not node.is_leaf
                ]
                moved = False
                for nid, node in active:
                    mask = node_ids == nid
                    if not mask.any():
                        continue
                    go_left = (
                        x_dense[mask, node.feature] <= node.threshold
                    )
                    ids = np.where(go_left, nid * 2, nid * 2 + 1)
                    node_ids[mask] = ids
                    moved = True
                if not moved:
                    break
            # leaf stats -> normalized vote
            for nid, node in tree.items():
                if not node.is_leaf:
                    continue
                mask = node_ids == nid
                if not mask.any():
                    continue
                total = float(node.stats.sum())
                if total != 0.0:
                    votes[mask] += node.stats / total
        raw = votes
        sums = raw.sum(axis=1, keepdims=True)
        prob = np.where(sums != 0, raw / sums, raw)
        prediction = np.argmax(prob, axis=1).astype(np.float64)
        return raw, prob, prediction


def fit_mllib_rf(
    x_dense: np.ndarray,  # (n, d) float64 raw features, train row order
    labels: np.ndarray,
    num_classes: int = 6,
    num_trees: int = 100,
    max_depth: int = 4,
    max_bins: int = 32,
    seed: int | None = None,
    min_instances_per_node: int = 1,
    min_info_gain: float = 0.0,
) -> MLlibRFModel:
    if seed is None:
        seed = default_rf_seed()
    n, d = x_dense.shape
    y = np.asarray(labels, np.int64)

    splits = mllib_find_splits(x_dense, max_bins)
    num_splits = np.array([len(s) for s in splits], np.int64)

    # TreePoint binning: binarySearch(thresholds, value) insertion point
    binned = np.zeros((n, d), np.int32)
    for j in range(d):
        if len(splits[j]):
            binned[:, j] = np.searchsorted(
                splits[j], x_dense[:, j], side="left"
            )

    # BaggedPoint: Well19937c(seed + partitionIndex + 1), one partition
    bag = _jvm_native.rf_poisson_weights(seed + 1, n, num_trees)

    feats_per_node = math.ceil(math.sqrt(d))  # "sqrt" strategy
    rng = JavaRandom(seed)

    trees: list[dict[int, _Node]] = [dict() for _ in range(num_trees)]
    assign = np.ones((num_trees, n), np.int64)
    root_counts = [
        np.array(
            [
                float(bag[:, t][y == c].sum())
                for c in range(num_classes)
            ]
        )
        for t in range(num_trees)
    ]
    for t in range(num_trees):
        trees[t][1] = _Node(id=1, stats=root_counts[t])

    # node stack: roots pushed tree 0..99 (pop order reversed)
    stack: list[tuple[int, int]] = [(t, 1) for t in range(num_trees)]

    def split_node(t: int, nid: int, subset: np.ndarray):
        node = trees[t][nid]
        mask = assign[t] == nid
        w = bag[mask, t]
        yb = y[mask]
        sub_binned = binned[np.nonzero(mask)[0][:, None], subset[None, :]]
        # (len(subset), max_bins, C) exact-integer stats
        f_count = len(subset)
        flat = (
            np.arange(f_count)[None, :] * (max_bins * num_classes)
            + sub_binned.astype(np.int64) * num_classes
            + yb[:, None]
        ).ravel()
        stats = np.bincount(
            flat,
            weights=np.repeat(w, f_count),
            minlength=f_count * max_bins * num_classes,
        ).reshape(f_count, max_bins, num_classes)

        node_total = node.stats
        parent_impurity = None
        best = None  # (gain, f_pos, split_idx, left_stats)
        for f_pos in range(f_count):
            f = int(subset[f_pos])
            ns = int(num_splits[f])
            if ns == 0:
                continue
            cum = np.cumsum(stats[f_pos], axis=0)  # exact ints
            left = cum[:ns]  # (ns, C)
            right = node_total[None, :] - left
            l_imp, l_tot = _gini_and_counts(left)
            r_imp, r_tot = _gini_and_counts(right)
            if parent_impurity is None:
                tot = left[0] + right[0]
                p_imp, p_tot = _gini_and_counts(tot)
                parent_impurity = float(p_imp)
                total_count = float(p_tot)
            l_cnt = l_tot.astype(np.int64)  # count truncates to long
            r_cnt = r_tot.astype(np.int64)
            l_w = l_cnt / total_count
            r_w = r_cnt / total_count
            gain = (parent_impurity - l_w * l_imp) - r_w * r_imp
            invalid = (
                (l_cnt < min_instances_per_node)
                | (r_cnt < min_instances_per_node)
                | (gain < min_info_gain)
            )
            gain = np.where(invalid, _DOUBLE_MIN_VALUE, gain)
            s_idx = int(np.argmax(gain))  # first max within the feature
            g = float(gain[s_idx])
            if best is None or g > best[0]:  # first max across subset
                best = (g, f_pos, s_idx, left[s_idx].copy(),
                        l_imp[s_idx], r_imp[s_idx])

        level = nid.bit_length() - 1  # indexToLevel
        is_leaf = best is None or best[0] <= 0 or level == max_depth
        if is_leaf:
            node.is_leaf = True
            return
        g, f_pos, s_idx, left_stats, l_imp_v, r_imp_v = best
        f = int(subset[f_pos])
        node.is_leaf = False
        node.feature = f
        node.threshold = float(splits[f][s_idx])
        node.split_bin = s_idx
        right_stats = node.stats - left_stats
        child_is_leaf = (level + 1) == max_depth
        left_leaf = child_is_leaf or float(l_imp_v) == 0.0
        right_leaf = child_is_leaf or float(r_imp_v) == 0.0
        trees[t][nid * 2] = _Node(id=nid * 2, stats=left_stats)
        trees[t][nid * 2 + 1] = _Node(id=nid * 2 + 1, stats=right_stats)
        rows = np.nonzero(mask)[0]
        go_left = binned[rows, f] <= s_idx
        assign[t, rows] = np.where(go_left, nid * 2, nid * 2 + 1)
        if not left_leaf:
            stack.append((t, nid * 2))
        if not right_leaf:
            stack.append((t, nid * 2 + 1))

    while stack:
        # selectNodesToSplit: drain the stack (memory budget never binds),
        # drawing the feature-subset seed per considered node in pop order
        group: list[tuple[int, int, np.ndarray]] = []
        while stack:
            t, nid = stack[-1]
            subset_seed = rng.next_long()
            subset = _jvm_native.reservoir_sample_range(
                xorshift_hash_seed(subset_seed), d, feats_per_node
            )
            stack.pop()
            group.append((t, nid, subset))
        # findBestSplits iterates the per-tree immutable map in scala
        # trie order; per tree, nodes in pop (insertion) order
        by_tree: dict[int, list[tuple[int, np.ndarray]]] = {}
        for t, nid, subset in group:
            by_tree.setdefault(t, []).append((nid, subset))
        for t in _scala_int_trie_order(by_tree.keys()):
            for nid, subset in by_tree[t]:
                split_node(t, nid, subset)

    return MLlibRFModel(trees=trees, num_classes=num_classes)


def dense_from_csr(x: CsrMatrix) -> np.ndarray:
    out = np.zeros((x.n_rows, x.n_cols), np.float64)
    for r in range(x.n_rows):
        lo, hi = int(x.indptr[r]), int(x.indptr[r + 1])
        out[r, x.indices[lo:hi]] = x.values[lo:hi]
    return out
