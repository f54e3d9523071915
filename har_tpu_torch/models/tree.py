"""Histogram-based decision trees on tensors.

Port of ``har_tpu/models/tree.py`` (reference Main/main.py:297 —
DecisionTreeClassifier(maxDepth=3)).  The algorithm is the JAX package's,
step for step, so a tree grown here equals the reference's bit for bit:

  - **Binning**: MLlib's split candidates per feature (≤ max_bins-1
    thresholds), features quantized once to int32 bin ids.
  - **Level-wise growth**: one class histogram per level, for every live
    (node, feature, bin), from the hand-written row-sparse CUDA kernel
    (:func:`har_tpu_torch.ops.hist.hist_rows`).
  - **Split selection**: cumulative sums over the bin axis give left/right
    class counts for every candidate split; weighted Gini gain, argmax over
    (feature, bin).  Nodes that shouldn't split (pure / too small / no
    gain) keep their rows where they are.
  - The tree is a complete binary array of depth ``max_depth``:
    feature[node], threshold[node], class counts per node.

The grower takes a leading tree axis (weights ``(T, n)``), so a random
forest grows a chunk of trees with one histogram launch per level.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from har_tpu_torch.device import resolve_device
from har_tpu_torch.features.wisdm_pipeline import FeatureSet
from har_tpu_torch.models.base import Predictions
from har_tpu_torch.ops import hist as hist_ops


def mllib_split_candidates(x: np.ndarray, max_bins: int) -> np.ndarray:
    """(d, max_bins-1) thresholds, faithful to MLlib's findSplits.

    Spark's ``RandomForest.findSplitsForContinuousFeature``: when a feature
    has ``<= max_bins`` distinct values the candidates are the midpoints
    between every pair of adjacent distinct values (exact for the one-hot
    dims — a single 0.5 threshold); otherwise a stride walk over the
    distinct-value histogram places ``max_bins - 1`` thresholds at
    (approximately) equal-count boundaries, each again a midpoint of
    adjacent distinct values.

    Spark computes candidates on a SAMPLE when n > max(maxBins², 10000);
    WISDM's 3,793 training rows are below that, so this unsampled walk is
    exact there.

    Unused candidate slots are padded with ``+inf``: their "splits" route
    every row left and are rejected by the min-instances guard.
    """
    x = np.asarray(x, np.float64)
    n, d = x.shape
    num_splits = max_bins - 1
    out = np.full((d, num_splits), np.inf, np.float64)
    # vectorized fast path: {0,1}-valued columns (the one-hot block)
    is01 = ((x == 0.0) | (x == 1.0)).all(axis=0)
    binary = is01 & (x == 0.0).any(axis=0) & (x == 1.0).any(axis=0)
    out[binary, 0] = 0.5
    for j in np.nonzero(~binary)[0]:
        vals, counts = np.unique(x[:, j], return_counts=True)
        possible = len(vals) - 1
        if possible == 0:
            continue  # constant feature: no candidates
        mids = (vals[:-1] + vals[1:]) / 2.0
        if possible <= num_splits:
            out[j, :possible] = mids
            continue
        stride = n / (num_splits + 1)
        chosen: list[float] = []
        current = int(counts[0])
        target = stride
        for idx in range(1, len(vals)):
            prev = current
            current += int(counts[idx])
            if abs(prev - target) < abs(current - target):
                chosen.append(mids[idx - 1])
                target += stride
        out[j, : len(chosen)] = chosen[:num_splits]
    return out.astype(np.float32)


def quantile_thresholds(x: torch.Tensor, max_bins: int) -> torch.Tensor:
    """(d, max_bins-1) per-feature thresholds: evenly spaced quantiles of
    each feature, ``jnp.quantile``'s linear method in float32 step for
    step, so the thresholds and the bins they give equal the JAX
    package's: q = i · (1/B), position q·(n-1), and the neighbours lo and
    hi combined as XLA's CPU compiles ``lo·(1-w) + hi·w``, one fused
    multiply-add over the rounded ``hi·w`` (taken here in float64, where
    the product is exact).  A feature holding a NaN gets NaN
    thresholds."""
    n = x.shape[0]
    x = x.to(torch.float32)
    # jnp.linspace's i / B, which XLA computes as i · (1 / B)
    step = torch.tensor(1.0, dtype=torch.float32) / max_bins
    q = torch.arange(1, max_bins, dtype=torch.float32, device=x.device) * step.to(
        x.device
    ) * torch.tensor(n - 1, dtype=torch.float32)
    low, high = torch.floor(q), torch.ceil(q)
    high_weight = q - low
    low_weight = 1.0 - high_weight
    last = float(n - 1)
    low_idx = low.clamp(0.0, last).long()
    high_idx = high.clamp(0.0, last).long()
    s = torch.sort(x, dim=0).values
    s = torch.where(torch.isnan(x).any(dim=0), torch.nan, s)
    high_part = (s[high_idx] * high_weight[:, None]).double()
    out = s[low_idx].double() * low_weight.double()[:, None] + high_part
    return out.float().T.contiguous()


def binize(x: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """Quantize features: bin id = number of thresholds strictly below x.

    x (n, d) f32, thresholds (d, B-1) ascending → (n, d) int32.
    """
    return (
        torch.searchsorted(thresholds, x.T.contiguous(), right=False)
        .T.to(torch.int32)
        .contiguous()
    )


@dataclasses.dataclass(frozen=True)
class TreeArrays:
    """A complete binary tree of depth D as arrays of length 2^(D+1)-1."""

    feature: np.ndarray  # int32, -1 for leaves
    threshold: np.ndarray  # float32 split threshold (x <= t goes left)
    leaf_class: np.ndarray  # int32 argmax class at the node
    leaf_probs: np.ndarray  # (nodes, C) class distribution at the node
    max_depth: int
    # (nodes, C) raw class COUNTS — MLlib's rawPrediction column is the
    # leaf's impurity stats, and the Binary evaluator ranks by it
    leaf_counts: np.ndarray | None = None


def _gini(counts: torch.Tensor) -> torch.Tensor:
    """Weighted Gini impurity × total weight over the last (class) axis:
    total - Σ c²/total, the formulation that makes gain additive."""
    total = counts.sum(-1)
    sq = (counts * counts).sum(-1)
    return total - sq / torch.clamp(total, min=1e-12)


def _grow_tree(
    bins: torch.Tensor,  # (n, d) int32 bin ids
    thresholds: torch.Tensor,  # (d, B-1) f32
    y: torch.Tensor,  # (n,) int64
    weights: torch.Tensor,  # (T, n) f32 (0 = row not in that tree)
    feature_scores: torch.Tensor | None,  # (depth, T, 2**depth, d) or None
    num_classes: int,
    max_depth: int,
    max_bins: int,
    min_instances: int = 1,
    features_per_split: int = 0,  # 0 → all features (DT); >0 → RF subset
):
    """Grow T trees level by level; returns per-tree (feature, threshold,
    leaf_class, leaf_probs, node_counts) with a leading T axis.

    Level L works on its live width wl = 2**L nodes, so its histogram is
    (T, wl*C, d*B).  The JAX grower works on the static width 2**max_depth
    at every level (``lax.fori_loop`` needs one shape); its slots past
    2**L hold no rows and split nothing, so the trees are the same.  With
    ``features_per_split`` each (tree, level, node) keeps the features
    whose score is among the ``features_per_split`` smallest of its row of
    ``feature_scores``: slot s is row s, as in the JAX draw.
    """
    device = bins.device
    trees, n = weights.shape
    d = bins.shape[1]
    classes = num_classes
    n_nodes = 2 ** (max_depth + 1) - 1

    feature = torch.full((trees, n_nodes), -1, dtype=torch.int32, device=device)
    threshold = torch.zeros((trees, n_nodes), dtype=torch.float32, device=device)
    node_counts = torch.zeros(
        (trees, n_nodes, classes), dtype=torch.float32, device=device
    )
    node_counts[:, 0].index_add_(1, y, weights)  # root class counts
    node_of_row = torch.zeros((trees, n), dtype=torch.int64, device=device)
    tree_idx = torch.arange(trees, device=device)[:, None]

    for level in range(max_depth):
        wl = 2**level  # live nodes at this level
        first = wl - 1
        local = node_of_row - first  # position within the level
        valid = (local >= 0) & (local < wl)
        local = local.clamp(0, wl - 1)

        # each row's weight in one (node, class) slot per tree
        slot = (local * classes + y).to(torch.int32)
        w = torch.where(valid, weights, 0.0)
        hist = hist_ops.hist_rows(bins, slot, w, wl * classes, max_bins)
        hist = hist.reshape(trees, wl, classes, d, max_bins).permute(
            0, 1, 3, 4, 2
        )  # (T, wl, d, B, C)

        # left counts for a split at bin b = Σ_{bin<=b}; the candidates
        # are the first B-1 bins (split "x <= threshold[b]")
        cum = torch.cumsum(hist, dim=3)
        left = cum[:, :, :, : max_bins - 1, :]
        total = cum[:, :, :, -1:, :]
        right = total - left
        gain = _gini(total) - _gini(left) - _gini(right)  # (T, wl, d, B-1)

        ok = (left.sum(-1) >= min_instances) & (right.sum(-1) >= min_instances)
        if features_per_split:
            scores = feature_scores[level][:, :wl]  # (T, wl, d)
            kth = torch.sort(scores, dim=-1).values[
                :, :, features_per_split - 1
            ]
            ok = ok & (scores <= kth[:, :, None])[:, :, :, None]
        gain = torch.where(ok, gain, -torch.inf)

        flat = gain.reshape(trees, wl, -1)
        best = torch.argmax(flat, dim=-1)  # first maximum, as jnp.argmax
        best_gain = torch.gather(flat, 2, best[:, :, None])[:, :, 0]
        best_feat = best // (max_bins - 1)
        best_bin = best % (max_bins - 1)
        splittable = torch.isfinite(best_gain) & (best_gain > 1e-12)

        slots = torch.arange(wl, device=device)
        node_ids = first + slots  # internal nodes: level < max_depth
        feat_upd = torch.where(splittable, best_feat, -1)
        thr_upd = thresholds[best_feat, best_bin]  # (T, wl)
        feature[:, node_ids] = feat_upd.to(torch.int32)
        threshold[:, node_ids] = torch.where(splittable, thr_upd, 0.0)

        # children class counts: the children of level L < max_depth lie
        # in the array
        lcounts = left[tree_idx, slots, best_feat, best_bin]  # (T, wl, C)
        rcounts = total[:, :, 0, 0, :] - lcounts
        for child_ids, counts in (
            (2 * node_ids + 1, lcounts),
            (2 * node_ids + 2, rcounts),
        ):
            node_counts[:, child_ids] = torch.where(
                splittable[:, :, None], counts, 0.0
            )

        # route rows to children where their node split
        row_feat = torch.gather(feat_upd, 1, local)  # (T, n)
        row_bin_thr = torch.gather(best_bin, 1, local)
        row_bins = torch.gather(bins, 1, row_feat.clamp(min=0).T).T
        goes_left = row_bins <= row_bin_thr
        split_here = valid & (row_feat >= 0)
        child = 2 * node_of_row + torch.where(goes_left, 1, 2)
        node_of_row = torch.where(split_here, child, node_of_row)

    leaf_class = torch.argmax(node_counts, dim=-1).to(torch.int32)
    denom = torch.clamp(node_counts.sum(-1, keepdim=True), min=1e-12)
    leaf_probs = node_counts / denom
    return feature, threshold, leaf_class, leaf_probs, node_counts


def walk_trees(
    feature: torch.Tensor,  # (T, nodes) int32
    threshold: torch.Tensor,  # (T, nodes) f32
    x: torch.Tensor,  # (n, d) f32
    max_depth: int,
) -> torch.Tensor:
    """(T, n) leaf node id per tree and row: one step per level."""
    trees = feature.shape[0]
    n = x.shape[0]
    node = torch.zeros((trees, n), dtype=torch.int64, device=x.device)
    rows = torch.arange(n, device=x.device)[None, :]
    for _ in range(max_depth):
        feat = torch.gather(feature, 1, node).to(torch.int64)
        thr = torch.gather(threshold, 1, node)
        val = x[rows, feat.clamp(min=0)]
        child = 2 * node + torch.where(val <= thr, 1, 2)
        node = torch.where(feat < 0, node, child)
    return node


def tree_inputs(data: FeatureSet, max_bins: int, device: torch.device):
    """(x, y, thresholds, bins) of a training set on ``device``."""
    x = torch.as_tensor(data.features, dtype=torch.float32).to(device)
    y = torch.as_tensor(data.label, dtype=torch.int64).to(device)
    thresholds = torch.as_tensor(
        mllib_split_candidates(data.features, max_bins)
    ).to(device)
    return x, y, thresholds, binize(x, thresholds)


@dataclasses.dataclass(frozen=True)
class DecisionTreeClassifier:
    """Reference defaults: maxDepth=3 (Main/main.py:297), maxBins=32."""

    max_depth: int = 3
    max_bins: int = 32
    min_instances_per_node: int = 1
    num_classes: int | None = None
    device: str = "cuda"

    def copy_with(self, **params) -> "DecisionTreeClassifier":
        return dataclasses.replace(self, **params)

    def fit(self, data: FeatureSet) -> "DecisionTreeModel":
        device = resolve_device(self.device)
        _, y, thresholds, bins = tree_inputs(data, self.max_bins, device)
        num_classes = self.num_classes or int(data.label.max()) + 1
        w = torch.ones((1, len(y)), dtype=torch.float32, device=device)
        feature, threshold, leaf_class, leaf_probs, leaf_counts = _grow_tree(
            bins,
            thresholds,
            y,
            w,
            None,
            num_classes=num_classes,
            max_depth=self.max_depth,
            max_bins=self.max_bins,
            min_instances=self.min_instances_per_node,
        )
        return DecisionTreeModel(
            tree=TreeArrays(
                feature=feature[0].cpu().numpy(),
                threshold=threshold[0].cpu().numpy(),
                leaf_class=leaf_class[0].cpu().numpy(),
                leaf_probs=leaf_probs[0].cpu().numpy(),
                max_depth=self.max_depth,
                leaf_counts=leaf_counts[0].cpu().numpy(),
            ),
            num_classes=num_classes,
            device=self.device,
        )


@dataclasses.dataclass(frozen=True)
class DecisionTreeModel:
    tree: TreeArrays
    num_classes: int
    device: str = "cuda"

    @property
    def num_nodes(self) -> int:
        """Count of reachable decision+leaf nodes (MLlib-style numNodes)."""
        count = 0
        stack = [0]
        feature = self.tree.feature
        while stack:
            node = stack.pop()
            count += 1
            if node < len(feature) and feature[node] >= 0:
                stack.extend((2 * node + 1, 2 * node + 2))
        return count

    def transform(self, data: FeatureSet) -> Predictions:
        device = resolve_device(self.device)
        node = walk_trees(
            torch.as_tensor(self.tree.feature)[None].to(device),
            torch.as_tensor(self.tree.threshold)[None].to(device),
            torch.as_tensor(data.features, dtype=torch.float32).to(device),
            self.tree.max_depth,
        )[0].cpu().numpy()
        probs = np.asarray(self.tree.leaf_probs)[node]
        # rawPrediction = the leaf's class COUNTS (MLlib semantics: the
        # Binary evaluator ranks its threshold sweep by these)
        raw = (
            np.asarray(self.tree.leaf_counts)[node]
            if self.tree.leaf_counts is not None
            else probs
        )
        return Predictions.from_raw(raw, probs)
