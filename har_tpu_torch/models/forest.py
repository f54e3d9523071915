"""Random forest: histogram trees grown in chunks with bootstrap weights.

Port of ``har_tpu/models/forest.py`` (reference Main/main.py:478 —
numTrees=100, maxDepth=4, maxBins=32).  Every tree is the same level-wise
histogram grower (:func:`har_tpu_torch.models.tree._grow_tree`), fed a
chunk of ``TREE_BATCH`` trees at once, so each level of a chunk is one
histogram kernel launch; the binning pass is shared by all trees.

Bootstrap: Poisson(1) per-row counts used as sample weights (MLlib's
BaggedPoint does the same).  Feature subsets: √d features per node (MLlib
featureSubsetStrategy="auto" for classification), the ones with the
smallest uniform scores.  Both draws come from one CPU ``torch.Generator``
seeded with ``seed``, so a forest is the same on every device; they are not
the JAX package's draws (``jax.random`` cannot be reproduced), and tests
that compare tree for tree pass that package's draws to
:meth:`RandomForestClassifier.fit`.  Prediction averages per-tree leaf class distributions
(MLlib's normalized-vote rawPrediction).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from har_tpu_torch.device import resolve_device
from har_tpu_torch.features.wisdm_pipeline import FeatureSet
from har_tpu_torch.models.base import Predictions
from har_tpu_torch.models.tree import _grow_tree, tree_inputs, walk_trees

# trees grown together, one histogram launch per level: the JAX package's
# lax.map batch (har_tpu/models/forest.py:88-95)
TREE_BATCH = 8


def grow_forest(
    bins: torch.Tensor,  # (n, d) int32
    thresholds: torch.Tensor,  # (d, B-1) f32
    y: torch.Tensor,  # (n,) int64
    boot: torch.Tensor,  # (num_trees, n) f32 bootstrap counts
    feature_scores: torch.Tensor | None,  # (depth, num_trees, W, d) or None
    num_classes: int,
    max_depth: int,
    max_bins: int,
    min_instances: int,
    features_per_split: int,
):
    """Grow ``len(boot)`` trees, ``TREE_BATCH`` at a time; returns
    (feature, threshold, leaf_class, leaf_probs, node_counts) stacked over
    all trees."""
    num_trees = boot.shape[0]
    chunks = []
    for t0 in range(0, num_trees, TREE_BATCH):
        t1 = min(num_trees, t0 + TREE_BATCH)
        chunks.append(
            _grow_tree(
                bins,
                thresholds,
                y,
                boot[t0:t1],
                None if feature_scores is None else feature_scores[:, t0:t1],
                num_classes=num_classes,
                max_depth=max_depth,
                max_bins=max_bins,
                min_instances=min_instances,
                features_per_split=features_per_split,
            )
        )
    return tuple(torch.cat(parts) for parts in zip(*chunks))


@dataclasses.dataclass(frozen=True)
class RandomForestClassifier:
    """Reference defaults: numTrees=100, maxDepth=4, maxBins=32
    (Main/main.py:478)."""

    num_trees: int = 100
    max_depth: int = 4
    max_bins: int = 32
    min_instances_per_node: int = 1
    feature_subset: str | int = "auto"
    # an arbitrary fixed default, as the JAX package's
    seed: int = 3
    num_classes: int | None = None
    # mllib: exact MLlib split-candidate set (parity default);
    # quantile: evenly spaced quantiles
    split_candidates: str = "mllib"
    device: str = "cuda"

    def copy_with(self, **params) -> "RandomForestClassifier":
        return dataclasses.replace(self, **params)

    def _features_per_split(self, d: int) -> int:
        if isinstance(self.feature_subset, int):
            return min(self.feature_subset, d)
        if self.feature_subset in ("auto", "sqrt"):
            # MLlib "auto" for classification = sqrt, rounded UP
            return max(1, math.ceil(math.sqrt(d)))
        if self.feature_subset == "all":
            return 0
        if self.feature_subset == "onethird":
            return max(1, d // 3)
        raise ValueError(f"unknown feature_subset {self.feature_subset!r}")

    def draws(self, n: int, d: int) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(bootstrap counts (num_trees, n), feature scores
        (depth, num_trees, W, d) or None) from the seeded CPU generator."""
        gen = torch.Generator().manual_seed(self.seed)
        boot = torch.poisson(torch.ones((self.num_trees, n)), generator=gen)
        if not self._features_per_split(d):
            return boot, None
        width = 2**self.max_depth
        scores = torch.rand(
            (self.max_depth, self.num_trees, width, d), generator=gen
        )
        return boot, scores

    def fit(
        self,
        data: FeatureSet,
        boot: torch.Tensor | None = None,
        feature_scores: torch.Tensor | None = None,
    ) -> "RandomForestModel":
        """Fit on ``data``; ``boot``/``feature_scores`` replace the seeded
        draws (both or neither)."""
        device = resolve_device(self.device)
        x, y, thresholds, bins = tree_inputs(data, self.max_bins, device, self.split_candidates)
        num_classes = self.num_classes or int(data.label.max()) + 1
        fps = self._features_per_split(x.shape[1])
        if boot is None:
            boot, feature_scores = self.draws(len(y), x.shape[1])
        feature, threshold, _, leaf_probs, _ = grow_forest(
            bins,
            thresholds,
            y,
            boot.to(device, torch.float32),
            None if feature_scores is None else feature_scores.to(device),
            num_classes=num_classes,
            max_depth=self.max_depth,
            max_bins=self.max_bins,
            min_instances=self.min_instances_per_node,
            features_per_split=fps,
        )
        return RandomForestModel(
            feature=feature.cpu().numpy(),
            threshold=threshold.cpu().numpy(),
            leaf_probs=leaf_probs.cpu().numpy(),
            max_depth=self.max_depth,
            num_classes=num_classes,
            device=self.device,
        )


@dataclasses.dataclass(frozen=True)
class RandomForestModel:
    feature: np.ndarray  # (T, nodes)
    threshold: np.ndarray  # (T, nodes)
    leaf_probs: np.ndarray  # (T, nodes, C)
    max_depth: int
    num_classes: int
    device: str = "cuda"

    @property
    def num_trees(self) -> int:
        return len(self.feature)

    def transform(self, data: FeatureSet) -> Predictions:
        device = resolve_device(self.device)
        node = walk_trees(
            torch.as_tensor(self.feature).to(device),
            torch.as_tensor(self.threshold).to(device),
            torch.as_tensor(data.features, dtype=torch.float32).to(device),
            self.max_depth,
        )  # (T, n)
        leaf_probs = torch.as_tensor(self.leaf_probs).to(device)
        trees = torch.arange(len(node), device=device)[:, None]
        probs = leaf_probs[trees, node].mean(dim=0).cpu().numpy()  # (n, C)
        return Predictions.from_raw(probs, probs)
