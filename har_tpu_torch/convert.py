"""Carry fitted tree models across from the JAX package's arrays.

A decision tree or forest fitted by ``har_tpu`` is plain numpy arrays
(``TreeArrays`` and ``RandomForestModel`` fields); these functions build the
port's models from them, so the same fitted state predicts on either
package.  They take arrays, not ``har_tpu`` objects: the port never imports
the JAX package.  The arrays are copied (JAX hands out read-only views).
"""

from __future__ import annotations

import numpy as np

from har_tpu_torch.models.forest import RandomForestModel
from har_tpu_torch.models.tree import DecisionTreeModel, TreeArrays


def tree_from_arrays(
    feature, threshold, leaf_class, leaf_probs, leaf_counts, max_depth: int,
    device: str = "cuda",
) -> DecisionTreeModel:
    """A DecisionTreeModel from one tree's arrays (leaf_counts may be None)."""
    leaf_probs = np.array(leaf_probs, np.float32)
    return DecisionTreeModel(
        tree=TreeArrays(
            feature=np.array(feature, np.int32),
            threshold=np.array(threshold, np.float32),
            leaf_class=np.array(leaf_class, np.int32),
            leaf_probs=leaf_probs,
            max_depth=int(max_depth),
            leaf_counts=(
                None
                if leaf_counts is None
                else np.array(leaf_counts, np.float32)
            ),
        ),
        num_classes=leaf_probs.shape[-1],
        device=str(device),
    )


def forest_from_arrays(
    feature, threshold, leaf_probs, max_depth: int, device: str = "cuda"
) -> RandomForestModel:
    """A RandomForestModel from stacked (T, nodes[, C]) arrays."""
    leaf_probs = np.array(leaf_probs, np.float32)
    return RandomForestModel(
        feature=np.array(feature, np.int32),
        threshold=np.array(threshold, np.float32),
        leaf_probs=leaf_probs,
        max_depth=int(max_depth),
        num_classes=leaf_probs.shape[-1],
        device=str(device),
    )
