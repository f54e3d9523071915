"""Carry fitted models across from the JAX package's arrays.

A logistic regression, decision tree or forest fitted by ``har_tpu`` is
plain numpy arrays (``LogisticRegressionModel``, ``TreeArrays`` and
``RandomForestModel`` fields), as are its bit-exact MLlib replays
(``MLlibLRModel``'s fields and each ``MLlibRFModel`` node's), and a flax
transformer's parameters are a tree of arrays; these functions build the port's models
(or their state_dict) from them, so the same fitted state predicts on
either package.  They take arrays, not ``har_tpu`` objects: the port never
imports the JAX package.  The arrays are copied (JAX hands out read-only
views).
"""

from __future__ import annotations

import numpy as np
import torch

from har_tpu_torch.models.forest import RandomForestModel
from har_tpu_torch.models.logistic_regression import LogisticRegressionModel
from har_tpu_torch.models.mllib_exact import ExactModel
from har_tpu_torch.models.mllib_lr import MLlibLRModel
from har_tpu_torch.models.mllib_rf import MLlibRFModel, _Node
from har_tpu_torch.models.tree import DecisionTreeModel, TreeArrays


def logistic_regression_from_arrays(
    coefficients, intercept, num_classes: int, device: str = "cuda"
) -> LogisticRegressionModel:
    """A LogisticRegressionModel from (d, C) coefficients and (C,)
    intercepts in the unscaled feature space."""
    return LogisticRegressionModel(
        coefficients=np.array(coefficients, np.float32),
        intercept=np.array(intercept, np.float32),
        num_classes=int(num_classes),
        device=str(device),
    )


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


def mllib_lr_from_arrays(
    coefficient_matrix, intercepts, objective_history=()
) -> ExactModel:
    """The exact LR replay's model from its (k, d) original-space
    coefficients and (k,) intercepts, float64 and unrounded."""
    coef = np.array(coefficient_matrix, np.float64)
    inner = MLlibLRModel(
        coefficient_matrix=coef,
        intercepts=np.array(intercepts, np.float64),
        objective_history=tuple(float(v) for v in objective_history),
    )
    return ExactModel(inner=inner, num_classes=coef.shape[0])


# the fields of one node of an MLlib RF tree, in _Node's order
MLLIB_NODE_FIELDS = ("id", "is_leaf", "feature", "threshold", "split_bin", "stats")


def mllib_rf_from_arrays(trees, num_classes: int) -> ExactModel:
    """The exact RF replay's model from per-tree node arrays: each tree a
    mapping of ``MLLIB_NODE_FIELDS`` to (nodes,) arrays (``stats``
    (nodes, C) weighted class counts), in the tree's node order."""
    port_trees = []
    for tree in trees:
        cols = {f: np.asarray(tree[f]) for f in MLLIB_NODE_FIELDS}
        port_trees.append({
            int(cols["id"][i]): _Node(
                id=int(cols["id"][i]),
                stats=np.array(cols["stats"][i], np.float64),
                is_leaf=bool(cols["is_leaf"][i]),
                feature=int(cols["feature"][i]),
                threshold=float(cols["threshold"][i]),
                split_bin=int(cols["split_bin"][i]),
            )
            for i in range(len(cols["id"]))
        })
    inner = MLlibRFModel(trees=port_trees, num_classes=int(num_classes))
    return ExactModel(inner=inner, num_classes=int(num_classes), dense_input=True)


# flax submodule of an EncoderBlock -> the port's EncoderBlock attribute
_BLOCK_NAMES = {
    "LayerNorm_0": "norm1",
    "qkv": "qkv",
    "proj": "proj",
    "LayerNorm_1": "norm2",
    "Dense_0": "mlp_in",
    "Dense_1": "mlp_out",
}


def _leaf(x) -> np.ndarray:
    return np.array(x, np.float32)


def _dense(prefix: str, leaf, out: dict) -> None:
    """flax Dense kernel (in, out) -> torch weight (out, in)."""
    out[f"{prefix}.weight"] = _leaf(leaf["kernel"]).T
    out[f"{prefix}.bias"] = _leaf(leaf["bias"])


def _norm(prefix: str, leaf, out: dict) -> None:
    out[f"{prefix}.weight"] = _leaf(leaf["scale"])
    out[f"{prefix}.bias"] = _leaf(leaf["bias"])


def transformer_params_from_flax(params) -> dict:
    """The port's ``Transformer1D`` state_dict from a flax
    ``Transformer1D`` parameter tree (nested dicts of arrays), in the
    unrolled (``EncoderBlock_<i>``) or the ``scan_layers`` layout
    (``blocks/EncoderBlock_0`` with a leading layer axis).  A patch
    embedding's conv kernel (patch, in, out) becomes the port's
    (out, patch·in) matmul weight."""
    out: dict = {}
    if "patch_embed" in params:
        kernel = _leaf(params["patch_embed"]["kernel"])
        out["patch_embed.weight"] = kernel.reshape(-1, kernel.shape[-1]).T
        out["patch_embed.bias"] = _leaf(params["patch_embed"]["bias"])
    else:
        _dense("embed", params["embed"], out)
    if "blocks" in params:
        stacked = params["blocks"]["EncoderBlock_0"]
        layers = len(stacked["qkv"]["kernel"])
        blocks = [
            {
                name: {key: np.asarray(val)[i] for key, val in leaf.items()}
                for name, leaf in stacked.items()
            }
            for i in range(layers)
        ]
    else:
        blocks = []
        while f"EncoderBlock_{len(blocks)}" in params:
            blocks.append(params[f"EncoderBlock_{len(blocks)}"])
    for i, block in enumerate(blocks):
        for flax_name, port_name in _BLOCK_NAMES.items():
            convert = _norm if flax_name.startswith("LayerNorm") else _dense
            convert(f"blocks.{i}.{port_name}", block[flax_name], out)
    _norm("norm", params["LayerNorm_0"], out)
    _dense("head", params["head"], out)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}
