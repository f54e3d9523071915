"""Carry fitted models across from the JAX package's arrays.

A logistic regression, decision tree, forest or boosted-tree ensemble
fitted by ``har_tpu`` is plain numpy arrays (``LogisticRegressionModel``,
``TreeArrays``, ``RandomForestModel`` and ``GradientBoostedTreesModel``
fields), as are its bit-exact MLlib replays (``MLlibLRModel``'s fields and
each ``MLlibRFModel`` node's), and a flax model's parameters (transformer,
MLP, CNN1D, BiLSTM) are a tree of arrays; these functions build the port's
models (or their state_dict) from them, so the same fitted state predicts on
either package.  They take arrays, not ``har_tpu`` objects: the port never
imports the JAX package.  The arrays are copied (JAX hands out read-only
views).  The ``*_params_to_flax`` functions are the inverses: the flax
tree of a port module's parameters, which a saved neural model's
``params.npz`` holds, and ``flax_module_prefixes`` names each flax
top-level module's parameters in the port (what ``--freeze`` reads).
"""

from __future__ import annotations

import numpy as np
import torch

from har_tpu_torch.models.forest import RandomForestModel
from har_tpu_torch.models.gbdt import GradientBoostedTreesModel
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


def gbdt_from_arrays(
    feature, split_bin, leaf_value, thresholds, learning_rate: float,
    max_depth: int, num_classes: int, device: str = "cuda",
) -> GradientBoostedTreesModel:
    """A GradientBoostedTreesModel from (rounds, K, nodes) feature,
    split_bin and leaf_value arrays and the (d, B-1) thresholds."""
    return GradientBoostedTreesModel(
        feature=np.array(feature, np.int32),
        split_bin=np.array(split_bin, np.int32),
        leaf_value=np.array(leaf_value, np.float32),
        thresholds=np.array(thresholds, np.float32),
        learning_rate=float(learning_rate),
        max_depth=int(max_depth),
        num_classes=int(num_classes),
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
    return _state_dict(out)


def _state_dict(out: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def mlp_params_from_flax(params) -> dict:
    """The port's ``MLP`` state_dict from a flax ``MLP`` parameter tree:
    ``Dense_0 .. Dense_{L-1}`` are the hidden layers, the last the head."""
    count = sum(1 for key in params if key.startswith("Dense_"))
    out: dict = {}
    for i in range(count - 1):
        _dense(f"layers.{i}", params[f"Dense_{i}"], out)
    _dense("head", params[f"Dense_{count - 1}"], out)
    return _state_dict(out)


def cnn1d_params_from_flax(params) -> dict:
    """The port's ``CNN1D`` state_dict from a flax ``CNN1D`` parameter
    tree: each ``ConvBlock_i``'s conv kernel (k, in, out) becomes torch's
    (out, in, k), its ``LayerNorm_0`` or ``RMSNorm_0`` the block's norm;
    ``Dense_0`` and ``Dense_1`` are the hidden and the output layer."""
    out: dict = {}
    i = 0
    while f"ConvBlock_{i}" in params:
        block = params[f"ConvBlock_{i}"]
        out[f"blocks.{i}.weight"] = _leaf(block["Conv_0"]["kernel"]).transpose(2, 1, 0)
        out[f"blocks.{i}.bias"] = _leaf(block["Conv_0"]["bias"])
        if "LayerNorm_0" in block:
            _norm(f"blocks.{i}.norm", block["LayerNorm_0"], out)
        elif "RMSNorm_0" in block:
            out[f"blocks.{i}.norm.weight"] = _leaf(block["RMSNorm_0"]["scale"])
        i += 1
    _dense("fc", params["Dense_0"], out)
    _dense("head", params["Dense_1"], out)
    return _state_dict(out)


def bilstm_params_from_flax(params) -> dict:
    """The port's ``BiLSTM`` state_dict from a flax ``BiLSTM`` parameter
    tree: each ``FusedBiLSTMLayer_i``'s ``wx``, ``wh`` and ``bias`` keep
    their shapes; ``Dense_0`` is the head."""
    out: dict = {}
    i = 0
    while f"FusedBiLSTMLayer_{i}" in params:
        for name in ("wx", "wh", "bias"):
            out[f"layers.{i}.{name}"] = _leaf(params[f"FusedBiLSTMLayer_{i}"][name])
        i += 1
    _dense("head", params["Dense_0"], out)
    return _state_dict(out)


# --------------------------------------------------------------------------
# The inverses: the port's state_dict -> a flax parameter tree (nested dicts
# of float32 numpy arrays, flax's names and layouts).  A saved neural
# model's params.npz holds this tree, flattened with "/".


def _np(state_dict, key) -> np.ndarray:
    return np.ascontiguousarray(state_dict[key].detach().cpu().numpy(), np.float32)


def _to_dense(state_dict, prefix: str) -> dict:
    """torch weight (out, in) -> flax Dense kernel (in, out)."""
    return {
        "kernel": np.ascontiguousarray(_np(state_dict, f"{prefix}.weight").T),
        "bias": _np(state_dict, f"{prefix}.bias"),
    }


def _to_norm(state_dict, prefix: str) -> dict:
    return {
        "scale": _np(state_dict, f"{prefix}.weight"),
        "bias": _np(state_dict, f"{prefix}.bias"),
    }


def _count(state_dict, prefix: str) -> int:
    """How many ``prefix.<i>.*`` submodules the state_dict holds."""
    return len({k.split(".")[1] for k in state_dict if k.startswith(prefix + ".")})


def mlp_params_to_flax(state_dict) -> dict:
    """Inverse of :func:`mlp_params_from_flax`."""
    hidden = _count(state_dict, "layers")
    tree = {f"Dense_{i}": _to_dense(state_dict, f"layers.{i}") for i in range(hidden)}
    tree[f"Dense_{hidden}"] = _to_dense(state_dict, "head")
    return tree


def cnn1d_params_to_flax(state_dict) -> dict:
    """Inverse of :func:`cnn1d_params_from_flax`: a block's norm is a
    LayerNorm where it has a bias, an RMSNorm where it has only a scale."""
    tree: dict = {}
    for i in range(_count(state_dict, "blocks")):
        p = f"blocks.{i}"
        block = {
            "Conv_0": {
                "kernel": np.ascontiguousarray(
                    _np(state_dict, f"{p}.weight").transpose(2, 1, 0)
                ),
                "bias": _np(state_dict, f"{p}.bias"),
            }
        }
        if f"{p}.norm.bias" in state_dict:
            block["LayerNorm_0"] = _to_norm(state_dict, f"{p}.norm")
        elif f"{p}.norm.weight" in state_dict:
            block["RMSNorm_0"] = {"scale": _np(state_dict, f"{p}.norm.weight")}
        tree[f"ConvBlock_{i}"] = block
    tree["Dense_0"] = _to_dense(state_dict, "fc")
    tree["Dense_1"] = _to_dense(state_dict, "head")
    return tree


def bilstm_params_to_flax(state_dict) -> dict:
    """Inverse of :func:`bilstm_params_from_flax`."""
    tree: dict = {
        f"FusedBiLSTMLayer_{i}": {
            name: _np(state_dict, f"layers.{i}.{name}") for name in ("wx", "wh", "bias")
        }
        for i in range(_count(state_dict, "layers"))
    }
    tree["Dense_0"] = _to_dense(state_dict, "head")
    return tree


def transformer_params_to_flax(state_dict, patch_size: int = 1,
                               scan_layers: bool = False) -> dict:
    """Inverse of :func:`transformer_params_from_flax`, in the unrolled
    layout or (``scan_layers``) the stacked ``blocks/EncoderBlock_0`` one;
    a patch embedding's (out, patch·in) weight becomes the conv kernel
    (patch, in, out)."""
    tree: dict = {}
    if "patch_embed.weight" in state_dict:
        weight = _np(state_dict, "patch_embed.weight")
        tree["patch_embed"] = {
            "kernel": np.ascontiguousarray(
                weight.T.reshape(patch_size, -1, weight.shape[0])
            ),
            "bias": _np(state_dict, "patch_embed.bias"),
        }
    else:
        tree["embed"] = _to_dense(state_dict, "embed")
    blocks = []
    for i in range(_count(state_dict, "blocks")):
        blocks.append({
            flax_name: (_to_norm if flax_name.startswith("LayerNorm") else _to_dense)(
                state_dict, f"blocks.{i}.{port_name}"
            )
            for flax_name, port_name in _BLOCK_NAMES.items()
        })
    if scan_layers:
        tree["blocks"] = {
            "EncoderBlock_0": {
                name: {
                    key: np.stack([b[name][key] for b in blocks])
                    for key in blocks[0][name]
                }
                for name in blocks[0]
            }
        }
    else:
        for i, block in enumerate(blocks):
            tree[f"EncoderBlock_{i}"] = block
    tree["LayerNorm_0"] = _to_norm(state_dict, "norm")
    tree["head"] = _to_dense(state_dict, "head")
    return tree


def neural_params_to_flax(model_name: str, module, state_dict=None) -> dict:
    """A neural module's parameters (or ``state_dict``, values of the
    module's shapes) as the flax tree of its family."""
    state_dict = module.state_dict() if state_dict is None else state_dict
    if model_name == "transformer":
        return transformer_params_to_flax(
            state_dict, patch_size=module.patch_size, scan_layers=module.scan_layers
        )
    return _TO_FLAX[model_name](state_dict)


def flax_leaf_names(model_name: str, module, state_dict=None) -> dict[str, tuple[str, int]]:
    """Each ``state_dict`` name of a neural module -> the flax leaf that
    holds its values (its ``/``-joined path) and that leaf's ndim: the
    family's conversion run on tensors that each hold their own index
    (a ``scan_layers`` block's leaves share one stacked flax leaf).
    ``state_dict`` gives the parameters' shapes where the module's own
    are not the served ones (an int8 program's emptied copy)."""
    state_dict = module.state_dict() if state_dict is None else state_dict
    names = list(state_dict)
    marked = {name: torch.full(tuple(value.shape), float(i))
              for i, (name, value) in enumerate(state_dict.items())}
    out: dict = {}

    def walk(tree, path):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, path + (key,))
            else:
                for i in np.unique(value):
                    out[names[int(i)]] = ("/".join(path + (key,)), value.ndim)

    walk(neural_params_to_flax(model_name, module, marked), ())
    return out


def neural_params_from_flax(model_name: str, tree) -> dict:
    """The port's state_dict from the flax tree of its family."""
    return _FROM_FLAX[model_name](tree)


_TO_FLAX = {
    "mlp": mlp_params_to_flax,
    "cnn1d": cnn1d_params_to_flax,
    "bilstm": bilstm_params_to_flax,
}
_FROM_FLAX = {
    "mlp": mlp_params_from_flax,
    "cnn1d": cnn1d_params_from_flax,
    "bilstm": bilstm_params_from_flax,
    "transformer": transformer_params_from_flax,
}


def flax_module_prefixes(model_name: str, module) -> dict[str, tuple[str, ...]]:
    """flax's top-level parameter names -> the port's state_dict prefixes
    that hold the same parameters (what ``transfer.freeze_mask`` reads):
    ``ConvBlock_i`` is ``blocks.i``, the CNN's ``Dense_0`` and ``Dense_1``
    are ``fc`` and ``head``, the MLP's last ``Dense`` is ``head``, a
    transformer's ``EncoderBlock_i`` is ``blocks.i`` (``blocks``, in the
    ``scan_layers`` layout, every block) and its ``LayerNorm_0`` is
    ``norm``."""
    state_dict = module.state_dict()
    if model_name == "mlp":
        hidden = _count(state_dict, "layers")
        table = {f"Dense_{i}": (f"layers.{i}",) for i in range(hidden)}
        table[f"Dense_{hidden}"] = ("head",)
    elif model_name == "cnn1d":
        table = {f"ConvBlock_{i}": (f"blocks.{i}",)
                 for i in range(_count(state_dict, "blocks"))}
        table.update(Dense_0=("fc",), Dense_1=("head",))
    elif model_name == "bilstm":
        table = {f"FusedBiLSTMLayer_{i}": (f"layers.{i}",)
                 for i in range(_count(state_dict, "layers"))}
        table["Dense_0"] = ("head",)
    elif model_name == "transformer":
        embed = "patch_embed" if "patch_embed.weight" in state_dict else "embed"
        table = {embed: (embed,)}
        if module.scan_layers:
            table["blocks"] = ("blocks",)
        else:
            table.update({f"EncoderBlock_{i}": (f"blocks.{i}",)
                          for i in range(_count(state_dict, "blocks"))})
        table.update(LayerNorm_0=("norm",), head=("head",))
    else:
        raise ValueError(f"unknown neural model {model_name!r}")
    return table
