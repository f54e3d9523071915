"""Saved models: classical and neural artifacts, training snapshots, scoring.

Port of ``har_tpu/checkpoint.py``:

  - :func:`save_classical_model` / :func:`load_classical_model` — LR
    coefficients, DT/RF tree arrays and GBDT ensembles as ``arrays.npz``
    plus ``har_meta.json``, optionally with the fitted feature pipeline's
    vocabularies (``pipeline.json``).  The files are the JAX package's,
    key for key and scalar for scalar, so an artifact saved by either
    package loads in the other.
  - :func:`save_model` / :func:`load_model` — a trained neural classifier:
    ``har_meta.json`` with the JAX package's keys (model name and kwargs,
    classes, input shape, scaler, provenance, lineage) and the parameters
    in ``params.npz``, not orbax's directory: flax's parameter tree
    flattened with "/" (``ConvBlock_0/Conv_0/kernel``) in flax's array
    layouts, written and read through ``convert``'s converters.  The JAX
    package's orbax checkpoints cannot be read here.
  - :func:`save_pipeline_model` / :func:`load_pipeline_model` — a fitted
    feature pipeline as JSON.
  - :class:`TrainCheckpointer` — mid-training snapshots for resume, in
    the port's own format (one ``torch.save`` file an epoch).
  - :func:`evaluate_checkpoint` / :func:`predict_checkpoint` — score a
    saved model of either kind on the held-out rows its provenance names.

The loaders and scorers run on ``device`` (default ``cuda``): without a GPU
they raise unless the caller names the CPU.
"""

from __future__ import annotations

import csv
import json
import os
import re
import time
from typing import Any

import numpy as np
import torch

from har_tpu_torch.convert import neural_params_from_flax, neural_params_to_flax
from har_tpu_torch.device import resolve_device
from har_tpu_torch.features.scaler import FittedScaler
from har_tpu_torch.models.neural import build_model
from har_tpu_torch.models.neural_classifier import NeuralClassifierModel
from har_tpu_torch.train.trainer import NeuralModel

_META = "har_meta.json"
_PARAMS = "params.npz"
_ARRAYS = "arrays.npz"
_PIPELINE = "pipeline.json"


def _abspath(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def version_info(meta: dict) -> dict:
    """Lineage fields from checkpoint meta, ``None`` where a checkpoint
    predates them."""
    return {
        "version": meta.get("version"),
        "parent_sha256": meta.get("parent_sha256"),
        "created_unix": meta.get("created_unix"),
    }


def _stamp_lineage(meta: dict, version, parent_sha256, created_unix) -> None:
    """version / parent_sha256 / created_unix into meta (both save paths);
    created_unix defaults to now."""
    if version is not None:
        meta["version"] = int(version)
    if parent_sha256 is not None:
        meta["parent_sha256"] = str(parent_sha256)
    meta["created_unix"] = (
        int(time.time()) if created_unix is None else int(created_unix)
    )


def _stamp_provenance(meta: dict, dataset, synthetic_rows, drop_binned,
                      split_method, split_seed, train_fraction) -> None:
    """What the model was trained on, so scoring re-derives its held-out
    rows without the caller re-stating it (both save paths)."""
    if dataset is not None:
        meta["dataset"] = dataset
    if synthetic_rows is not None:
        meta["synthetic_rows"] = synthetic_rows
    if drop_binned is not None:
        meta["drop_binned"] = drop_binned
    if split_method is not None:
        meta["split_method"] = split_method
    if split_seed is not None:
        meta["split_seed"] = int(split_seed)
    if train_fraction is not None:
        meta["train_fraction"] = float(train_fraction)


def _write_meta(path: str, meta: dict) -> None:
    with open(os.path.join(path, _META), "w") as f:
        json.dump(meta, f)


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flatten(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = value
    return out


def _unflatten(flat) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = value
    return tree


def save_model(path: str, model: NeuralClassifierModel, model_name: str,
               model_kwargs: dict | None = None,
               dataset: str | None = None,
               synthetic_rows: int | None = None,
               drop_binned: bool | None = None,
               split_method: str | None = None,
               input_shape: tuple | None = None,
               split_seed: int | None = None,
               train_fraction: float | None = None,
               version: int | None = None,
               parent_sha256: str | None = None,
               created_unix: int | None = None) -> str:
    """Persist a trained neural classifier: its parameters as flax's tree
    in ``params.npz``, its configuration, scaler and provenance in
    ``har_meta.json``.  ``input_shape`` is the per-example shape the
    parameters were trained on; :func:`load_model` rebuilds the module's
    input width from it."""
    path = _abspath(path)
    os.makedirs(path, exist_ok=True)
    flat = _flatten(neural_params_to_flax(model_name, model.inner.module))
    np.savez(os.path.join(path, _PARAMS), **flat)
    meta: dict[str, Any] = {
        "model_name": model_name,
        "model_kwargs": model_kwargs or {},
        "num_classes": model.num_classes,
    }
    _stamp_lineage(meta, version, parent_sha256, created_unix)
    _stamp_provenance(meta, dataset, synthetic_rows, drop_binned, split_method,
                      split_seed, train_fraction)
    if input_shape is not None:
        meta["input_shape"] = [int(d) for d in input_shape]
    if model.scaler is not None:
        meta["scaler"] = {
            "mean": np.asarray(model.scaler.mean).tolist(),
            "std": np.asarray(model.scaler.std).tolist(),
        }
    _write_meta(path, meta)
    return path


def load_model_meta(path: str) -> dict:
    """The checkpoint's recorded provenance without its parameters."""
    with open(os.path.join(_abspath(path), _META)) as f:
        return json.load(f)


def _in_features(model_name: str, tree: dict) -> int:
    """The input width of a checkpoint that records no input_shape: the
    first layer's fan-in in flax's layout."""
    if model_name == "mlp":
        return tree["Dense_0"]["kernel"].shape[0]
    if model_name == "cnn1d":
        return tree["ConvBlock_0"]["Conv_0"]["kernel"].shape[1]
    if model_name == "bilstm":
        return tree["FusedBiLSTMLayer_0"]["wx"].shape[1]
    if "patch_embed" in tree:
        return tree["patch_embed"]["kernel"].shape[1]
    return tree["embed"]["kernel"].shape[0]


def load_model(path: str, device: str | torch.device = "cuda") -> NeuralClassifierModel:
    """A saved neural classifier, its module on ``device``."""
    device = resolve_device(device)
    meta = load_model_meta(path)
    path = _abspath(path)
    params_file = os.path.join(path, _PARAMS)
    if not os.path.exists(params_file):
        raise ValueError(
            f"{path} holds no {_PARAMS}: an orbax checkpoint of the JAX "
            "package cannot be read by har_tpu_torch (ROADMAP.md Queue 3)"
        )
    with np.load(params_file) as npz:
        tree = _unflatten({k: npz[k] for k in npz.files})
    module = build_model(
        meta["model_name"],
        num_classes=meta["num_classes"],
        in_features=(
            int(meta["input_shape"][-1]) if "input_shape" in meta
            else _in_features(meta["model_name"], tree)
        ),
        **{
            k: (tuple(v) if isinstance(v, list) else v)
            for k, v in meta["model_kwargs"].items()
        },
    )
    module.load_state_dict(neural_params_from_flax(meta["model_name"], tree))
    module.to(device).eval()
    scaler = None
    if "scaler" in meta:
        scaler = FittedScaler(
            mean=np.asarray(meta["scaler"]["mean"], np.float32),
            std=np.asarray(meta["scaler"]["std"], np.float32),
        )
    inner = NeuralModel(module=module, num_classes=meta["num_classes"])
    return NeuralClassifierModel(
        inner=inner, scaler=scaler, num_classes=meta["num_classes"]
    )


# ---------------------------------------------------------------------------
# Classical models (LR / DT / RF / GBDT) + pipeline vocabularies
# ---------------------------------------------------------------------------


def _classical_registry():
    """kind -> (canonical model name, extractor, constructor).

    ``extractor(model) -> (arrays, scalars)`` and ``constructor(arrays,
    scalars, device) -> model`` are each other's inverses; arrays go to
    ``arrays.npz``, scalars into the JSON metadata."""
    from har_tpu_torch.models.forest import RandomForestModel
    from har_tpu_torch.models.gbdt import GradientBoostedTreesModel
    from har_tpu_torch.models.logistic_regression import LogisticRegressionModel
    from har_tpu_torch.models.tree import DecisionTreeModel, TreeArrays

    def flat_extractor(array_fields, scalar_fields):
        def extract(model):
            return (
                {f: np.asarray(getattr(model, f)) for f in array_fields},
                {f: getattr(model, f) for f in scalar_fields},
            )

        return extract

    def extract_tree(model):
        t = model.tree
        arrays = {
            "tree_feature": t.feature,
            "tree_threshold": t.threshold,
            "tree_leaf_class": t.leaf_class,
            "tree_leaf_probs": t.leaf_probs,
        }
        if t.leaf_counts is not None:
            arrays["tree_leaf_counts"] = t.leaf_counts
        return (
            arrays,
            {"max_depth": t.max_depth, "num_classes": model.num_classes},
        )

    def build_tree(arrays, scalars, device):
        return DecisionTreeModel(
            tree=TreeArrays(
                feature=arrays["tree_feature"],
                threshold=arrays["tree_threshold"],
                leaf_class=arrays["tree_leaf_class"],
                leaf_probs=arrays["tree_leaf_probs"],
                max_depth=scalars["max_depth"],
                leaf_counts=arrays.get("tree_leaf_counts"),
            ),
            num_classes=scalars["num_classes"],
            device=device,
        )

    return {
        "LogisticRegressionModel": (
            "logistic_regression",
            flat_extractor(("coefficients", "intercept"), ("num_classes",)),
            lambda a, s, device: LogisticRegressionModel(
                coefficients=a["coefficients"],
                intercept=a["intercept"],
                num_classes=s["num_classes"],
                device=device,
            ),
        ),
        "DecisionTreeModel": ("decision_tree", extract_tree, build_tree),
        "RandomForestModel": (
            "random_forest",
            flat_extractor(
                ("feature", "threshold", "leaf_probs"),
                ("max_depth", "num_classes"),
            ),
            lambda a, s, device: RandomForestModel(
                feature=a["feature"],
                threshold=a["threshold"],
                leaf_probs=a["leaf_probs"],
                max_depth=s["max_depth"],
                num_classes=s["num_classes"],
                device=device,
            ),
        ),
        "GradientBoostedTreesModel": (
            "gbdt",
            flat_extractor(
                ("feature", "split_bin", "leaf_value", "thresholds"),
                ("learning_rate", "max_depth", "num_classes"),
            ),
            lambda a, s, device: GradientBoostedTreesModel(
                feature=a["feature"],
                split_bin=a["split_bin"],
                leaf_value=a["leaf_value"],
                thresholds=a["thresholds"],
                learning_rate=s["learning_rate"],
                max_depth=s["max_depth"],
                num_classes=s["num_classes"],
                device=device,
            ),
        ),
    }


def _classical_arrays_scalars(model) -> tuple[dict, dict, str, str]:
    """Split a classical model into (arrays, scalars, kind, model_name)."""
    kind = type(model).__name__
    registry = _classical_registry()
    if kind not in registry:
        raise TypeError(
            f"{kind} is not a persistable classical model "
            f"(expected one of {sorted(registry)})"
        )
    model_name, extract, _ = registry[kind]
    arrays, scalars = extract(model)
    return arrays, scalars, kind, model_name


def save_classical_model(
    path: str,
    model,
    dataset: str | None = None,
    synthetic_rows: int | None = None,
    drop_binned: bool | None = None,
    split_method: str | None = None,
    pipeline=None,
    split_seed: int | None = None,
    train_fraction: float | None = None,
    version: int | None = None,
    parent_sha256: str | None = None,
    created_unix: int | None = None,
) -> str:
    """Persist a classical model and, given ``pipeline`` (the fitted
    PipelineModel that produced its design matrix), the vocabularies that
    featurize raw tables for it."""
    path = _abspath(path)
    os.makedirs(path, exist_ok=True)
    arrays, scalars, kind, model_name = _classical_arrays_scalars(model)
    np.savez_compressed(os.path.join(path, _ARRAYS), **arrays)
    meta: dict[str, Any] = {
        "format": "classical",
        "kind": kind,
        "model_name": model_name,
        "scalars": {
            k: (v.item() if isinstance(v, np.generic) else v)
            for k, v in scalars.items()
        },
    }
    _stamp_lineage(meta, version, parent_sha256, created_unix)
    _stamp_provenance(meta, dataset, synthetic_rows, drop_binned, split_method,
                      split_seed, train_fraction)
    _write_meta(path, meta)
    pipe_path = os.path.join(path, _PIPELINE)
    if pipeline is not None:
        save_pipeline_model(pipe_path, pipeline)
    elif os.path.exists(pipe_path):
        # a pipeline-less model re-saved into an existing dir must not
        # leave a stale vocabulary behind for scoring to trust
        os.remove(pipe_path)
    return path


def load_classical_model(path: str, device: str | torch.device = "cuda"):
    """A saved classical model that predicts on ``device``."""
    device = str(resolve_device(device))
    path = _abspath(path)
    meta = load_model_meta(path)
    if meta.get("format") != "classical":
        raise ValueError(
            f"{path} is not a classical-model checkpoint "
            f"(format={meta.get('format')!r}); use load_model"
        )
    registry = _classical_registry()
    kind = meta["kind"]
    if kind not in registry:
        raise ValueError(f"unknown classical model kind {kind!r}")
    with np.load(os.path.join(path, _ARRAYS)) as npz:
        arrays = {k: npz[k] for k in npz.files}
    return registry[kind][2](arrays, meta["scalars"], device)


def save_pipeline_model(path: str, pipeline) -> str:
    """Fitted feature pipeline → JSON (vocabularies, cardinalities, layout)."""
    from har_tpu_torch.features.assembler import VectorAssembler
    from har_tpu_torch.features.one_hot import OneHotEncoderModel
    from har_tpu_torch.features.string_indexer import StringIndexerModel

    stages = []
    for stage in pipeline.stages:
        if isinstance(stage, StringIndexerModel):
            stages.append({
                "kind": "StringIndexerModel",
                "input_col": stage.input_col,
                "output_col": stage.output_col,
                "vocab": list(stage.vocab),
                "handle_invalid": stage.handle_invalid,
            })
        elif isinstance(stage, OneHotEncoderModel):
            stages.append({
                "kind": "OneHotEncoderModel",
                "input_col": stage.input_col,
                "output_col": stage.output_col,
                "cardinality": stage.cardinality,
                "drop_last": stage.drop_last,
            })
        elif isinstance(stage, VectorAssembler):
            stages.append({
                "kind": "VectorAssembler",
                "input_cols": list(stage.input_cols),
                "output_col": stage.output_col,
            })
        else:
            raise TypeError(
                f"cannot serialize pipeline stage {type(stage).__name__}"
            )
    path = _abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"stages": stages}, f)
    return path


def load_pipeline_model(path: str):
    from har_tpu_torch.features.assembler import VectorAssembler
    from har_tpu_torch.features.one_hot import OneHotEncoderModel
    from har_tpu_torch.features.pipeline import PipelineModel
    from har_tpu_torch.features.string_indexer import StringIndexerModel

    with open(_abspath(path)) as f:
        spec = json.load(f)
    stages = []
    for s in spec["stages"]:
        kind = s["kind"]
        if kind == "StringIndexerModel":
            stages.append(
                StringIndexerModel(
                    s["input_col"], s["output_col"], tuple(s["vocab"]),
                    s["handle_invalid"],
                )
            )
        elif kind == "OneHotEncoderModel":
            stages.append(
                OneHotEncoderModel(
                    s["input_col"], s["output_col"], s["cardinality"],
                    s["drop_last"],
                )
            )
        elif kind == "VectorAssembler":
            stages.append(VectorAssembler(s["input_cols"], s["output_col"]))
        else:
            raise ValueError(f"unknown pipeline stage kind {kind!r}")
    return PipelineModel(stages)


class TrainCheckpointer:
    """Mid-training snapshots in ``directory``, one file an epoch
    (``epoch_<n>.pt``), the newest ``keep`` kept.

    A snapshot holds ``params`` (a state_dict), ``opt_state`` (the
    trainer's: AdamW's moments and step count, and the states of its
    dropout and augmentation generators) and, optionally, ``extra`` (the
    early-stopping carry).  Each is written to a temporary file and
    renamed into place, so a crash leaves the previous snapshot whole;
    loading takes tensors and plain containers only
    (``torch.load(weights_only=True)``), onto the CPU."""

    _FILE = re.compile(r"^epoch_(\d+)\.pt$")

    def __init__(self, directory: str, keep: int = 3):
        self.directory = _abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch}.pt")

    def epochs(self) -> list[int]:
        return sorted(
            int(m.group(1))
            for m in map(self._FILE.match, os.listdir(self.directory))
            if m
        )

    def save(self, epoch: int, params, opt_state, extra=None) -> None:
        state = {"params": params, "opt_state": opt_state}
        if extra is not None:
            state["extra"] = extra
        tmp = self._path(epoch) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(epoch))
        for old in self.epochs()[: -self.keep]:
            os.remove(self._path(old))

    def latest_epoch(self) -> int | None:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def restore(self, epoch: int | None = None, with_extra: bool = False):
        """(epoch, params, opt_state[, extra]) of ``epoch`` (default the
        newest), or None where there is no snapshot."""
        epoch = epoch if epoch is not None else self.latest_epoch()
        if epoch is None:
            return None
        state = torch.load(self._path(epoch), map_location="cpu", weights_only=True)
        if with_extra:
            return epoch, state["params"], state["opt_state"], state.get("extra")
        return epoch, state["params"], state["opt_state"]

    def close(self) -> None:
        """Nothing is held open between calls (kept for the JAX API)."""


# ---------------------------------------------------------------------------
# Scoring a saved model: evaluate / predict
# ---------------------------------------------------------------------------


def scoring_config_from_meta(
    meta: dict,
    data_path: str | None = None,
    dataset: str | None = None,
    train_fraction: float | None = None,
    seed: int | None = None,
    synthetic_rows: int | None = None,
    what: str = "checkpoint",
):
    """Saved provenance → the RunConfig that re-derives the held-out
    partition, for every scoring path.

    ``None`` for dataset/train_fraction/seed/synthetic_rows means the
    recorded value (wisdm / 0.7 / 2018 where none is recorded); an
    explicit dataset or row count that contradicts the recording is
    refused, since it would change the feature view or the data.
    """
    from har_tpu_torch.config import DataConfig, ModelConfig, RunConfig

    saved_dataset = meta.get("dataset")
    if dataset is None:
        dataset = saved_dataset or "wisdm"
    elif saved_dataset is not None and dataset != saved_dataset:
        raise ValueError(
            f"{what} was trained on dataset {saved_dataset!r}; "
            f"evaluating against {dataset!r} would derive a different "
            "feature view than the saved parameters expect"
        )
    saved_rows = meta.get("synthetic_rows")
    if synthetic_rows is None:
        synthetic_rows = saved_rows
    elif saved_rows is not None and synthetic_rows != saved_rows:
        raise ValueError(
            f"{what} was trained with synthetic_rows={saved_rows}; "
            f"evaluating against synthetic_rows={synthetic_rows} would "
            "regenerate different data than the saved parameters saw"
        )
    if seed is None:
        seed = meta.get("split_seed", 2018)
    if train_fraction is None:
        train_fraction = meta.get("train_fraction", 0.7)
    return RunConfig(
        data=DataConfig(
            dataset=dataset,
            path=data_path,
            train_fraction=train_fraction,
            seed=seed,
            synthetic_rows=synthetic_rows,
            drop_binned=meta.get("drop_binned", True),
            # checkpoints predating the spark-exact split were held out
            # under the bernoulli draw
            split_method=meta.get("split_method", "bernoulli"),
        ),
        model=ModelConfig(name=meta.get("model_name", "cnn1d")),
    )


def _load_checkpoint_for_scoring(
    path: str,
    data_path: str | None,
    dataset: str | None,
    train_fraction: float | None,
    seed: int | None,
    synthetic_rows: int | None,
    device: str | torch.device = "cuda",
):
    """(model, test FeatureSet): the checkpoint and the rows it is scored
    on, through its bundled pipeline vocabularies where it has them,
    through ``runner.featurize`` otherwise."""
    from har_tpu_torch.runner import derive_split, featurize, load_dataset

    meta = load_model_meta(path)
    is_classical = meta.get("format") == "classical"
    model = (load_classical_model if is_classical else load_model)(path, device)
    config = scoring_config_from_meta(
        meta, data_path, dataset, train_fraction, seed, synthetic_rows
    )
    table = load_dataset(config)
    pipe_path = os.path.join(_abspath(path), _PIPELINE)
    if is_classical and os.path.exists(pipe_path):
        # the checkpoint's own vocabularies, no refit: unseen categories
        # fail or bucket per the indexer's handle_invalid
        from har_tpu_torch.features.wisdm_pipeline import make_feature_set

        full = make_feature_set(load_pipeline_model(pipe_path).transform(table))
        _, test = derive_split(full, table, config.data)
    else:
        _, test, _ = featurize(config, table, device)
    return model, test


def write_predictions_csv(model, test, output_csv: str) -> dict:
    """One CSV row per window: UID (where the view carries one, else the
    row's index), the true label, the predicted class and each class's
    probability (``%.6g``)."""
    preds = model.transform(test)
    probs = np.asarray(preds.probability)
    output_csv = _abspath(output_csv)
    parent = os.path.dirname(output_csv)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(output_csv, "w", newline="") as f:
        w = csv.writer(f)
        prob_cols = [f"prob_{k}" for k in range(probs.shape[1])]
        w.writerow(["UID", "label", "prediction"] + prob_cols)
        for i in range(len(preds)):
            uid = int(test.uid[i]) if test.uid is not None else i
            w.writerow(
                [uid, int(test.label[i]), int(preds.prediction[i])]
                + [f"{p:.6g}" for p in probs[i]]
            )
    return {
        "output": output_csv,
        "n_rows": int(len(preds)),
        "num_classes": int(probs.shape[1]),
    }


def predict_checkpoint(
    path: str,
    output_csv: str,
    data_path: str | None = None,
    dataset: str | None = None,
    train_fraction: float | None = None,
    seed: int | None = None,
    synthetic_rows: int | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """`predict`: score the held-out rows (as `evaluate` derives them) and
    write the predictions CSV."""
    model, test = _load_checkpoint_for_scoring(
        path, data_path, dataset, train_fraction, seed, synthetic_rows, device
    )
    return write_predictions_csv(model, test, output_csv)


def evaluate_checkpoint(
    path: str,
    data_path: str | None = None,
    dataset: str | None = None,
    train_fraction: float | None = None,
    seed: int | None = None,
    synthetic_rows: int | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """`evaluate`: load a checkpoint and score it on its held-out rows,
    re-derived from the recorded dataset, seed and train fraction (an
    explicit seed or fraction scores another draw)."""
    from har_tpu_torch.ops.metrics import evaluate

    model, test = _load_checkpoint_for_scoring(
        path, data_path, dataset, train_fraction, seed, synthetic_rows, device
    )
    preds = model.transform(test)
    rep = evaluate(test.label, preds.raw, model.num_classes)
    return {
        "accuracy": rep["accuracy"],
        "f1": rep["f1"],
        "weightedPrecision": rep["weightedPrecision"],
        "weightedRecall": rep["weightedRecall"],
        "count_correct": int(rep["count_correct"]),
        "count_wrong": int(rep["count_wrong"]),
        "n_test": int(len(test)),
    }
