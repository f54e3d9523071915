"""Portable predict artifacts through ``torch.export``.

Port of ``har_tpu/export.py``; ``torch.export`` takes the place of
StableHLO.  The reference has no deployment story (its models live and
die inside the Spark driver, `Main/main.py:115-130`).  Saved checkpoints
make parameters durable but still need the model classes; this module
exports the whole predict — scaler, forward pass and softmax — as one
program with the trained parameters inside:

  - ``export_model(model, path)`` — ``torch.export.export`` of the
    model's :class:`PredictCore` with a symbolic batch
    (``torch.export.Dim``), saved by ``torch.export.save`` as
    ``path/predict.pt2`` beside ``export_meta.json`` (the JAX package's
    keys: ``num_classes``, ``example_shape``, ``platforms``,
    ``outputs``, the checkpoint's provenance and ``quantization``).
  - ``export_checkpoint(ckpt, path)`` — the same, straight from a saved
    checkpoint directory, optionally int8 (``quantize.QuantizedModel``:
    the int8 tensors stay int8 inside the artifact and the
    dequantization is part of the exported program).
  - ``load_exported(path, device)`` — an ``ExportedPredictor``
    implementing the ClassifierModel protocol, so an artifact drops into
    evaluation, batch predict or ``serving.StreamingClassifier``.
  - ``evaluate_artifact`` / ``predict_artifact`` — the CLI's ``evaluate``
    and ``predict --artifact``.

The transformer's attention is kernel K2's registered op
(``har_tpu_torch::flash_attention_fwd``): the exported graph keeps it as
one node, and the loaded program launches the kernel on CUDA tensors, so
``load_exported`` registers it (imports ``ops.flash_attention``) before
``torch.export.load``.  Tracing runs on the CPU (no kernel runs while a
program is traced); ``platforms`` (``cuda``, ``cpu``) is recorded in the
meta, and loading on another device raises.  Neither package loads the
other's artifact: a ``predict.stablehlo`` directory is refused here.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os

import numpy as np
import torch
from torch import nn

from har_tpu_torch.device import resolve_device

_PROGRAM = "predict.pt2"
_META = "export_meta.json"
_JAX_PROGRAM = "predict.stablehlo"
PLATFORMS = ("cuda", "cpu")
# windows an artifact scores per call, as NeuralModel.predict_logits does
PREDICT_CHUNK = 8192


class PredictCore(nn.Module):
    """The ONE standardize → forward → (logits, probs) implementation.

    Every predict surface — the float export, a temperature-scaled model
    (``temperature`` divides the logits before the softmax) and the int8
    model (``quantize.Int8Predict`` swaps its weights in) — is this
    module, so the contract cannot diverge between the live path and an
    artifact.  The scaler's statistics are buffers; logits are float32.
    """

    def __init__(self, module: nn.Module, scaler=None, temperature: float | None = None):
        super().__init__()
        self.module = module
        self.standardize = scaler is not None
        if self.standardize:
            self.register_buffer("mean", torch.as_tensor(np.asarray(scaler.mean, np.float32)))
            self.register_buffer("std", torch.as_tensor(np.asarray(scaler.std, np.float32)))
        self.scaled = temperature is not None
        if self.scaled:
            self.register_buffer("temperature", torch.tensor(float(temperature)))

    def forward(self, x):
        x = x.to(torch.float32)
        if self.standardize:
            x = (x - self.mean) / self.std
        logits = self.module(x).to(torch.float32)
        scores = logits / self.temperature if self.scaled else logits
        return logits, torch.softmax(scores, dim=-1)


def predict_module(model) -> nn.Module:
    """The :class:`PredictCore` (or int8 module) behind ``model``: its own
    ``predict_fn`` where it has one (a calibrated or quantized model),
    else the base module with the scaler."""
    if hasattr(model, "predict_fn"):
        return model.predict_fn()
    inner = getattr(model, "inner", model)
    return PredictCore(inner.module, getattr(model, "scaler", None))


def _base_module(model) -> nn.Module | None:
    """The nn.Module under a chain of ``.model`` / ``.inner`` wrappers."""
    for _ in range(4):
        if isinstance(getattr(model, "module", None), nn.Module):
            return model.module
        model = getattr(model, "inner", None) or getattr(model, "model", None)
        if model is None:
            break
    return None


def predict_in_chunks(fn, x, device: torch.device) -> tuple[np.ndarray, np.ndarray]:
    """(logits, probs) as float32 numpy of ``fn`` (x → (logits, probs))
    over ``x`` in chunks of :data:`PREDICT_CHUNK` rows on ``device``."""
    x = np.ascontiguousarray(x, np.float32)
    logits, probs = [], []
    with torch.no_grad():
        for start in range(0, len(x), PREDICT_CHUNK):
            chunk = torch.from_numpy(x[start : start + PREDICT_CHUNK]).to(device)
            lg, pr = fn(chunk)
            logits.append(lg.cpu().numpy())
            probs.append(pr.cpu().numpy())
    return np.concatenate(logits), np.concatenate(probs)


def _check_platforms(platforms) -> tuple[str, ...]:
    platforms = tuple(platforms)
    for p in platforms:
        if p == "tpu":
            raise ValueError(
                "har_tpu_torch's artifacts run on cuda or cpu; a TPU "
                "artifact is har_tpu's StableHLO export (har_tpu.export)"
            )
        if p not in PLATFORMS:
            raise ValueError(f"unknown platform {p!r}: use {' '.join(PLATFORMS)}")
    if not platforms:
        raise ValueError("an artifact needs at least one platform")
    return platforms


def export_model(
    model,
    path: str,
    *,
    platforms: tuple[str, ...] = PLATFORMS,
    example_shape: tuple[int, ...] | None = None,
    extra_meta: dict | None = None,
) -> str:
    """Export a fitted neural model's predict as ``path/predict.pt2``.

    ``model`` is a ``NeuralClassifierModel`` (scaler folded in), a bare
    ``NeuralModel``, a ``TemperatureScaledModel`` or a
    ``QuantizedModel``.  ``example_shape`` is the per-example feature
    shape; it defaults to the scaler's statistics shape when a scaler is
    present (the scaler is fit on the training features, so its mean
    carries exactly that shape).  The batch dimension is symbolic, so one
    artifact serves any batch size.
    """
    platforms = _check_platforms(platforms)
    scaler = getattr(model, "scaler", None)
    if example_shape is None:
        if scaler is None:
            raise ValueError(
                "example_shape is required when the model has no scaler "
                "(nothing else records the per-example feature shape)"
            )
        example_shape = tuple(int(d) for d in np.asarray(scaler.mean).shape)
    example_shape = tuple(int(d) for d in example_shape)
    if getattr(_base_module(model), "window_pack", 1) > 1:
        # the pack pads the batch to a multiple of window_pack: its group
        # count can be 1, which export's symbolic batch cannot express
        raise ValueError(
            "export covers transformers with window_pack=1; a packed "
            "transformer's padded batch cannot stay symbolic (ROADMAP.md "
            "Queue 1 item 11)"
        )
    core = copy.deepcopy(predict_module(model)).to("cpu").eval()
    example = torch.zeros((2, *example_shape), dtype=torch.float32)
    with torch.no_grad():
        program = torch.export.export(
            core, (example,), dynamic_shapes=({0: torch.export.Dim("batch")},)
        )
    os.makedirs(path, exist_ok=True)
    torch.export.save(program, os.path.join(path, _PROGRAM))
    meta = {
        "num_classes": int(model.num_classes),
        "example_shape": list(example_shape),
        "platforms": list(platforms),
        "torch_version": torch.__version__,
        "format": "torch.export",
        "outputs": ["logits", "probability"],
        # the port's weights ride inside the program (int8 buffers when
        # quantized), never as call inputs
        "weight_inputs": False,
        **(extra_meta or {}),
    }
    with open(os.path.join(path, _META), "w") as f:
        json.dump(meta, f)
    return path


def export_checkpoint(
    checkpoint_path: str,
    path: str,
    *,
    platforms: tuple[str, ...] = PLATFORMS,
    example_shape: tuple[int, ...] | None = None,
    quantize: str | None = None,
) -> str:
    """Export a saved neural checkpoint directory as an artifact;
    provenance (model name/kwargs, dataset, input_shape, split) carries
    over from the checkpoint's metadata.

    ``quantize="int8"`` applies weight-only int8 quantization first
    (``quantize.quantize_model``); the artifact then holds int8 weights
    and its meta records the size report under ``quantization``.
    """
    from har_tpu_torch.checkpoint import load_model, load_model_meta

    platforms = _check_platforms(platforms)
    meta = load_model_meta(checkpoint_path)
    if meta.get("format") == "classical":
        raise ValueError(
            "export covers the neural families; classical "
            "models (LR/DT/RF/GBDT) are already portable as npz+JSON "
            "via save_classical_model"
        )
    model = load_model(checkpoint_path, "cpu")
    # split provenance rides along so evaluate_artifact re-derives the
    # checkpoint's own held-out partition
    carry = {
        k: meta[k]
        for k in (
            "model_name", "model_kwargs", "dataset", "input_shape",
            "split_method", "split_seed", "train_fraction",
            "drop_binned", "synthetic_rows",
        )
        if k in meta
    }
    if quantize == "int8":
        from har_tpu_torch.quantize import quantize_model

        model = quantize_model(model)
        carry["quantization"] = {
            "scheme": "int8_weight_only",
            **model.size_report(),
        }
    elif quantize is not None:
        raise ValueError(f"unknown quantize scheme {quantize!r}")
    if example_shape is None and meta.get("input_shape"):
        example_shape = tuple(meta["input_shape"])
    return export_model(
        model,
        path,
        platforms=platforms,
        example_shape=example_shape,
        extra_meta=carry,
    )


@dataclasses.dataclass
class ExportedPredictor:
    """A loaded ``predict.pt2`` artifact on ``device``.

    Implements the ClassifierModel protocol (``transform`` →
    Predictions), so it drops into ``ops.metrics.evaluate`` scoring or
    ``serving.StreamingClassifier`` exactly like a live model — without
    the model classes or the checkpoint that produced it.
    """

    program: object  # torch.export.ExportedProgram, moved to device
    num_classes: int
    example_shape: tuple[int, ...]
    meta: dict
    device: torch.device

    def __post_init__(self):
        self._module = self.program.module()

    def device_call(self, x):
        """The bare program on a device tensor: returns device logits, no
        numpy staging or shape checks (what serving's device timing
        calls)."""
        return self._module(x)[0]

    @property
    def int8_weights(self) -> bool:
        """True for an int8 artifact."""
        return (self.meta.get("quantization") or {}).get("scheme") == "int8_weight_only"

    def predict(self, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(logits, probability) for a (n, *example_shape) batch."""
        x = np.asarray(x, np.float32)
        if tuple(x.shape[1:]) != self.example_shape:
            raise ValueError(
                f"artifact was exported for per-example shape "
                f"{self.example_shape}; got {tuple(x.shape[1:])}"
            )
        return predict_in_chunks(self._module, x, self.device)

    def transform(self, data):
        from har_tpu_torch.models.base import Predictions

        x = data.features if hasattr(data, "features") else data
        logits, probs = self.predict(x)
        return Predictions.from_raw(logits, probs)


def load_exported(path: str, device: str | torch.device = "cuda") -> ExportedPredictor:
    """The artifact at ``path`` on ``device`` (one of its platforms)."""
    import torch.export.passes

    # the transformer's program holds K2's op: register it before loading
    import har_tpu_torch.ops.flash_attention  # noqa: F401

    device = resolve_device(device)
    program_file = os.path.join(path, _PROGRAM)
    if not os.path.exists(program_file):
        if os.path.exists(os.path.join(path, _JAX_PROGRAM)):
            raise ValueError(
                f"{path} holds a StableHLO artifact ({_JAX_PROGRAM}) written "
                "by har_tpu's export; it needs har_tpu "
                "(har_tpu.export.load_exported) to run"
            )
        raise ValueError(f"{path} holds no {_PROGRAM}")
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    if device.type not in meta.get("platforms", PLATFORMS):
        raise ValueError(
            f"artifact {path} was exported for {meta['platforms']}, not "
            f"{device.type}"
        )
    program = torch.export.passes.move_to_device_pass(
        torch.export.load(program_file), device
    )
    return ExportedPredictor(
        program=program,
        num_classes=int(meta["num_classes"]),
        example_shape=tuple(meta["example_shape"]),
        meta=meta,
        device=device,
    )


def _load_artifact_for_scoring(
    path: str,
    data_path: str | None,
    dataset: str | None,
    train_fraction: float | None,
    seed: int | None,
    synthetic_rows: int | None,
    device: str | torch.device = "cuda",
):
    """Load an artifact + the held-out data it should be scored on —
    the artifact-side mirror of checkpoint._load_checkpoint_for_scoring,
    shared by the evaluate and predict backends so both derive the
    identical test partition."""
    from har_tpu_torch.checkpoint import scoring_config_from_meta
    from har_tpu_torch.runner import featurize, load_dataset

    art = load_exported(path, device)
    config = scoring_config_from_meta(
        art.meta, data_path, dataset, train_fraction, seed,
        synthetic_rows, what="artifact",
    )
    table = load_dataset(config)
    _, test, _ = featurize(config, table, device)
    return art, test


def evaluate_artifact(
    path: str,
    data_path: str | None = None,
    dataset: str | None = None,
    train_fraction: float | None = None,
    seed: int | None = None,
    synthetic_rows: int | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """CLI ``evaluate --artifact`` backend: score an exported artifact on
    the held-out partition its recorded provenance names (the same
    derivation as ``evaluate_checkpoint``: contradictions in dataset or
    synthetic_rows are refused, seed and train_fraction default to the
    recorded split)."""
    from har_tpu_torch.ops.metrics import evaluate

    art, test = _load_artifact_for_scoring(
        path, data_path, dataset, train_fraction, seed, synthetic_rows, device
    )
    preds = art.transform(test)
    rep = evaluate(test.label, preds.raw, art.num_classes)
    return {
        "accuracy": rep["accuracy"],
        "f1": rep["f1"],
        "weightedPrecision": rep["weightedPrecision"],
        "weightedRecall": rep["weightedRecall"],
        "count_correct": int(rep["count_correct"]),
        "count_wrong": int(rep["count_wrong"]),
        "n_test": int(len(test)),
        "artifact": path,
        "quantized": (art.meta.get("quantization") or {}).get("scheme"),
    }


def predict_artifact(
    path: str,
    output_csv: str,
    data_path: str | None = None,
    dataset: str | None = None,
    train_fraction: float | None = None,
    seed: int | None = None,
    synthetic_rows: int | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """CLI ``predict --artifact`` backend: the predictions CSV straight
    from the exported program — the same held-out derivation and writer
    as the checkpoint path (checkpoint.write_predictions_csv)."""
    from har_tpu_torch.checkpoint import write_predictions_csv

    art, test = _load_artifact_for_scoring(
        path, data_path, dataset, train_fraction, seed, synthetic_rows, device
    )
    return write_predictions_csv(art, test, output_csv)
