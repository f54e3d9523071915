"""Weight-only int8 post-training quantization for the neural families.

Port of ``har_tpu/quantize.py``'s ``_q8``, ``_Stored``, ``QuantizedModel``
and ``quantize_model``.  Every ``kernel`` weight is stored int8 with a
per-output-channel float32 scale (symmetric, 4x smaller), and the forward
dequantizes it on the fly; compute stays in the model's own dtype, so the
accuracy loss is bounded by the weights' rounding alone.

The quantization runs in flax's layout.  ``convert.neural_params_to_flax``
maps the module's parameters to the flax tree its checkpoint holds, whose
Dense and Conv kernels keep the output channel last; ``_q8`` (copied) then
scales every ``kernel`` leaf of two or more dimensions exactly as the JAX
package does, so the int8 values and scales are bit-equal to
``har_tpu.quantize``'s by construction.  (torch's ``Linear`` weight is
(out, in) and its ``Conv1d`` weight (out, in, k): per-output-channel
scales taken on torch's layout would pick another axis.)  The int8 tree is
carried back through ``convert.neural_params_from_flax``: its layout moves
are permutations, so each int8 value and its scale land on the torch
parameter's element bit for bit, and each scale is kept in the smallest
shape that broadcasts over that parameter.

``QuantizedModel`` implements the ClassifierModel protocol (``transform``
→ Predictions), so it drops into evaluation, serving and export: its
``predict_fn`` is the module ``export`` traces, with the int8 tensors as
buffers and the dequantization inside the exported program.

``quantize_serving`` and ``Int8ServingModel`` wrap the fleet's dispatch
plane and wait for it (ROADMAP.md Queue 1 item 12).
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch
from torch import nn

from har_tpu_torch.convert import neural_params_from_flax, neural_params_to_flax
from har_tpu_torch.export import PredictCore, predict_in_chunks
from har_tpu_torch.models.base import Predictions
from har_tpu_torch.models.neural import MODEL_REGISTRY


@dataclasses.dataclass(frozen=True)
class _Stored:
    """One parameter leaf: int8+scale when quantized, raw otherwise."""

    kind: str  # "q8" | "f"
    value: np.ndarray  # int8 weights or the original array
    scale: np.ndarray | None  # per-output-channel f32 (q8 only)


def _q8(w: np.ndarray) -> _Stored:
    """Symmetric per-output-channel int8 storage of one >=2-dim weight
    (last axis = output features in flax's Dense/Conv layout) — the JAX
    package's arithmetic, copied."""
    scale = np.abs(w).max(axis=tuple(range(w.ndim - 1))) / 127.0
    scale = np.where(scale > 0, scale, 1.0).astype(np.float32)
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return _Stored("q8", q, scale)


def _flatten_sorted(tree: dict, prefix: tuple = ()) -> list[tuple[tuple, np.ndarray]]:
    """(path, leaf) pairs in jax.tree_util's order for nested dicts
    (keys sorted at every level)."""
    out = []
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            out.extend(_flatten_sorted(value, (*prefix, key)))
        else:
            out.append(((*prefix, key), value))
    return out


def _unflatten(pairs) -> dict:
    tree: dict = {}
    for path, value in pairs:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return tree


def _compact(scale: np.ndarray) -> np.ndarray:
    """``scale`` reduced to size 1 along every axis it is constant on:
    the smallest array that broadcasts back to it."""
    for axis in range(scale.ndim):
        first = np.take(scale, [0], axis=axis)
        if np.array_equal(np.broadcast_to(first, scale.shape), scale):
            scale = first
    return np.ascontiguousarray(scale)


def _model_name(module: nn.Module) -> str:
    for name, cls in MODEL_REGISTRY.items():
        if type(module) is cls:
            return name
    raise ValueError(f"{type(module).__name__} is not a neural family of the port")


def _torch_layout(model_name: str, paths, stored) -> list[tuple[str, torch.Tensor, torch.Tensor | None]]:
    """(parameter name, stored value, broadcast scale or None) for every
    parameter of the module, in torch's layout."""

    def to_torch(leaves):
        return neural_params_from_flax(model_name, _unflatten(zip(paths, leaves)))

    values = to_torch([
        s.value.astype(np.float32) if s.kind == "q8" else s.value for s in stored
    ])
    scales = to_torch([
        np.broadcast_to(s.scale, s.value.shape) if s.kind == "q8"
        else np.ones_like(s.value) for s in stored
    ])
    marks = to_torch([
        np.full(s.value.shape, s.kind == "q8", np.float32) for s in stored
    ])
    plan = []
    for name, value in values.items():
        if bool(marks[name].all()):
            plan.append((name, value.to(torch.int8),
                         torch.from_numpy(_compact(scales[name].numpy()))))
        else:
            plan.append((name, value, None))
    return plan


class Int8Predict(nn.Module):
    """standardize → forward → (logits, probs) with int8 weight buffers
    (float32 for biases and norms), dequantized in ``forward``
    (``int8 → f32 × scale``).  The base module's own parameters are
    emptied, so an exported program holds each weight once, in its
    stored dtype."""

    def __init__(self, module: nn.Module, scaler, plan):
        super().__init__()
        module = copy.deepcopy(module)
        for name, _ in list(module.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            module.get_submodule(owner)._parameters[leaf] = nn.Parameter(
                torch.empty(0, device=_device(module)), requires_grad=False
            )
        self.core = PredictCore(module, scaler)
        self.names = []
        for i, (name, value, scale) in enumerate(plan):
            self.register_buffer(f"w{i}", value.clone())
            if scale is not None:
                self.register_buffer(f"s{i}", scale.clone())
            self.names.append((name, scale is not None))

    def forward(self, x):
        params = {}
        for i, (name, quantized) in enumerate(self.names):
            w = getattr(self, f"w{i}")
            params[f"module.{name}"] = (
                w.to(torch.float32) * getattr(self, f"s{i}") if quantized else w
            )
        return torch.func.functional_call(self.core, params, (x,))


def _device(module: nn.Module) -> torch.device:
    return next(iter(module.parameters()), torch.empty(0)).device


@dataclasses.dataclass
class QuantizedModel:
    """A neural model with int8 kernels, ClassifierModel-compatible."""

    module: nn.Module
    model_name: str
    paths: list  # flax leaf paths, in jax.tree_util's order
    stored: list[_Stored]  # one per path
    scaler: object | None
    num_classes: int

    def __post_init__(self):
        self._predict = Int8Predict(
            self.module, self.scaler,
            _torch_layout(self.model_name, self.paths, self.stored),
        ).to(_device(self.module)).eval()

    @property
    def device(self) -> torch.device:
        return _device(self.module)

    def dequantized_params(self) -> dict:
        """flax's parameter tree with kernels reconstructed as f32."""
        return _unflatten(
            (path, s.value.astype(np.float32) * s.scale if s.kind == "q8" else s.value)
            for path, s in zip(self.paths, self.stored)
        )

    def predict_fn(self) -> nn.Module:
        """x → (logits, probs), scaler folded in, int8 weights as buffers:
        what ``export.export_model`` traces and what ``transform`` runs."""
        return self._predict

    def transform(self, data):
        x = data.features if hasattr(data, "features") else data
        logits, probs = predict_in_chunks(self._predict, x, self.device)
        return Predictions.from_raw(logits, probs)

    def size_report(self) -> dict:
        """Weight-storage accounting: int8+scales vs the f32 original."""
        q_bytes = f_bytes = 0
        n_q = 0
        for s in self.stored:
            orig = s.value.size * 4  # all trained params are f32
            f_bytes += orig
            if s.kind == "q8":
                n_q += 1
                q_bytes += s.value.size + s.scale.size * 4
            else:
                q_bytes += orig
        return {
            "quantized_kernels": n_q,
            "float_bytes": f_bytes,
            "quantized_bytes": q_bytes,
            "ratio": round(q_bytes / f_bytes, 4) if f_bytes else None,
        }


def quantize_model(model) -> QuantizedModel:
    """Weight-only int8 quantization of a fitted neural model.

    ``model`` is a ``NeuralClassifierModel`` (scaler carried over) or a
    bare ``NeuralModel``.  Every ``kernel`` leaf of flax's tree with >=2
    dims is stored int8 with a symmetric per-output-channel scale (last
    axis = output features in flax's Dense/Conv layout); biases and norm
    parameters stay f32 — they are a rounding-sensitive sliver of the
    bytes.
    """
    inner = getattr(model, "inner", model)
    name = _model_name(inner.module)
    pairs = _flatten_sorted(neural_params_to_flax(name, inner.module))
    stored = [
        _q8(w) if path[-1] == "kernel" and w.ndim >= 2 else _Stored("f", w, None)
        for path, w in pairs
    ]
    return QuantizedModel(
        module=inner.module,
        model_name=name,
        paths=[path for path, _ in pairs],
        stored=stored,
        scaler=getattr(model, "scaler", None),
        num_classes=int(model.num_classes),
    )
