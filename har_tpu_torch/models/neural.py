"""The neural classifiers: MLP, 1-D CNN, BiLSTM, and the family registry.

Port of ``har_tpu/models/neural.py`` (``MLP``, ``ConvBlock``, ``CNN1D``,
``FusedBiLSTMLayer``, ``BiLSTM``, ``MODEL_REGISTRY``, ``build_model``) as
``torch.nn`` modules with the flax modules' numerics.  None of them has a
Pallas kernel in the JAX package (XLA compiles them there), so they are
plain PyTorch here.

- Constructor arguments are the flax fields (``pool``, ``norm``,
  ``bf16_stream`` and ``remat`` included), plus ``in_features``, the input
  width that flax reads from the first batch.  Forward is ``(x,
  train=False, generator=None)``; ``generator`` draws the dropout masks.
- Parameters are float32, cast with the input to the compute ``dtype``
  (bfloat16 by default) at use; logits leave in float32.
- Initial values follow flax's initializers, drawn from an explicit
  ``torch.Generator`` by ``reset_parameters``: ``lecun_normal`` (a normal
  truncated at two standard deviations) for Dense and Conv kernels, zeros
  for biases, ones for norm scales; the BiLSTM's ``wx`` (2, I, 4H) counts
  its direction axis in the fan-in (2·I) as flax's ``variance_scaling``
  does, and ``wh`` (2, H, 4H) is flax's ``orthogonal`` of the flattened
  (2H, 4H) matrix.
- LayerNorm and RMSNorm take epsilon 1e-6 and their statistics in float32
  (flax's; torch's default epsilon is 1e-5).
- The CNN runs channels-first inside (the JAX package's windows are
  (B, T, C) at the module's boundary, as here).  ``nn.Conv`` pads SAME:
  (2, 2) at stride 1 and k = 5, and at stride 2 (``pool="stride"``) the
  asymmetric (1, 2) at T = 200, padded explicitly since torch's
  ``padding="same"`` refuses stride 2.  ``nn.max_pool`` is VALID, so odd
  lengths floor, as ``max_pool1d`` does.
- The BiLSTM keeps the JAX structure: one hoisted (2, B, T, 4H) input
  projection for both directions (the backward one over the time-reversed
  copy) and one direction-batched (2, B, H)·(2, H, 4H) product a step, in
  a Python loop over T; gate order i, f, g, o; gate math and the cell
  state in float32, matmul inputs rounded to ``dtype`` and multiplied
  with float32 accumulation (``preferred_element_type``); ``bf16_stream``
  stores the projections and h in bfloat16; ``remat`` recomputes each
  step in the backward pass (``torch.utils.checkpoint``).  cuDNN's
  ``nn.LSTM`` is not used: it keeps its own gate layout and rounding, and
  would not compute this function.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from har_tpu_torch.models.transformer import (
    Dense,
    Transformer1D,
    as_dtype,
    dropout,
    lecun_normal_,
)

_EPS = 1e-6


def _maybe_dropout(x, rate: float, train: bool, generator):
    return dropout(x, rate, generator) if train and rate > 0 else x


class MLP(nn.Module):
    """Perceptron over feature vectors: Dense → ReLU → dropout for each
    hidden width, then a Dense head."""

    def __init__(
        self,
        num_classes: int = 6,
        hidden: Sequence[int] = (256, 128),
        dropout_rate: float = 0.2,
        dtype=torch.bfloat16,
        in_features: int = 13,
    ):
        super().__init__()
        self.dtype = as_dtype(dtype)
        self.dropout_rate = dropout_rate
        widths = [in_features, *hidden]
        self.layers = nn.ModuleList(
            Dense(a, b, self.dtype) for a, b in zip(widths[:-1], widths[1:])
        )
        self.head = Dense(widths[-1], num_classes, self.dtype)
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in (*self.layers, self.head):
            layer.reset_parameters(generator)

    def forward(self, x, train: bool = False, generator: torch.Generator | None = None):
        x = x.to(self.dtype)
        for layer in self.layers:
            x = _maybe_dropout(F.relu(layer(x)), self.dropout_rate, train, generator)
        return self.head(x).float()


class ChannelNorm(nn.Module):
    """flax ``LayerNorm`` (``kind="layer"``: E[x²] − E[x]², clipped at 0,
    a scale and a bias) or ``RMSNorm`` (``kind="rms"``: E[x²], a scale)
    over dimension 1 of a (B, C, T) tensor; float32 statistics, epsilon
    1e-6, the result in ``dtype``."""

    def __init__(self, channels: int, kind: str, dtype: torch.dtype):
        super().__init__()
        self.kind = kind
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))
        if kind == "layer":
            self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            if self.kind == "layer":
                self.bias.zero_()

    def forward(self, x):
        xf = x.float()
        scale = self.weight[:, None]
        if self.kind == "rms":
            var = (xf * xf).mean(1, keepdim=True)
            return (xf * (torch.rsqrt(var + _EPS) * scale)).to(self.dtype)
        mean = xf.mean(1, keepdim=True)
        var = ((xf * xf).mean(1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (xf - mean) * (torch.rsqrt(var + _EPS) * scale) + self.bias[:, None]
        return y.to(self.dtype)


def same_padding(length: int, kernel: int, stride: int) -> tuple[int, int]:
    """(low, high) padding of flax's SAME convolution: the output has
    ceil(length / stride) steps, the extra pad going to the high side."""
    out = -(-length // stride)
    total = max((out - 1) * stride + kernel - length, 0)
    return total // 2, total - total // 2


class ConvBlock(nn.Module):
    """SAME convolution (stride 2 where ``pool="stride"``) → norm
    (``"layer"``, ``"rms"`` or ``"none"``) → ReLU → VALID max pool of 2
    (where ``pool="max"``), on (B, C, T)."""

    def __init__(self, in_features: int, features: int, kernel: int, dtype,
                 pool: str = "max", norm: str = "layer"):
        super().__init__()
        if pool not in ("max", "stride"):
            raise ValueError(f"pool={pool!r}; use 'max' or 'stride'")
        if norm not in ("layer", "rms", "none"):
            raise ValueError(f"norm={norm!r}; use 'layer', 'rms' or 'none'")
        self.dtype = as_dtype(dtype)
        self.kernel = kernel
        self.pool = pool
        self.stride = 2 if pool == "stride" else 1
        self.weight = nn.Parameter(torch.empty(features, in_features, kernel))
        self.bias = nn.Parameter(torch.zeros(features))
        self.norm = None if norm == "none" else ChannelNorm(features, norm, self.dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        # flax's kernel is (k, in, out): fan-in k · in
        lecun_normal_(self.weight, self.weight.shape[1] * self.kernel, generator)
        with torch.no_grad():
            self.bias.zero_()
        if self.norm is not None:
            self.norm.reset_parameters(generator)

    def forward(self, x):
        x = F.pad(x, same_padding(x.shape[-1], self.kernel, self.stride))
        x = F.conv1d(x, self.weight.to(self.dtype), self.bias.to(self.dtype),
                     stride=self.stride)
        if self.norm is not None:
            x = self.norm(x)
        x = F.relu(x)
        if self.pool == "max":
            x = F.max_pool1d(x, 2, 2)
        return x


class CNN1D(nn.Module):
    """1-D CNN over raw (B, T, C) windows: conv blocks, global average pool
    over time, dropout, Dense(128) → ReLU → Dense head."""

    def __init__(
        self,
        num_classes: int = 6,
        channels: Sequence[int] = (64, 128, 128),
        kernel: int = 5,
        dropout_rate: float = 0.3,
        dtype=torch.bfloat16,
        pool: str = "max",
        norm: str = "layer",
        in_features: int = 3,
    ):
        super().__init__()
        self.dtype = as_dtype(dtype)
        self.dropout_rate = dropout_rate
        widths = [in_features, *channels]
        self.blocks = nn.ModuleList(
            ConvBlock(a, b, kernel, self.dtype, pool=pool, norm=norm)
            for a, b in zip(widths[:-1], widths[1:])
        )
        self.fc = Dense(widths[-1], 128, self.dtype)
        self.head = Dense(128, num_classes, self.dtype)
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for module in (*self.blocks, self.fc, self.head):
            module.reset_parameters(generator)

    def forward(self, x, train: bool = False, generator: torch.Generator | None = None):
        x = x.to(self.dtype).transpose(1, 2)  # (B, C, T)
        for block in self.blocks:
            x = block(x)
        x = x.mean(-1)  # global average pool over time
        x = _maybe_dropout(x, self.dropout_rate, train, generator)
        return self.head(F.relu(self.fc(x))).float()


class FusedBiLSTMLayer(nn.Module):
    """Both LSTM directions as one recurrence (see the module doc):
    (B, T, I) → (B, T, 2H), the forward direction's h then the backward
    one's, in ``dtype``."""

    def __init__(self, in_features: int, hidden: int, dtype=torch.bfloat16,
                 bf16_stream: bool = False, remat: bool = False):
        super().__init__()
        self.hidden = hidden
        self.dtype = as_dtype(dtype)
        self.stream_dtype = self.dtype if bf16_stream else torch.float32
        self.remat = remat
        self.wx = nn.Parameter(torch.empty(2, in_features, 4 * hidden))
        self.wh = nn.Parameter(torch.empty(2, hidden, 4 * hidden))
        self.bias = nn.Parameter(torch.zeros(2, 4 * hidden))

    def reset_parameters(self, generator: torch.Generator) -> None:
        # flax's variance_scaling counts the direction axis in the fan-in
        lecun_normal_(self.wx, 2 * self.wx.shape[1], generator)
        with torch.no_grad():
            nn.init.orthogonal_(self.wh.view(-1, self.wh.shape[-1]), generator=generator)
            self.bias.zero_()

    def _matmul(self, a, b):
        """a·b with both rounded to ``dtype`` and a float32 result."""
        return torch.matmul(a.to(self.dtype).float(), b.to(self.dtype).float())

    def _step(self, xt, h, c, wh):
        gates = xt.float() + self._matmul(h, wh)  # (2, B, 4H)
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        h = torch.sigmoid(go) * torch.tanh(c)
        return h.to(self.stream_dtype), c

    def forward(self, x):
        b = x.shape[0]
        xs = torch.stack([x, x.flip(1)])  # (2, B, T, I)
        xproj = (self._matmul(xs, self.wx[:, None]) + self.bias[:, None, None, :]).to(
            self.stream_dtype
        )  # (2, B, T, 4H): every step of both directions at once
        h = x.new_zeros((2, b, self.hidden), dtype=self.stream_dtype)
        c = x.new_zeros((2, b, self.hidden), dtype=torch.float32)
        hs = []
        # unbound once: a step's slice of xproj taken by indexing would
        # backpropagate through a zero-filled copy of all of xproj
        for xt in xproj.unbind(2):
            if self.remat and torch.is_grad_enabled():
                h, c = checkpoint(self._step, xt, h, c, self.wh, use_reentrant=False)
            else:
                h, c = self._step(xt, h, c, self.wh)
            hs.append(h)
        hs = torch.stack(hs)  # (T, 2, B, H)
        fwd = hs[:, 0].transpose(0, 1)
        bwd = hs.flip(0)[:, 1].transpose(0, 1)  # undo the time reversal
        return torch.cat([fwd, bwd], dim=-1).to(self.dtype)


class BiLSTM(nn.Module):
    """Bidirectional LSTM over raw windows: fused layers, mean over time,
    dropout, Dense head."""

    def __init__(
        self,
        num_classes: int = 6,
        hidden: int = 128,
        num_layers: int = 1,
        dropout_rate: float = 0.2,
        dtype=torch.bfloat16,
        bf16_stream: bool = False,
        remat: bool = False,
        in_features: int = 3,
    ):
        super().__init__()
        self.dtype = as_dtype(dtype)
        self.dropout_rate = dropout_rate
        self.layers = nn.ModuleList(
            FusedBiLSTMLayer(in_features if i == 0 else 2 * hidden, hidden,
                             self.dtype, bf16_stream=bf16_stream, remat=remat)
            for i in range(num_layers)
        )
        self.head = Dense(2 * hidden, num_classes, self.dtype)
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for module in (*self.layers, self.head):
            module.reset_parameters(generator)

    def forward(self, x, train: bool = False, generator: torch.Generator | None = None):
        x = x.to(self.dtype)
        for layer in self.layers:
            x = layer(x)
        x = _maybe_dropout(x.mean(1), self.dropout_rate, train, generator)
        return self.head(x).float()


MODEL_REGISTRY = {
    "mlp": MLP,
    "cnn1d": CNN1D,
    "bilstm": BiLSTM,
    "transformer": Transformer1D,
}


def build_model(name: str, num_classes: int, **kwargs) -> nn.Module:
    try:
        cls = MODEL_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown neural model {name!r}; have {sorted(MODEL_REGISTRY)}"
        ) from None
    return cls(num_classes=num_classes, **kwargs)
