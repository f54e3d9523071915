"""Transformer encoder classifier over raw accelerometer windows.

Port of ``har_tpu/models/transformer.py`` (``EncoderBlock``,
``Transformer1D``, ``sinusoidal_positions``) as ``torch.nn`` modules with
the flax modules' numerics:

- parameters are float32 and are cast, with the input, to the compute
  ``dtype`` (bfloat16 by default) at use, as ``flax.linen.Dense(dtype=...)``
  does; logits leave in float32;
- LayerNorm has epsilon 1e-6 and takes its statistics in float32
  (E[x²] − E[x]², clipped at 0); GELU is the tanh approximation;
- Dense and patch kernels start from flax's ``lecun_normal`` (a normal
  truncated at two standard deviations), biases at zero, LayerNorm scales
  at one, all drawn from an explicit ``torch.Generator``.

Attention.  With ``use_flash`` left at None (or True) every attention, the
unpacked and the segment-folded one, goes through kernel K2
(``ops.flash_attention``): on CUDA tensors it launches the kernel, on CPU
tensors it takes the kernel's plain version.  ``use_flash=False`` keeps the
JAX meaning: the plain ``full_attention`` / ``segment_attention``.  The JAX
package's TPU dispatch policy (``_FLASH_AUTO_T``, ``MIN_HEAD_DIM``,
``_MIN_SEG``) is not copied.

``patch_size`` > 1 embeds non-overlapping patches: the JAX package's
strided VALID convolution, whose kernel equals its stride, is a reshape
and one matmul here.  ``window_pack`` packs windows into one
block-diagonal sequence after the positions are added, zero-pads the batch
to the pack and slices the padding back off after per-window pooling.
``scan_layers`` names the JAX package's stacked parameter layout
(``convert.transformer_params_from_flax`` unstacks it); the port runs its
encoder stack as a Python loop either way.

``sp_axis`` names the mesh axis (``parallel.mesh.use_mesh``) or gives the
process group over which the sequence is sharded: each rank holds a
(B, T/sp, C) block of every window.  The positions of a block start at
its rank's offset, rank × T_local; each attention is a ring over the group
(``parallel.ring_attention``), and the pooled mean is the mean of the
ranks' means (equal blocks), so every rank returns the whole logits.  The
ring's route follows ``use_flash`` as the unsharded attention does, not
the JAX package's TPU rule: with ``use_flash`` None (or True) each hop
launches K2 (``ring_flash_attention``), whose own check refuses a head dim
it cannot take; ``use_flash=False`` is the plain ring.  ``window_pack``
and ``sp_axis`` are mutually exclusive.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from har_tpu_torch.ops.flash_attention import (
    flash_attention,
    segment_attention,
    segment_flash_attention,
)
from har_tpu_torch.parallel.mesh import resolve_group
from har_tpu_torch.parallel.ring_attention import (
    full_attention,
    ring_attention,
    ring_flash_attention,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# flax's truncated-normal initializers divide by the standard deviation of
# a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}: use {sorted(_DTYPES)}") from None


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator):
    """flax ``lecun_normal``: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(
            weight, std=std, a=-2 * std, b=2 * std, generator=generator
        )


class Dense(nn.Module):
    """``flax.linen.Dense``: weight (out, in) and bias in float32, cast
    with the input to ``dtype`` at use."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        return F.linear(
            x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype)
        )


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm``: epsilon 1e-6, float32 statistics."""

    def __init__(self, dim: int, dtype: torch.dtype, eps: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.dtype)


class EncoderBlock(nn.Module):
    """Pre-norm encoder block: fused QKV projection, bidirectional
    attention (optionally block-diagonal over segments of ``seg``
    tokens), output projection, GELU MLP of width 4·E."""

    def __init__(self, embed_dim: int, num_heads: int, dtype: torch.dtype,
                 use_flash: bool | None = None, sp_axis=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(
                f"embed_dim {embed_dim} is not a multiple of num_heads {num_heads}"
            )
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.sp_axis = sp_axis
        self.norm1 = LayerNorm(embed_dim, dtype)
        self.qkv = Dense(embed_dim, 3 * embed_dim, dtype)
        self.proj = Dense(embed_dim, embed_dim, dtype)
        self.norm2 = LayerNorm(embed_dim, dtype)
        self.mlp_in = Dense(embed_dim, 4 * embed_dim, dtype)
        self.mlp_out = Dense(4 * embed_dim, embed_dim, dtype)

    def forward(self, x, seg: int | None = None):
        b, t, e = x.shape
        h = self.num_heads
        # q, k, v stay views of the fused projection: the kernel reads
        # them through their strides
        q, k, v = (
            z.view(b, t, h, e // h) for z in self.qkv(self.norm1(x)).split(e, dim=-1)
        )
        attn = self.attend(q, k, v, seg)
        x = x + self.proj(attn.reshape(b, t, e))
        y = self.mlp_out(F.gelu(self.mlp_in(self.norm2(x)), approximate="tanh"))
        return x + y

    def attend(self, q, k, v, seg: int | None = None):
        """The attention of (B, T, H, D) ``q``, ``k``, ``v``: K2 unless
        ``use_flash`` is False, over segments of ``seg`` tokens or the
        sequence ring where asked.  A tensor-parallel copy of the block
        (``serve.model_parallel``) replaces it with one that runs it on
        each device's heads."""
        flash = self.use_flash is not False
        if seg is not None:
            return (segment_flash_attention if flash else segment_attention)(q, k, v, seg)
        if self.sp_axis is not None:
            return (ring_flash_attention if flash else ring_attention)(q, k, v, self.sp_axis)
        return (flash_attention if flash else full_attention)(q, k, v)


class Transformer1D(nn.Module):
    """Encoder classifier: (B, T, C) raw windows → (B, num_classes)
    float32 logits."""

    def __init__(
        self,
        num_classes: int = 6,
        embed_dim: int = 64,
        num_heads: int = 4,
        num_layers: int = 2,
        dropout_rate: float = 0.1,
        dtype=torch.bfloat16,
        sp_axis: str | None = None,
        use_flash: bool | None = None,
        patch_size: int = 1,
        window_pack: int = 1,
        scan_layers: bool = False,
        in_features: int = 3,
    ):
        super().__init__()
        if window_pack > 1 and sp_axis is not None:
            raise ValueError(
                "window_pack and sp_axis are mutually exclusive: the ring "
                "sequence-shards one long window, packing glues many short ones"
            )
        if patch_size < 1 or window_pack < 1:
            raise ValueError(
                f"patch_size and window_pack must be >= 1; got {patch_size}, "
                f"{window_pack}"
            )
        self.num_classes = num_classes
        self.embed_dim = embed_dim
        self.dropout_rate = dropout_rate
        self.dtype = as_dtype(dtype)
        self.patch_size = patch_size
        self.window_pack = window_pack
        self.scan_layers = scan_layers
        self.sp_axis = sp_axis
        if patch_size > 1:
            self.patch_embed = Dense(patch_size * in_features, embed_dim, self.dtype)
        else:
            self.embed = Dense(in_features, embed_dim, self.dtype)
        self.blocks = nn.ModuleList(
            EncoderBlock(embed_dim, num_heads, self.dtype, use_flash, sp_axis)
            for _ in range(num_layers)
        )
        self.norm = LayerNorm(embed_dim, self.dtype)
        self.head = Dense(embed_dim, num_classes, self.dtype)
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initial values, drawn from ``generator`` (a CPU
        generator gives the same parameters for every device)."""
        for module in self.modules():
            if isinstance(module, (Dense, LayerNorm)):
                module.reset_parameters(generator)

    def forward(self, x, train: bool = False, generator: torch.Generator | None = None):
        x = x.to(self.dtype)
        b, t, c = x.shape
        p = self.patch_size
        if p > 1:
            if t % p:
                raise ValueError(
                    f"sequence length {t} must be divisible by patch_size {p}"
                )
            t //= p
            x = self.patch_embed(x.reshape(b, t, p * c))
        else:
            x = self.embed(x)
        # positions are per window and added BEFORE packing, so a packed
        # window carries the encoding it would carry alone
        offset = 0.0
        if self.sp_axis is not None:  # global position = rank × block length
            offset = float(dist.get_rank(resolve_group(self.sp_axis)) * t)
        x = x + sinusoidal_positions(t, self.embed_dim, offset, device=x.device).to(self.dtype)
        seg = None
        pack = self.window_pack
        if pack > 1:
            pad = (-b) % pack
            if pad:
                x = torch.cat([x, x.new_zeros((pad, t, self.embed_dim))], dim=0)
            x = x.reshape((b + pad) // pack, pack * t, self.embed_dim)
            seg = t
        for block in self.blocks:
            x = block(x, seg)
        x = self.norm(x)
        if pack > 1:
            # per-window mean pool, then drop the padding windows
            pooled = x.reshape(-1, pack, t, self.embed_dim).mean(2)
            pooled = pooled.reshape(-1, self.embed_dim)[:b]
        else:
            pooled = x.mean(1)
            if self.sp_axis is not None:
                # local mean → global mean (equal blocks on the ring)
                pooled = _SpMean.apply(pooled, resolve_group(self.sp_axis))
        if train and self.dropout_rate > 0:
            pooled = dropout(pooled, self.dropout_rate, generator)
        return self.head(pooled).float()


class _SpMean(torch.autograd.Function):
    """The mean of every rank's ``x`` over ``group``; each rank's share of
    the cotangent is its own 1/n (every rank holds the same loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        out = x.float().clone()
        dist.all_reduce(out, group=group)
        return (out / ctx.n).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def dropout(x, rate: float, generator: torch.Generator | None):
    """``flax.linen.Dropout``: keep with probability 1 − rate, scale the
    kept values by 1 / (1 − rate)."""
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def sinusoidal_positions(t: int, dim: int, offset: float = 0.0, device=None):
    """Standard sin/cos positional encoding, [sin | cos] halves, float32."""
    pos = torch.arange(t, dtype=torch.float32, device=device) + offset
    half = dim // 2
    freqs = torch.exp(
        -math.log(10000.0)
        * torch.arange(half, dtype=torch.float32, device=device)
        / half
    )
    angles = pos[:, None] * freqs[None, :]
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)
