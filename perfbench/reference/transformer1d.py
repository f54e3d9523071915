"""Plain reference of the encoder classifier over raw windows
(``Transformer1D``): float32, no kernels, no cache, no batching tricks.

Equations, for a (B, T, C) window batch x with embed width E, H heads of
D = E/H, L blocks and an MLP of width I:

    h = x Wₑᵀ + bₑ + P            P: sinusoidal positions, [sin | cos]
    per block:  a = LN₁(h);  q, k, v = split(a W_qkvᵀ + b_qkv)
                h = h + softmax(q kᵀ / √D) v W_oᵀ + b_o      (per head)
                h = h + GELU_tanh(LN₂(h) W₁ᵀ + b₁) W₂ᵀ + b₂
    logits = mean_T(LN(h)) W_hᵀ + b_h

LayerNorm has epsilon 1e-6.  Departures: none; dropout is 0 in every
configuration this reference serves (``assumed`` in its file).  The
parameters are named as the program's state dict names them, so the
benchmark can hand both sides one dict of initial weights.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.precision import matmul_f32


def dims(cfg: dict) -> tuple[int, int, int, int, int, int, int]:
    """(E, H, L, I, T, C, K) of a configuration file."""
    return (cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_hidden_layers"],
            cfg["intermediate_size"], cfg["window"], cfg["channels"], cfg["num_classes"])


def state_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter's name and shape, in the program's order."""
    e, _, layers, inner, _, c, k = dims(cfg)
    shapes = {"embed.weight": (e, c), "embed.bias": (e,)}
    for i in range(layers):
        p = f"blocks.{i}."
        shapes.update({
            p + "norm1.weight": (e,), p + "norm1.bias": (e,),
            p + "qkv.weight": (3 * e, e), p + "qkv.bias": (3 * e,),
            p + "proj.weight": (e, e), p + "proj.bias": (e,),
            p + "norm2.weight": (e,), p + "norm2.bias": (e,),
            p + "mlp_in.weight": (inner, e), p + "mlp_in.bias": (inner,),
            p + "mlp_out.weight": (e, inner), p + "mlp_out.bias": (e,),
        })
    shapes.update({"norm.weight": (e,), "norm.bias": (e,),
                   "head.weight": (k, e), "head.bias": (k,)})
    return shapes


def positions(t: int, e: int, device) -> torch.Tensor:
    pos = torch.arange(t, dtype=torch.float32, device=device)
    half = e // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=device) / half)
    angles = pos[:, None] * freqs[None, :]
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def forward(p: dict, x: torch.Tensor, cfg: dict, mm=matmul_f32) -> torch.Tensor:
    """float32 logits (B, K) of windows x (B, T, C)."""
    e, h, layers, _, t, _, _ = dims(cfg)
    d = e // h
    b = x.shape[0]

    def dense(z, name):
        return mm(z, p[name + ".weight"].t()) + p[name + ".bias"]

    def norm(z, name):
        return F.layer_norm(z, (e,), p[name + ".weight"], p[name + ".bias"], eps=1e-6)

    z = dense(x.float(), "embed") + positions(t, e, x.device)
    for i in range(layers):
        blk = f"blocks.{i}."
        q, k, v = (u.reshape(b, t, h, d).transpose(1, 2)
                   for u in dense(norm(z, blk + "norm1"), blk + "qkv").split(e, dim=-1))
        att = torch.softmax(mm(q, k.transpose(-1, -2)) * d ** -0.5, dim=-1)
        o = mm(att, v).transpose(1, 2).reshape(b, t, e)
        z = z + dense(o, blk + "proj")
        z = z + dense(F.gelu(dense(norm(z, blk + "norm2"), blk + "mlp_in"),
                             approximate="tanh"), blk + "mlp_out")
    return dense(norm(z, "norm").mean(1), "head")


def flops_per_window(cfg: dict, train: bool) -> float:
    """The model's FLOPs for one window, by closed form: 2 per
    multiply-add of every dense product (the head once a window, the
    rest once a position) and of attention's two (T, T) products; a
    training step counts 3× the forward (forward, and the backward's
    two products per forward product).  No recompute is counted."""
    e, _, layers, inner, t, c, k = dims(cfg)
    dense = t * (c * e + layers * (4 * e * e + 2 * e * inner)) + e * k
    attention = 2 * layers * t * t * e
    forward = 2 * (dense + attention)
    return 3 * forward if train else forward
