"""Attention over the whole sequence on one device.

Port of ``har_tpu/parallel/ring_attention.py::full_attention``, the plain
unmasked route a transformer takes when its caller sets
``use_flash=False``.  The ring functions, which shard the sequence over a
mesh axis, wait for the parallel layer (ROADMAP.md Queue 1 item 14).
"""

from __future__ import annotations

import torch


def full_attention(q, k, v):
    """Reference O(T²) attention, (B, T, H, D) layout, no masking, in the
    inputs' dtype throughout (as the JAX einsums run)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
