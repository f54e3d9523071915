"""Ring attention: exact attention with the sequence sharded over ranks.

Port of ``har_tpu/parallel/ring_attention.py``.  Each rank of a
sequence-parallel group holds a (B, T/sp, H, D) block of q, k and v.  K and
V rotate around the ring — rank i sends its block to rank i+1 with
``torch.distributed.batch_isend_irecv`` — while every rank accumulates its
queries' attention over the blocks it meets, so after ``sp`` hops the
result is exact full attention, and no rank ever holds more than a
(T/sp) x (T/sp) score block.

- :func:`full_attention`: the plain O(T²) attention on one device.
- :func:`ring_attention`: the plain ring, a streaming softmax in float32
  (running max, numerator and denominator) over einsum score blocks, one
  :func:`plain_hop` a hop.
- :func:`ring_flash_attention`: each hop is one launch of kernel K2 with
  its lse (``ops.flash_attention.flash_attention_with_lse``) and the hops
  merge by logaddexp (:func:`ring_hop`):
  ``out = Σ_i out_i · exp(lse_i − L)``, ``L = log Σ_i exp(lse_i)``.

The group is named by a mesh axis (resolved in the current mesh,
``parallel.mesh.use_mesh``) or given as a process group.  Gradients flow:
the rotation's backward sends each cotangent back one rank, and K2's
registered backward includes the lse cotangent.  The layout is
(B, T, H, D); the batch may also be sharded over another axis.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from har_tpu_torch.parallel.mesh import resolve_group


def full_attention(q, k, v):
    """Reference O(T²) attention, (B, T, H, D) layout, no masking, in the
    inputs' dtype throughout (as the JAX einsums run)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _send_recv(tensors, group, shift: int):
    """Each tensor sent ``shift`` ranks on around the group, the one from
    ``shift`` ranks back received."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    out = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), dst, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, o, src, group) for o in out]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    """K and V one rank on around the ring; the cotangents one rank back."""

    @staticmethod
    def forward(ctx, group, k, v):
        ctx.group = group
        return tuple(_send_recv([k, v], group, 1))

    @staticmethod
    def backward(ctx, gk, gv):
        gk, gv = _send_recv([gk, gv], ctx.group, -1)
        return None, gk, gv


def ring_shift(k, v, group):
    """(k, v) of the previous rank of ``group`` (differentiable)."""
    if dist.get_world_size(group) == 1:
        return k, v
    return _RingShift.apply(group, k, v)


def plain_hop(q, k_blk, v_blk, state):
    """One hop of :func:`ring_attention`: the streaming softmax over the
    block met, in float32, ``state`` the running (max (B,H,T), numerator
    (B,H,T,D), denominator (B,H,T)); start from :func:`plain_start`."""
    m, num, den = state
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_blk.float()) * scale
    new_m = torch.maximum(m, s.amax(-1))
    corr = torch.exp(m - new_m)
    p = torch.exp(s - new_m[..., None])
    num = num * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_blk.float())
    return new_m, num, den * corr + p.sum(-1)


def plain_start(q):
    b, t, h, d = q.shape
    return (torch.full((b, h, t), float("-inf"), device=q.device),
            torch.zeros((b, h, t, d), device=q.device),
            torch.zeros((b, h, t), device=q.device))


def plain_finish(state, dtype):
    """The output block (B,T,H,D) of a finished plain ring."""
    _, num, den = state
    return (num / den[..., None]).to(dtype).permute(0, 2, 1, 3)


def ring_attention(q, k, v, axis):
    """Exact attention with the sequence sharded over ``axis`` (a mesh
    axis name or a process group): q, k, v are this rank's (B, T_local,
    H, D) blocks; returns the local block of the output."""
    group = resolve_group(axis)
    n = dist.get_world_size(group)
    state = plain_start(q)
    k_blk, v_blk = k, v
    for hop in range(n):
        state = plain_hop(q, k_blk, v_blk, state)
        if hop + 1 < n:
            k_blk, v_blk = ring_shift(k_blk, v_blk, group)
    return plain_finish(state, q.dtype)


def ring_hop(q, k_blk, v_blk, out_acc, lse_acc):
    """One hop of :func:`ring_flash_attention`: K2 with its lse on the
    block met, merged into the running (out (B,T,H,D) float32, lse
    (B,H,T) float32) by logaddexp.  Start from zeros and ``-inf``."""
    from har_tpu_torch.ops.flash_attention import flash_attention_with_lse

    out_i, lse_i = flash_attention_with_lse(q, k_blk, v_blk)
    lse_new = torch.logaddexp(lse_acc, lse_i)

    def weight(lse):  # (B,H,T) → (B,T,H,1)
        return torch.exp(lse - lse_new).permute(0, 2, 1)[..., None]

    out_acc = out_acc * weight(lse_acc) + out_i.float() * weight(lse_i)
    return out_acc, lse_new


def flash_start(q):
    b, t, h, d = q.shape
    return (torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device),
            torch.full((b, h, t), float("-inf"), device=q.device))


def ring_flash_attention(q, k, v, axis):
    """Ring attention whose hops each run kernel K2 (with lse) on the
    local blocks, merged exactly by :func:`ring_hop`.  q, k, v are this
    rank's (B, T_local, H, D) blocks of ``axis`` (a mesh axis name or a
    process group); returns the local output block in q's dtype."""
    group = resolve_group(axis)
    n = dist.get_world_size(group)
    out, lse = flash_start(q)
    k_blk, v_blk = k, v
    for hop in range(n):
        out, lse = ring_hop(q, k_blk, v_blk, out, lse)
        if hop + 1 < n:
            k_blk, v_blk = ring_shift(k_blk, v_blk, group)
    return out.to(q.dtype)
