"""Bidirectional attention for the transformer: kernel K2 of the port.

Replaces ``har_tpu/ops/flash_attention.py::_flash_kernel`` (with its
``_online_softmax_step``, launched by ``_flash_bht``), the fused attention
forward the JAX package writes in Pallas.  Public functions keep the JAX
``(B, T, H, D)`` layout::

    flash_attention(q, k, v)            -> out (B, T, H, D), q's dtype
    flash_attention_with_lse(q, k, v)   -> out, lse (B, H, T) float32
    segment_flash_attention(q, k, v, seg)  block-diagonal, via the kernel
    segment_attention(q, k, v, seg)        block-diagonal, plain masked

- The forward of :func:`flash_attention` and :func:`flash_attention_with_lse`
  is one registered op, ``har_tpu_torch::flash_attention_fwd``
  (``torch.library.custom_op``): its CUDA registration launches the
  hand-written kernel ``csrc/flash_attention.cu`` (built by ``ops._build``
  at first use), or raises; on CPU tensors it is
  :func:`attention_with_lse_plain`.  Dispatch follows the tensors'
  device; there is no fallback from one to the other.  Its fake
  registration gives the output shapes, so ``torch.export`` keeps the op
  as one opaque node with a symbolic batch (``export.py``); a loaded
  program needs this module imported first.
- :func:`attention_with_lse_plain` is the same function in plain PyTorch,
  modelled on ``_attention_with_lse_ref``: float32 scores, ``p`` rounded to
  the input type before the PV product.
- The backward, the op's autograd registration, is plain PyTorch, as the
  reference's is XLA: a recompute through :func:`attention_with_lse_plain`
  for T <= ``_BWD_FULL_T``, else :func:`chunked_attention_bwd`
  (O(T·block) memory), both including the cotangent of ``lse``.
- On DTensors (a tensor-parallel step, ``parallel.tensor_parallel``) the
  op runs on each rank's local tensors inside ``local_map``: a shard of
  the batch or of the heads stays where it is, any other placement is
  gathered to ``Replicate`` first, and on CUDA tensors the kernel
  launches as on one device.
- ``FLASH_LAUNCHES`` counts kernel launches, so a run can show that its
  attention went through the kernel.
- The op's flop formula (4·B·H·T²·D) is registered with
  ``torch.utils.flop_counter``, so the trainer's FLOP count
  (``compute_flops``) includes the forward's attention.
- :func:`flash_plan` plans each bfloat16 launch (the kernel refuses a plan
  that disagrees with its own arithmetic).  On the *resident* route a
  block owns one batch row and ``heads_per_block`` heads with all T query
  rows of each, and loads their Q, K and V into shared memory once: it is
  taken while one head's Q, K and V (rows padded to the 32-key chunk) fit
  half of a Hopper SM's 227 KB, so two blocks share an SM; that holds for
  T up to 800 at D = 16 and 128 at D = 128.  A group of several heads
  gets 4 warps, each walking at most two 16-row tiles; the group is the
  widest divisor of H that fits and still leaves two blocks per SM (8
  heads of T = 25 give 4 heads a block).  One head alone takes up to
  :func:`max_warps` warps (the kernel's launch bounds), as few as its
  rounds of tiles allow (7 for T = 200).  Past the budget the *streamed*
  route gives a block ``16 * warps`` query rows of one head and streams
  32-key chunks of K and V through two shared-memory stages.  float32
  launches take the kernel's own f32 route and no plan.

The kernel's own limits are its guards, on every device: head dim a
multiple of 8 up to 128, float32 or bfloat16, any T >= 1.  The JAX
package's TPU guards (``MIN_HEAD_DIM``, ``pick_block``'s divisors, the
segment length's multiple of 8) do not apply to it.  What bounds the
kernel on the H100 and what its design does about it is in the source's
note and in PERF.md.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.utils.flop_counter

from har_tpu_torch.ops import _build
from har_tpu_torch.ops.hist import H100_SMS, sm_count

# kernel launches since import (or since the caller last reset it)
FLASH_LAUNCHES = 0

# below this T the backward recomputes the whole attention (its (B,H,T,T)
# scores are small); above it the chunked backward keeps memory at
# O(T·block).  Both are exact; the threshold is the reference's.
_BWD_FULL_T = 1024
_BWD_BLOCK_K = 128

_MAX_HEAD_DIM = 128
_HEAD_DIM_MULTIPLE = 8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# the bf16 kernel's plan: Hopper gives a block up to 227 KB of shared
# memory and reserves 1 KB a block; a block takes at most half, so two
# share an SM
_SMEM_BYTES = 232_448
_SMEM_BUDGET = _SMEM_BYTES // 2 - 1024
_ROW_TILE = 16  # query rows of a warp
_GROUP_WARPS = 4  # warps of a block that holds several heads
_KEY_CHUNK = 32  # keys per softmax update
_STAGES = 2  # key chunks in flight on the streamed route
_ROUTES = {"resident": 0, "streamed": 1}
_INT_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """One bfloat16 launch of the kernel: its route (``"resident"`` or
    ``"streamed"``), heads per block, warps per block, keys per softmax
    update, dynamic shared memory in bytes and blocks in the grid."""

    route: str
    heads_per_block: int
    warps: int
    key_chunk: int
    smem_bytes: int
    grid: int


def _padded_head_dim(d: int) -> int:
    return next(p for p in (16, 32, 64, 128) if d <= p)


def max_warps(d: int) -> int:
    """Warps a block may have at head dim ``d`` (the kernel's launch
    bounds): 7 at D <= 16, 8 up to 64, 4 above."""
    dp = _padded_head_dim(d)
    return 7 if dp <= 16 else 8 if dp <= 64 else 4


@functools.cache
def flash_plan(b: int, t: int, h: int, d: int, sm_count: int = H100_SMS) -> FlashPlan:
    """The bf16 kernel's launch for q, k, v of shape (b, t, h, d) on a card
    of ``sm_count`` SMs (see the module's note).  Shared rows are D padded
    to 16, 32, 64 or 128, plus 16 bytes."""
    if b * h > _INT_MAX:
        raise ValueError(f"flash attention of {b * h} heads is past the grid's {_INT_MAX}")
    row_bytes = (_padded_head_dim(d) + 8) * 2
    tiles = -(-t // _ROW_TILE)
    warps_cap = max_warps(d)
    # a head's Q, K and V, rows padded to a multiple of the key chunk
    head_bytes = 3 * -(-t // _KEY_CHUNK) * _KEY_CHUNK * row_bytes
    if head_bytes <= _SMEM_BUDGET:
        # several heads share a block of _GROUP_WARPS warps, two row tiles
        # a warp; one head takes up to max_warps warps, in balanced rounds
        groups = [
            n for n in range(h, 1, -1)
            if h % n == 0 and n * head_bytes <= _SMEM_BUDGET and n * tiles <= 2 * _GROUP_WARPS
        ]
        # the widest group that leaves two blocks per SM
        hpb = next((n for n in groups if b * (h // n) >= 2 * sm_count), 1)
        items = hpb * tiles
        cap = warps_cap if hpb == 1 else _GROUP_WARPS
        warps = -(-items // -(-items // cap))
        plan = FlashPlan("resident", hpb, warps, _KEY_CHUNK, hpb * head_bytes, b * (h // hpb))
    else:
        # enough query blocks for one block per SM, none wider than the cap
        # and none narrower than 4 warps (each re-reads the head's K and V)
        q_blocks = max(-(-tiles // warps_cap),
                       min(-(-tiles // 4), -(-sm_count // (b * h))))
        warps = -(-tiles // q_blocks)
        q_blocks = -(-tiles // warps)
        smem = (_ROW_TILE * warps + 2 * _STAGES * _KEY_CHUNK) * row_bytes
        plan = FlashPlan("streamed", 1, warps, _KEY_CHUNK, smem, b * h * q_blocks)
    if plan.grid > _INT_MAX:
        raise ValueError(
            f"flash attention of shape {(b, t, h, d)} needs {plan.grid} blocks, "
            f"past the grid's {_INT_MAX}"
        )
    return plan


def attention_with_lse_plain(q, k, v):
    """(out (B,T,H,D) in q's dtype, lse (B,H,T) float32) in plain PyTorch:
    the kernel's plain version and its backward's recompute."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum(
        "bhqk,bkhd->bqhd", p.to(q.dtype).float(), v.float()
    ).to(q.dtype)
    return out, lse


def chunked_attention_bwd(q, k, v, out, g, block_k: int, g_lse=None, lse=None):
    """Flash-style backward over key blocks, never materializing (T, T).

    Port of ``_chunked_attention_bwd``: dV = Pᵀ dO; dS = P ∘ (dP − D) with
    D = rowsum(dO ∘ O) (minus ``g_lse``, the lse cotangent, when given);
    dQ/dK from dS.  ``lse`` (B, H, T), when the forward saved it, skips the
    online-logsumexp pass.  Inputs (B, T, H, D); float32 inside; returns
    grads in the input dtype.  A ragged last key block is allowed.
    """
    in_dtype = q.dtype
    qh, kh, vh, oh, gh = (x.permute(0, 2, 1, 3).float() for x in (q, k, v, out, g))
    b, h, t, d = qh.shape
    scale = d**-0.5
    starts = range(0, t, block_k)
    if lse is not None:
        lse = lse.float()[..., None]  # (B, H, T, 1)
    else:
        m = torch.full((b, h, t, 1), float("-inf"), device=q.device)
        l = torch.zeros((b, h, t, 1), device=q.device)
        for s0 in starts:
            s = torch.einsum("bhtd,bhkd->bhtk", qh, kh[:, :, s0 : s0 + block_k]) * scale
            new_m = torch.maximum(m, s.amax(-1, keepdim=True))
            l = l * torch.exp(m - new_m) + torch.exp(s - new_m).sum(-1, keepdim=True)
            m = new_m
        lse = m + torch.log(l)
    d_vec = (gh * oh).sum(-1, keepdim=True)  # rowsum(dO ∘ O)
    if g_lse is not None:
        d_vec = d_vec - g_lse.float()[..., None]
    dq = torch.zeros_like(qh)
    dks, dvs = [], []
    for s0 in starts:
        kblk = kh[:, :, s0 : s0 + block_k]
        vblk = vh[:, :, s0 : s0 + block_k]
        s = torch.einsum("bhtd,bhkd->bhtk", qh, kblk) * scale
        p = torch.exp(s - lse)
        dvs.append(torch.einsum("bhtk,bhtd->bhkd", p, gh))
        dp = torch.einsum("bhtd,bhkd->bhtk", gh, vblk)
        ds = p * (dp - d_vec)
        dq = dq + scale * torch.einsum("bhtk,bhkd->bhtd", ds, kblk)
        dks.append(scale * torch.einsum("bhtk,bhtd->bhkd", ds, qh))
    to_bthd = lambda x: x.permute(0, 2, 1, 3).to(in_dtype)  # noqa: E731
    return to_bthd(dq), to_bthd(torch.cat(dks, 2)), to_bthd(torch.cat(dvs, 2))


def _check(q, k, v) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            "flash attention takes q, k, v of one (B, T, H, D) shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            "flash attention takes float32 or bfloat16 q, k, v of one "
            f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    d = q.shape[-1]
    if d % _HEAD_DIM_MULTIPLE or d > _MAX_HEAD_DIM:
        raise ValueError(
            f"flash attention needs a head dim that is a multiple of "
            f"{_HEAD_DIM_MULTIPLE} up to {_MAX_HEAD_DIM}; got {d}"
        )


@functools.cache
def _kernel():
    """The built kernel's C entry point, its argument types set."""
    fn = _build.load("flash_attention").har_flash_attention_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 9
        + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _aligned(x):
    """``x``, or a contiguous copy where the kernel's 16-byte copies would
    not be aligned (a start off 16 bytes, a stride off 8 elements)."""
    if x.data_ptr() % 16 or any(s % _HEAD_DIM_MULTIPLE for s in x.stride()[:3]):
        return x.clone(memory_format=torch.contiguous_format)
    return x


@functools.cache
def _check_hopper(device: torch.device) -> None:
    if torch.cuda.get_device_capability(device) != (9, 0):
        raise RuntimeError(
            "the flash attention kernel is built for sm_90a (Hopper); device "
            f"{torch.cuda.get_device_name(device)} is not one"
        )


def _launch(q, k, v, with_lse: bool):
    # the op's CUDA registration gets no device guard: the launch, the
    # C entry's shared-memory attribute and the stream are all those of
    # the tensors' device, whichever device is current (a serving mesh
    # scores shards on several cards from one process)
    with torch.cuda.device(q.device):
        return _launch_here(q, k, v, with_lse)


def _launch_here(q, k, v, with_lse: bool):
    global FLASH_LAUNCHES
    b, t, h, d = q.shape
    _check_hopper(q.device)
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("flash attention needs unit stride over the head dim")
    q, k, v = (_aligned(x) for x in (q, k, v))
    out = q.new_empty((b, t, h, d))
    lse = q.new_empty((b, h, t), dtype=torch.float32) if with_lse else None
    if out.numel() == 0:
        return out, lse
    plan = (
        flash_plan(b, t, h, d, sm_count(q.device.index))
        if q.dtype == torch.bfloat16
        else None
    )
    plan_args = (
        (_ROUTES[plan.route], plan.heads_per_block, plan.warps, plan.key_chunk,
         plan.smem_bytes, plan.grid)
        if plan is not None
        else (0,) * 6
    )
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        b, t, h, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        _DTYPE_CODES[q.dtype], *plan_args, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {err}")
    FLASH_LAUNCHES += 1
    return out, lse


def _on_one_cuda_device(q, k, v) -> None:
    if not all(x.is_cuda and x.device == q.device for x in (q, k, v)):
        raise ValueError(
            f"flash attention needs q, k, v on one device; got {q.device}, "
            f"{k.device}, {v.device}"
        )


@torch.library.custom_op("har_tpu_torch::flash_attention_fwd", mutates_args=())
def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, with_lse: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward as one registered op: (out (B,T,H,D) contiguous, lse
    (B,H,T) float32, or an empty (0,) tensor without ``with_lse``).  On CPU
    tensors it is the plain version; the CUDA registration below launches
    the kernel.  A traced or exported graph keeps it as one opaque node."""
    if not all(x.device.type == "cpu" for x in (q, k, v)):
        _on_one_cuda_device(q, k, v)
    out, lse = attention_with_lse_plain(q, k, v)
    return out.contiguous(), lse if with_lse else lse.new_empty((0,))


@flash_attention_fwd.register_kernel("cuda")
def _flash_attention_fwd_cuda(q, k, v, with_lse):
    _on_one_cuda_device(q, k, v)
    out, lse = _launch(q, k, v, with_lse)
    return out, lse if with_lse else out.new_empty((0,), dtype=torch.float32)


@flash_attention_fwd.register_fake
def _flash_attention_fwd_fake(q, k, v, with_lse):
    b, t, h, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((b, h, t) if with_lse else (0,),
                                             dtype=torch.float32)


def _setup_context(ctx, inputs, output):
    q, k, v, with_lse = inputs
    out, lse = output
    ctx.with_lse = with_lse
    ctx.save_for_backward(q, k, v, out, lse)


def _backward(ctx, g_out, g_lse):
    """The reference's ``_flash_bwd`` / ``_flash_lse_bwd`` in plain
    PyTorch: a recompute up to ``_BWD_FULL_T``, the chunked backward
    beyond, the lse cotangent included."""
    q, k, v, out, lse = ctx.saved_tensors
    if not ctx.with_lse:
        g_lse, lse = None, None
    if q.shape[1] <= _BWD_FULL_T:
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            o, l = attention_with_lse_plain(*leaves)
            outputs, grads = [o], [g_out]
            if g_lse is not None:
                outputs.append(l)
                grads.append(g_lse)
            dq, dk, dv = torch.autograd.grad(outputs, leaves, grads)
    else:
        dq, dk, dv = chunked_attention_bwd(
            q, k, v, out, g_out, _BWD_BLOCK_K, g_lse=g_lse, lse=lse
        )
    return dq, dk, dv, None


flash_attention_fwd.register_autograd(_backward, setup_context=_setup_context)


@torch.utils.flop_counter.register_flop_formula(torch.ops.har_tpu_torch.flash_attention_fwd)
def _flash_attention_fwd_flops(q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs):
    """The forward's matmul flops for FlopCounterMode, which counts an
    opaque op as 0 without a formula: Q·Kᵀ and P·V, 2·B·H·T²·D each.  The
    backward is plain PyTorch and is counted op by op."""
    b, t, h, d = q_shape
    return 4 * b * h * t * t * d


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _dtensor_fwd(q, k, v, with_lse: bool):
    """The op on DTensors (a tensor-parallel step): each rank launches it
    on its local rows or heads inside ``local_map``.  A mesh axis on which
    q, k and v share a ``Shard`` of the batch (dim 0) or of the heads
    (dim 2) keeps it; any other placement is redistributed to
    ``Replicate`` first (the sequence and head dim must be whole).  The
    backward is the op's own, on the local tensors."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    where = tuple(
        pq if pq == pk == pv and pq in (Shard(0), Shard(2)) else Replicate()
        for pq, pk, pv in zip(q.placements, k.placements, v.placements)
    )
    # lse is (B, H, T): the heads' shard moves to dim 1
    lse_where = tuple(Shard(1) if p == Shard(2) else p for p in where)

    def local(q, k, v):
        return flash_attention_fwd(q, k, v, with_lse)

    out_lse_where = lse_where if with_lse else tuple(Replicate() for _ in where)
    return local_map(
        local,
        out_placements=(where, out_lse_where),
        in_placements=(where, where, where),
        device_mesh=q.device_mesh,
        redistribute_inputs=True,
    )(q, k, v)


def flash_attention(q, k, v):
    """Fused attention, (B, T, H, D) layout, bidirectional."""
    _check(q, k, v)
    if _is_dtensor(q):
        return _dtensor_fwd(q, k, v, False)[0]
    return flash_attention_fwd(q, k, v, False)[0]


def flash_attention_with_lse(q, k, v):
    """Fused attention returning (out (B,T,H,D), lse (B,H,T) float32);
    ``lse[b,h,t] = log Σ_k exp(q·k/√d)``.  Gradients flow through both."""
    _check(q, k, v)
    if _is_dtensor(q):
        return _dtensor_fwd(q, k, v, True)
    return flash_attention_fwd(q, k, v, True)


def _fold_segments(x, seg: int):
    """(B, T, H, D) → (B·T/seg, seg, H, D), a view where x allows one."""
    b, t, h, d = x.shape
    return x.reshape(b * (t // seg), seg, h, d)


def segment_flash_attention(q, k, v, seg: int):
    """Block-diagonal attention through the kernel, (B, T, H, D): segments
    of length ``seg`` (T % seg == 0) attend only within themselves.  Each
    segment is folded into the batch, so the kernel does no off-diagonal
    work."""
    b, t, h, d = q.shape
    if t % seg:
        raise ValueError(f"segment length {seg} must divide T={t}")
    out = flash_attention(
        _fold_segments(q, seg), _fold_segments(k, seg), _fold_segments(v, seg)
    )
    return out.reshape(b, t, h, d)


def segment_attention(q, k, v, seg: int):
    """Block-diagonal attention as one masked product, (B, T, H, D), in
    plain PyTorch: float32 scores, an additive block-diagonal mask."""
    b, t, h, d = q.shape
    if t % seg:
        raise ValueError(f"segment length {seg} must divide T={t}")
    scale = d**-0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    seg_id = torch.arange(t, device=q.device) // seg
    mask = seg_id[:, None] == seg_id[None, :]
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum(
        "bhqk,bkhd->bqhd", p.to(q.dtype).float(), v.float()
    ).to(q.dtype)
