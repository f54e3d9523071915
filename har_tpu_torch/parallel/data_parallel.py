"""Data-parallel training steps over a mesh of ranks.

Port of ``har_tpu/parallel/data_parallel.py``.  The JAX step is one
``shard_map`` program with a ``psum`` over ``dp``; here every rank runs the
same Python step on its shard of the batch and sums over the data axes
with ``torch.distributed.all_reduce``:

    local forward and backward on this rank's rows → the weighted loss
    sum, the weight sum and the gradients of the sum → one all-reduce of
    all three over each data axis → the optimizer steps on the gradient
    of the global mean, the same update on every rank.

Rows of padding carry weight 0 and count for nothing.  Parameters and the
optimizer state are replicated (ZeRO-1, ``parallel.zero1``, shards the
state).  On a mesh with a ``tp`` axis the parameters are DTensors
(``parallel.tensor_parallel``) and the all-reduce sums their local shards.

- :func:`make_dp_train_step` is the one step body: the JAX factory's
  contract over any ``loss_fn(params, *batch, mask) -> (loss_sum,
  count)``.  ``train.Trainer`` builds its step from it with
  :func:`make_module_step` (with no mesh, the single-device step: no
  group to sum over); :func:`make_fit` and :func:`make_batch_step` run
  that step over a staged schedule or one streamed batch (the
  tensor-parallel and ZeRO-1 factories).
- :func:`jit_replicated` runs a whole-dataset function on DTensors whose
  rows are sharded, and returns its result whole on every rank.
"""

from __future__ import annotations

import contextlib
import inspect
from typing import Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F

from har_tpu_torch.parallel.mesh import (
    data_groups,
    data_shard_count,
    linear_data_shard_index,
)


def _local(t):
    """A DTensor's local shard laid out as its parameter's, or the tensor."""
    return t.to_local() if hasattr(t, "to_local") else t


def all_reduce_grads(params, loss_sum, count, groups):
    """Sum ``loss_sum``, ``count`` and every ``param.grad`` over each
    group of ``groups`` in turn (one flat all-reduce a group), in place on
    the gradients; returns the summed (loss_sum, count) as plain tensors.
    A DTensor gradient is first placed as its parameter is (a replicated
    parameter's ``Partial`` gradient is reduced over tp), with or without
    a data group."""
    loss_sum, count = _local(loss_sum).detach(), _local(count).detach()
    grads = []
    for p in params:
        g = p.grad
        if hasattr(g, "redistribute") and tuple(g.placements) != tuple(p.placements):
            g = p.grad = g.redistribute(p.device_mesh, p.placements)
        grads.append(_local(g))
    if not groups:
        return loss_sum, count
    head = torch.stack([loss_sum.float(), count.float()])
    flat = torch.cat([head] + [g.reshape(-1).float() for g in grads])
    for group in groups:
        dist.all_reduce(flat, group=group)
    off = 2
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
    return flat[0], flat[1]


def gather_data_shards(part: torch.Tensor, mesh) -> torch.Tensor:
    """Every data shard's ``part`` concatenated along dim 0 in linear
    shard order (the innermost data axis gathered first), on every
    rank."""
    for group in reversed(data_groups(mesh)):
        parts = [torch.empty_like(part) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, part.contiguous(), group=group)
        part = torch.cat(parts)
    return part


def make_dp_train_step(
    loss_fn: Callable,
    optimizer,
    mesh,
    n_batch: int = 2,
    context: Callable = contextlib.nullcontext,
    min_count: float | None = 1.0,
) -> Callable:
    """``step(params, *batch, mask) -> loss``.

    ``loss_fn(params, *batch, mask)`` returns the sum of per-example
    losses on the local shard and the local example count (``mask``'s
    sum, or a weight sum); the step sums both and the gradients over the
    data axes, divides each gradient by the global count (clamped below
    at ``min_count``, as the JAX step clamps at 1; None leaves it) and
    calls ``optimizer.step()`` (an optimizer over ``params``' tensors).
    ``params`` is a dict or a sequence of tensors; batch arrays are this
    rank's shard: tensors, or DTensors whose local shard is used.
    ``context`` wraps the forward and backward and the update (the
    DTensor replication of a tp step).  Returns the global mean loss."""
    groups = data_groups(mesh)

    def step(params, *batch_and_mask):
        if len(batch_and_mask) != n_batch + 1:
            raise ValueError(f"step takes {n_batch} batch arrays and a mask")
        *batch, mask = (_local(b) for b in batch_and_mask)
        leaves = list(params.values()) if isinstance(params, dict) else list(params)
        for p in leaves:
            p.grad = None
        with context():
            loss_sum, count = loss_fn(params, *batch, mask)
            loss_sum.backward()
        leaves = [p for p in leaves if p.grad is not None]
        loss_sum, count = all_reduce_grads(leaves, loss_sum, count, groups)
        if min_count is not None:
            count = torch.clamp(count, min=min_count)
        with torch.no_grad():
            for p in leaves:
                _local(p.grad).div_(count)
        with context():
            optimizer.step()
        return loss_sum / count

    return step


def shard_columns(mesh, batch: int) -> slice:
    """This rank's columns of a batch of ``batch`` rows: the JAX fit's
    ``P(None, dp)`` over the batch axis, in linear shard order (every
    column with no mesh)."""
    if mesh is None:
        return slice(None)
    n = data_shard_count(mesh)
    if batch % n:
        raise ValueError(
            f"batch_size {batch} must be divisible by the data-parallel "
            f"shard count ({n})"
        )
    per = batch // n
    s = linear_data_shard_index(mesh)
    return slice(s * per, (s + 1) * per)


def make_module_step(module, optimizer, mesh, augment=None, generators=None,
                     context=contextlib.nullcontext, min_count=None) -> Callable:
    """``step(xb, yb, wb) -> global mean loss``: :func:`make_dp_train_step`
    over the module's parameters and its training forward, on this rank's
    rows of one batch (``wb`` each row's weight; ``augment`` and dropout
    draw from this data shard's ``generators``), the gradient that of the
    global weighted mean (the JAX trainer's, with no clamp on the weight
    sum unless ``min_count`` gives one)."""

    def loss_fn(params, xb, yb, wb):
        if augment is not None:
            xb = augment(generators["augment"], xb)
        logits = module(xb, train=True, generator=generators["dropout"])
        return (F.cross_entropy(logits, yb, reduction="none") * wb).sum(), wb.sum()

    dp_step = make_dp_train_step(loss_fn, optimizer, mesh, context=context,
                                 min_count=min_count)
    return lambda xb, yb, wb: dp_step(list(module.parameters()), xb, yb, wb)


def make_fit(module, optimizer, mesh, augment=None, class_weights=None,
             generators=None, context=contextlib.nullcontext):
    """``fit(x, y, batch_idx) -> [per-step global mean loss]``: the staged
    schedule, each rank on its columns of every batch of ``batch_idx``
    (steps, batch) over replicated ``x``/``y``; the module trains in
    place."""
    step = make_module_step(module, optimizer, mesh, augment, generators, context)

    def fit(x, y, batch_idx):
        local_idx = batch_idx[:, shard_columns(mesh, batch_idx.shape[1])]
        module.train()
        losses = []
        for idx in local_idx:
            yb = y[idx]
            wb = (class_weights[yb] if class_weights is not None
                  else torch.ones(yb.shape, device=yb.device))
            losses.append(step(x[idx], yb, wb))
        module.eval()
        return losses

    return fit


def make_batch_step(module, optimizer, mesh, augment=None, generators=None,
                    context=contextlib.nullcontext, min_count=None):
    """``step(x, y, mask) -> loss``: one streamed batch that every rank
    holds whole; the rank trains on its rows, ``mask`` each row's weight
    (the JAX streaming step's masked mean)."""
    step = make_module_step(module, optimizer, mesh, augment, generators, context,
                            min_count)

    def batch_step(x, y, mask):
        cols = shard_columns(mesh, x.shape[0])
        module.train()
        return step(x[cols], y[cols], mask[cols])

    return batch_step


def jit_replicated(fn: Callable, mesh, batch_argnums: tuple[int, ...] = (0,)) -> Callable:
    """``fn`` over arguments every rank holds whole: the batch arguments
    sharded by rows over the data axes, the others replicated, as
    DTensors; DTensor propagates the reductions ``fn`` implies, and the
    result comes back whole on every rank.  ``fn`` must have a fixed
    positional signature."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from har_tpu_torch.parallel.sharding import batch_sharding, replicated

    params = inspect.signature(fn).parameters.values()
    if any(p.kind in (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
           for p in params):
        raise ValueError("jit_replicated requires a fixed-arity function")

    def run(*args):
        placed = [
            distribute_tensor(torch.as_tensor(a), mesh,
                              batch_sharding(mesh) if i in batch_argnums else replicated(mesh))
            for i, a in enumerate(args)
        ]
        out = fn(*placed)
        return out.full_tensor() if isinstance(out, DTensor) else out

    return run
