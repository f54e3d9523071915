"""Tensor parallelism: parameters as DTensors, collectives by propagation.

Port of ``har_tpu/parallel/tensor_parallel.py``.  JAX places parameters
with ``NamedSharding`` and lets GSPMD insert the collectives; here each
parameter becomes a ``torch.distributed.tensor.DTensor`` on the mesh's
``tp`` axis, placed as the JAX package places it (by default
:func:`dense_alternating_specs`, the layout both trainers use, or a rule
table of ``parallel.rules``), and DTensor's operator rules insert the
collectives the layout implies.  The forward runs under
``implicit_replication``, so the tensors a module makes (positions,
dropout masks) and the batch are replicated operands.

- The Megatron pair of a Dense stack: a column-parallel weight
  ``Shard(0)`` leaves the activations sharded on the hidden dim, and the
  row-parallel weight after it ``Shard(1)`` turns them into a partial sum,
  reduced (one all-reduce) where a replicated operand meets it.
- ``Transformer1D`` under ``TRANSFORMER_RULES`` has its qkv weight
  column-split, so a tp shard holds a slice of the concatenated q|k|v
  columns, not whole heads.  Splitting q, k and v along the sharded dim
  is not local, and DTensor redistributes the projection to
  ``Replicate`` (an all-gather of the (B, T, 3E) activation) before the
  split; attention then runs whole on every tp rank (K2 through
  ``local_map``, ``ops.flash_attention``), and ``proj`` takes its local
  column slice back without communication.  Under the trainers'
  alternation (flax's order: mlp_in, mlp_out, proj, qkv, then embed and
  head) qkv is row-split instead and the activations between the
  embedding and the blocks are sharded on E, which costs more
  collectives a forward; the layout is the JAX trainer's, kept for
  fidelity.
- The batch is sharded over the data axes by taking each rank's rows of
  every batch (the JAX fit constrains the gathered batch to ``P(dp)``),
  and the gradient's data-parallel sum is an explicit all-reduce of the
  local shards over the data groups (``data_parallel.all_reduce_grads``).

:func:`make_gspmd_scan_fit` runs a staged schedule, :func:`make_gspmd_train_step`
one streamed batch; both train the module in place.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from har_tpu_torch.parallel.mesh import TP_AXIS
from har_tpu_torch.parallel.rules import (
    alternating_rules,
    match_partition_rules,
    natural_key,
    placements,
)


def dense_alternating_specs(params, tp_axis: str = TP_AXIS):
    """Spec tree: the Megatron alternation over the 2-D kernels,
    column-parallel ``P(tp, None)`` on even ordinals, row-parallel
    ``P(None, tp)`` on odd ones, a column kernel's bias sharded with it,
    the rest replicated.  A neural module of the registry is walked as the
    JAX package walks its flax tree (``convert.flax_leaf_names``): in the
    natural order of the flax paths, a kernel where flax holds the values
    in a 2-D ``kernel``, so each weight gets the JAX kernel's spec
    reversed (a transformer's blocks in flax's order mlp_in, mlp_out,
    proj, qkv, then embed and head; a patch embedding and a
    ``scan_layers`` stack replicated).  Other trees are walked in their
    own order."""
    walk = None
    if isinstance(params, nn.Module):
        from har_tpu_torch.convert import flax_leaf_names
        from har_tpu_torch.transfer import model_family

        try:
            family = model_family(params)
        except TypeError:  # not a family of the registry: its own order
            family = None
        if family is not None:
            leaves = flax_leaf_names(family, params)
            walk = sorted(((name, path, ndim) for name, (path, ndim) in leaves.items()),
                          key=lambda leaf: natural_key(leaf[1]))
    return match_partition_rules(
        alternating_rules(params, tp_axis, kernels_only=True, walk=walk), params
    )


def shard_params(module: nn.Module, mesh, specs=None) -> nn.Module:
    """Replace each parameter of ``module`` by a DTensor on ``mesh``'s tp
    axis, laid out by ``specs`` (default: :func:`dense_alternating_specs`,
    as in the JAX package).  Every rank must hold the same values."""
    from torch.distributed.tensor import distribute_tensor

    if specs is None:
        specs = dense_alternating_specs(module)
    tp_mesh = mesh[TP_AXIS]
    for name, spec in specs.items():
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner)
        old = getattr(sub, leaf)
        placed = distribute_tensor(old.detach(), tp_mesh, placements(spec, tp_mesh))
        setattr(sub, leaf, nn.Parameter(placed, requires_grad=old.requires_grad))
    return module


def gather_params(module: nn.Module) -> nn.Module:
    """Turn DTensor parameters back into whole local tensors (a
    collective over the tp axis)."""
    from torch.distributed.tensor import DTensor

    for name, p in list(module.named_parameters()):
        if isinstance(p, DTensor):
            owner, _, leaf = name.rpartition(".")
            setattr(module.get_submodule(owner), leaf,
                    nn.Parameter(p.full_tensor().detach(), requires_grad=p.requires_grad))
    return module


def tp_dim_check(params, specs, tp: int) -> None:
    """Refuse silently unsharded layouts: every tp-sharded dim must divide."""
    tree = dict(params.named_parameters()) if hasattr(params, "named_parameters") else params
    for name, x in tree.items():
        s = specs[name]
        for dim, entry in zip(x.shape, tuple(s) + (None,) * x.dim()):
            if entry is not None and dim % tp:
                raise ValueError(
                    f"param dim {dim} not divisible by tp={tp} "
                    f"(shape {tuple(x.shape)}, spec {s}, {name})"
                )


def replication():
    """The context a DTensor forward and update run in."""
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def make_gspmd_scan_fit(
    module: nn.Module,
    optimizer,
    mesh,
    augment: Callable | None = None,
    class_weights: torch.Tensor | None = None,
    generators: dict | None = None,
) -> Callable:
    """``fit(x, y, batch_idx) -> per-step losses``: the staged
    schedule ``batch_idx`` (steps, batch) over replicated ``x``/``y`` on
    this rank's device, each rank taking its data shard of every batch,
    ``module``'s parameters tp-sharded (:func:`shard_params`).  The module
    and ``optimizer`` train in place; ``generators`` (``dropout``,
    ``augment``) are this data shard's."""
    from har_tpu_torch.parallel.data_parallel import make_fit

    return make_fit(module, optimizer, mesh, augment, class_weights, generators,
                    context=replication)


def make_gspmd_train_step(
    module: nn.Module,
    optimizer,
    mesh,
    augment: Callable | None = None,
    generators: dict | None = None,
) -> Callable:
    """``step(x, y, mask) -> loss`` for one streamed batch (every rank
    passes the whole batch and trains on its data shard): the masked mean
    of the cross-entropy over the global batch, ``mask`` doubling as the
    per-row weight, as in the JAX step."""
    from har_tpu_torch.parallel.data_parallel import make_batch_step

    return make_batch_step(module, optimizer, mesh, augment, generators,
                           context=replication)
