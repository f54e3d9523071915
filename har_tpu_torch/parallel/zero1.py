"""ZeRO-1 data parallelism: the optimizer state sharded over the data axes.

Port of ``har_tpu/parallel/zero1.py``.  Parameters stay replicated and the
gradients are summed as in plain data parallelism; AdamW's two moments
live over the padded flat parameter vector, a contiguous 1/N of it per
data shard:

    all-reduce the gradients (as dp) → each shard updates its 1/N slice
    of the flat parameter vector with its 1/N of the moments →
    all-gather the slices back into the whole vector.

AdamW is elementwise, so the sliced update is the replicated one, value
for value.  The flat vector is the optimizer's parameters (those it
updates: a fine-tune's frozen ones are left out) in their order, padded
with zeros to a multiple of N; shards are ordered by
``linear_data_shard_index`` (slice-major on a hybrid mesh).  The gather
runs over the innermost data axis first, so it lays the slices out in
that order.  ``torch.distributed.optim.ZeroRedundancyOptimizer`` would
partition by parameter instead, and its snapshots differ.

``train.Trainer(zero1=True)`` is the way in; :class:`Zero1Trainer` is the
JAX package's thin surface over it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from har_tpu_torch.parallel.data_parallel import gather_data_shards
from har_tpu_torch.parallel.mesh import (
    create_mesh,
    data_shard_count,
    linear_data_shard_index,
)


class FlatSlice:
    """This shard's slice of the flat parameter vector and the sliced
    AdamW over it (``state_dict``: the slice's moments and the count)."""

    def __init__(self, params, optimizer, mesh):
        from har_tpu_torch.train.trainer import AdamW

        self.params = list(params)
        self.mesh = mesh
        self.d = sum(p.numel() for p in self.params)
        n = data_shard_count(mesh)
        self.dpad = -(-self.d // n) * n
        self.local = self.dpad // n
        self.shard = linear_data_shard_index(mesh)
        device = self.params[0].device
        self.slice = torch.zeros((self.local,), dtype=self.params[0].dtype, device=device)
        self.optimizer = AdamW([self.slice], optimizer.schedule, optimizer.weight_decay,
                               optimizer.b1, optimizer.b2, optimizer.eps)

    def _flat(self, tensors) -> torch.Tensor:
        flat = torch.cat([t.reshape(-1) for t in tensors])
        return torch.nn.functional.pad(flat, (0, self.dpad - self.d))

    def _mine(self, flat: torch.Tensor) -> torch.Tensor:
        return flat[self.shard * self.local:(self.shard + 1) * self.local]

    def gather(self, part: torch.Tensor) -> torch.Tensor:
        """The whole flat vector from every shard's ``part``."""
        return gather_data_shards(part, self.mesh)

    @torch.no_grad()
    def step(self) -> None:
        """The sliced AdamW step on the gradients of ``params`` (the global
        mean's), then the all-gather of the updated slices into every
        parameter."""
        self.slice.copy_(self._mine(self._flat([p.detach() for p in self.params])))
        self.slice.grad = self._mine(self._flat([p.grad for p in self.params]))
        self.optimizer.step()
        full = self.gather(self.slice)
        off = 0
        for p in self.params:
            p.copy_(full[off:off + p.numel()].view_as(p))
            off += p.numel()

    def state_dict(self) -> dict:
        """The whole moments (gathered: the same on every rank) and the
        count, host copies."""
        state = self.optimizer.state_dict()
        return {
            "mu": [self.gather(self.optimizer.mu[0]).cpu()],
            "nu": [self.gather(self.optimizer.nu[0]).cpu()],
            "count": state["count"],
        }

    def load_state_dict(self, state: dict) -> None:
        device = self.slice.device
        self.optimizer.load_state_dict({
            "mu": [self._mine(state["mu"][0].to(device))],
            "nu": [self._mine(state["nu"][0].to(device))],
            "count": state["count"],
        })


def make_zero1_fit(module, optimizer, mesh, augment=None, class_weights=None,
                   generators=None):
    """``(fit, init_opt_state)`` for a ZeRO-1 staged run.

    ``fit(x, y, batch_idx)`` is ``data_parallel.make_fit``'s fit
    (each rank on its columns of every batch, the module trained in
    place); ``optimizer`` (an ``AdamW`` over the module's parameters)
    gives the schedule, the hyperparameters and the parameters to update.
    ``init_opt_state()`` returns the :class:`FlatSlice` that holds this
    shard's moments, ``(dpad / N,)`` each, and steps them."""
    from har_tpu_torch.parallel.data_parallel import make_fit

    sliced = FlatSlice(optimizer.params, optimizer, mesh)
    fit = make_fit(module, sliced, mesh, augment, class_weights, generators)
    return fit, lambda: sliced


@dataclasses.dataclass
class Zero1Trainer:
    """Staged trainer with ZeRO-1 optimizer-state sharding: a thin surface
    over ``train.Trainer(..., zero1=True)``."""

    module: Any
    config: Any = None
    mesh: Any = None
    device: Any = "cuda"

    def fit(self, x, y, num_classes: int | None = None):
        from har_tpu_torch.train.trainer import Trainer

        trainer = Trainer(
            self.module, self.config, device=self.device,
            mesh=self.mesh or create_mesh(dp=-1, device=self.device),
            scan=True, zero1=True,
        )
        return trainer.fit(np.asarray(x, np.float32), np.asarray(y, np.int32),
                           num_classes=num_classes)
