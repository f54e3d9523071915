"""Expert parallelism: switch-routed MoE with ``all_to_all`` dispatch.

Port of ``har_tpu/parallel/expert_parallel.py`` on the port's mesh of
ranks (one process a device; gloo on the CPU, NCCL on CUDA).  E
feed-forward experts live one a rank on a 1-D ``ep`` mesh
(:func:`expert_mesh`), a top-1 (switch) router assigns each token an
expert, and two ``all_to_all_single`` exchanges carry the tokens to their
expert's rank and back.  Dispatch and combine are the one-hot einsums of
the JAX package (the Mesh-TensorFlow / GShard formulation), and the
exchanges are ``torch.distributed.nn.functional.all_to_all_single``, whose
backward is the reverse exchange, so the same function trains.

Capacity semantics are JAX's: each expert takes at most ``capacity``
tokens of a shard; beyond it a token is dropped (its combine weight is
zero and it contributes nothing).  :func:`dropless_capacity` returns the
capacity at which nothing can drop.

Calling convention.  Every rank passes the same whole ``params`` (the
router, and expert stacks with a leading E axis) and the same whole
tokens ``x`` (n, h); a rank keeps its expert and its block of rows, as
the ``MOE_RULES`` table places them, and gets back the whole ``y`` and the
aux dict on every rank.  Every rank then computes the same loss from those
replicated outputs: the gradient each rank's backward leaves on
``params``, summed over the ranks (``all_reduce``), is that loss's
gradient (each replicated output passes back only the rank's own share).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

EP_AXIS = "ep"


def expert_mesh(ep: int = -1, device=None):
    """1-D ``ep`` mesh (expert i on rank i) over the process group."""
    from har_tpu_torch.parallel.mesh import linear_mesh

    return linear_mesh(ep, EP_AXIS, device)


def dropless_capacity(n_local: int) -> int:
    """Capacity at which no token can be dropped (worst case: every local
    token routes to the same expert)."""
    return n_local


def init_moe_params(seed: int, num_experts: int, hidden: int, ff: int,
                    device=None) -> dict:
    """Router (replicated) + stacked expert FFNs (leading E axis), float32
    normals drawn with numpy from ``seed`` (the JAX package's scales:
    router 0.02, ``w1`` √(2/h), ``w2`` √(2/ff), biases zero)."""
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(device)

    return {
        "router": normal((hidden, num_experts), 0.02),
        "experts": {
            "w1": normal((num_experts, hidden, ff), (2.0 / hidden) ** 0.5),
            "b1": torch.zeros((num_experts, ff), device=device),
            "w2": normal((num_experts, ff, hidden), (2.0 / ff) ** 0.5),
            "b2": torch.zeros((num_experts, hidden), device=device),
        },
    }


def _expert_ffn(p, x):
    return F.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


class _Gather(torch.autograd.Function):
    """Every rank's row block, concatenated in rank order; the
    cotangent (the same on every rank) passes back the rank's own
    block."""

    @staticmethod
    def forward(ctx, y, group):
        n = dist.get_world_size(group)
        ctx.rank, ctx.rows = dist.get_rank(group), y.shape[0]
        parts = [torch.empty_like(y) for _ in range(n)]
        dist.all_gather(parts, y.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


class _Mean(torch.autograd.Function):
    """The mean over the ranks; the cotangent (the same on every rank)
    passes back 1/n of itself."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def _all_to_all(x, group):
    """Block i of ``x`` (split on dim 0) to rank i; the blocks received,
    concatenated in rank order (differentiable)."""
    from torch.distributed.nn.functional import all_to_all_single

    return all_to_all_single(torch.empty_like(x), x.contiguous(), group=group)


def make_moe_fn(mesh, capacity: int, axis: str = EP_AXIS) -> Callable:
    """Build ``f(params, x) -> (y, aux)`` for a switch-routed MoE layer.

    ``x`` is (n, h), its rows split over ``axis`` (tokens are
    data-sharded; experts are model-sharded — the axis serves both
    roles, as in real MoE deployments).  ``params["experts"]`` leaves
    carry a leading E axis, one expert a rank.  Returns the mixed output
    and an aux dict with the load-balancing loss (switch-transformer's
    f·P dot) and the per-expert assignment fractions."""
    from har_tpu_torch.parallel.rules import MOE_RULES, match_rule

    group = mesh.get_group(axis)
    e = dist.get_world_size(group)
    # router replicated, expert stacks split on their leading E axis —
    # the MOE_RULES table's layout, looked up by argument name
    split = {name: bool(tuple(match_rule(MOE_RULES, name))) for name in ("router", "experts")}

    def mine(name, leaf, rank):
        if not split[name]:
            return leaf
        if leaf.shape[0] != e:
            raise ValueError(
                f"expert count {leaf.shape[0]} != ep mesh size {e}"
                " — stack exactly one expert per device"
            )
        return leaf[rank]

    def moe(params, x):
        rank = dist.get_rank(group)
        router = mine("router", params["router"], rank)
        expert_p = {k: mine("experts", v, rank) for k, v in params["experts"].items()}
        n, h = x.shape
        if n % e:
            raise ValueError(f"{n} tokens do not split over ep mesh size {e}")
        nl = n // e
        xl = x[rank * nl:(rank + 1) * nl]
        probs = torch.softmax(xl @ router, dim=-1)  # (nl, E)
        expert = torch.argmax(probs, dim=-1)  # top-1 routing
        gate = torch.gather(probs, 1, expert[:, None])[:, 0]
        onehot = F.one_hot(expert, e).to(x.dtype)  # (nl, E)
        # position of each token within its expert's capacity buffer;
        # tokens past capacity drop out here — an out-of-range pos_id
        # maps to an all-zero row
        pos_id = ((torch.cumsum(onehot, 0) - 1.0) * onehot).sum(-1).long()
        slots = (pos_id[:, None] == torch.arange(capacity, device=x.device)).to(x.dtype)
        dispatch = onehot[:, :, None] * slots[:, None, :]  # (nl, E, C)
        combine = dispatch * gate[:, None, None]
        # tokens → expert ranks: (E, C, h) → exchange → (S, C, h), the
        # capacity slots every shard routed to MY expert
        recv = _all_to_all(torch.einsum("nec,nh->ech", dispatch, xl), group)
        out = _expert_ffn(expert_p, recv.reshape(e * capacity, h))
        # back to the token owners
        send = _all_to_all(out.reshape(e, capacity, h), group)
        y = torch.einsum("nec,ech->nh", combine, send)
        # switch load-balance loss: E · Σ_e fraction_e · mean-prob_e,
        # both averaged over the GLOBAL batch
        frac = _Mean.apply(onehot.mean(0), group)
        mean_prob = _Mean.apply(probs.mean(0), group)
        aux = {
            "load_balance_loss": e * torch.sum(frac * mean_prob),
            "expert_fraction": frac,
        }
        return _Gather.apply(y, group), aux

    return moe


def moe_dense_reference(params, x):
    """Every-token-through-its-expert, no parallelism — the exactness
    oracle for :func:`make_moe_fn` at dropless capacity."""
    probs = torch.softmax(x @ params["router"], dim=-1)
    expert = torch.argmax(probs, dim=-1)
    gate = torch.gather(probs, 1, expert[:, None])[:, 0]
    e = params["experts"]["w1"].shape[0]
    outs = torch.stack(
        [_expert_ffn({k: v[i] for k, v in params["experts"].items()}, x) for i in range(e)],
        dim=1,
    )  # (n, E, h)
    sel = torch.gather(outs, 1, expert[:, None, None].expand(-1, 1, x.shape[-1]))[:, 0]
    return gate[:, None] * sel
