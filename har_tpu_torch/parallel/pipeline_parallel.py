"""Pipeline parallelism: GPipe-style microbatching over a ``pp`` mesh axis.

Port of ``har_tpu/parallel/pipeline_parallel.py`` on the port's mesh of
ranks (one process a device; gloo on the CPU, NCCL on CUDA).  Homogeneous
stages are laid out one a rank, activations rotate around the ring, and
microbatches stream through so every stage is busy once the pipeline
fills: the GPipe schedule, M + S − 1 ticks for M microbatches over S
stages, bubble fraction (S − 1)/(M + S − 1).

- Every stage applies the same ``stage_fn`` to its own slice of the
  stage-stacked parameters (leading S axis, split over ``pp`` as the
  ``PIPELINE_RULES`` table places it), so the rotating activation keeps
  one shape.
- JAX's ``ppermute`` is ``batch_isend_irecv`` inside an autograd
  function whose backward permutes the cotangents the other way; stage
  0's feed and the last stage's collect are masked, as in JAX.

Calling convention.  Every rank passes the same whole stacked parameters
and the same microbatches ``x`` (M, mb, d), and gets the whole output
back (the last stage's, broadcast).  Every rank then computes the same
loss from it: each rank's backward leaves the gradient of its own stage
on its slice of the stacked parameters, so their sum over the ranks
(``all_reduce``) is the loss's gradient.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from har_tpu_torch.parallel.ring_attention import _send_recv

PP_AXIS = "pp"


def pipeline_mesh(pp: int = -1, device=None):
    """1-D ``pp`` mesh (stage i on rank i) over the process group."""
    from har_tpu_torch.parallel.mesh import linear_mesh

    return linear_mesh(pp, PP_AXIS, device)


class _Permute(torch.autograd.Function):
    """Each rank's activation to the next rank of the ring; the
    cotangents to the previous one."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _send_recv([x], group, 1)[0]

    @staticmethod
    def backward(ctx, g):
        return _send_recv([g], ctx.group, -1)[0], None


class _FromLast(torch.autograd.Function):
    """The last stage's tensor on every rank (the others pass zeros): a
    sum over the ranks; the cotangent (the same on every rank) passes
    back as it is."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def make_pipeline_fn(stage_fn: Callable, mesh, axis: str = PP_AXIS) -> Callable:
    """Build ``f(stacked_params, x) -> y`` running S pipelined stages.

    ``stage_fn(params, a) -> a`` must preserve the activation shape
    (homogeneous stages).  ``stacked_params`` leaves carry a leading S
    axis (stage i's slice lives on rank i); ``x`` is (M, mb, d)
    microbatches, replicated in and out."""
    from har_tpu_torch.parallel.rules import PIPELINE_RULES, match_rule

    group = mesh.get_group(axis)
    s = dist.get_world_size(group)
    # stage stacks split their leading S axis, activations replicate —
    # the PIPELINE_RULES table's layout, looked up by argument name
    split = bool(tuple(match_rule(PIPELINE_RULES, "stacked_params")))

    def pipelined(stacked_params, x):
        idx = dist.get_rank(group)
        for leaf in stacked_params.values():
            if split and leaf.shape[0] != s:
                raise ValueError(
                    f"stage count {leaf.shape[0]} != pp mesh size {s}"
                    " — stack exactly one stage per pipeline device"
                )
        params = {k: v[idx] if split else v for k, v in stacked_params.items()}
        m = x.shape[0]
        state = torch.zeros_like(x[0])
        outs = [torch.zeros_like(x[0]) for _ in range(m)]
        # masks as tensors, as JAX's ``where``: every rank's graph then
        # holds every permute, so every rank runs each permute's backward
        # (a collective) once, in the same order
        first = torch.tensor(idx == 0, device=x.device)
        for t in range(m + s - 1):
            # stage 0 feeds microbatch t while t < M, zeros during drain
            feed = x[min(t, m - 1)] * (1.0 if t < m else 0.0)
            out = stage_fn(params, torch.where(first, feed, state))
            state = _Permute.apply(out, group) if s > 1 else out
            # the last stage collects microbatch t − (S − 1)
            if idx == s - 1 and t >= s - 1:
                outs[t - (s - 1)] = out
        # the last tick's permute output joins the graph with weight 0
        unused = torch.where(torch.zeros_like(first), state, torch.zeros_like(state))
        return _FromLast.apply(torch.stack(outs) + unused, group)

    return pipelined


def stack_stage_params(param_list):
    """[stage0_params, stage1_params, ...] → stacked (S, ...) dict."""
    return {k: torch.stack([p[k] for p in param_list]) for k in param_list[0]}
