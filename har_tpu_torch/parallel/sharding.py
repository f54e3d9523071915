"""Placements of batches on a mesh, and padding to the shard count.

Port of ``har_tpu/parallel/sharding.py``.  A JAX ``NamedSharding`` is a
``(mesh, placements)`` pair here: one ``torch.distributed.tensor``
placement per mesh axis.  Rows shard over every data axis (``Shard(0)``),
everything else is replicated; :func:`shard_batch` places arrays that every
rank holds whole, so each rank keeps its own rows.
"""

from __future__ import annotations

import numpy as np
import torch

from har_tpu_torch.parallel.mesh import data_axes, data_shard_count


def batch_sharding(mesh, ndim: int = 1) -> tuple:
    """Placements of a batch: rows sharded over every data axis (``dp``,
    and ``dp_dcn`` on a hybrid mesh), the other dims replicated.  ``ndim``
    is kept for the JAX signature; a placement names only the row dim."""
    from torch.distributed.tensor import Replicate, Shard

    del ndim
    axes = set(data_axes(mesh))
    return tuple(Shard(0) if a in axes else Replicate() for a in mesh.mesh_dim_names)


def replicated(mesh) -> tuple:
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def pad_to_multiple(
    arr: np.ndarray, multiple: int, axis: int = 0, fill=0
) -> tuple[np.ndarray, int]:
    """Pad ``arr`` along ``axis`` to a multiple; returns (padded, n_pad)."""
    n = arr.shape[axis]
    n_pad = (-n) % multiple
    if n_pad == 0:
        return arr, 0
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, n_pad)
    return np.pad(arr, widths, constant_values=fill), n_pad


def shard_batch(mesh, *arrays: np.ndarray, device=None) -> tuple:
    """Pad each array's leading dim to the data-shard count and place it
    sharded over the data axes.

    Returns ``(*dtensors, mask)``; ``mask`` is 1.0 for real rows and 0.0
    for padding, so consumers weight their reductions by it.  Every rank
    passes the same whole arrays and keeps its shard (``to_local()``).
    """
    from torch.distributed.tensor import distribute_tensor

    dp = data_shard_count(mesh)
    n = arrays[0].shape[0]
    device = device if device is not None else mesh.device_type
    placements = batch_sharding(mesh)
    out = []
    for a in arrays:
        if a.shape[0] != n:
            raise ValueError("all arrays must share the leading dimension")
        padded, _ = pad_to_multiple(np.asarray(a), dp)
        out.append(distribute_tensor(
            torch.from_numpy(np.ascontiguousarray(padded)).to(device), mesh, placements
        ))
    mask, _ = pad_to_multiple(np.ones(n, np.float32), dp)
    out.append(distribute_tensor(torch.from_numpy(mask).to(device), mesh, placements))
    return tuple(out)
