"""Class histograms for tree induction: kernel K1 of the port.

Replaces ``har_tpu/ops/pallas_hist.py::_hist_kernel`` (launched by
``_hist_padded``, wrapped by ``hist_matmul``), the histogram every
decision-tree and random-forest level's split search reads::

    hist(bins (n, d) int32, m (T, n, WC) f32, B) -> (T, WC, d*B) f32
    out[t, wc, f*B + b] = sum_r m[t, r, wc] * [bins[r, f] == b]

``m`` holds each row's (node, class) weight for tree ``t``; the leading
tree axis lets one launch serve a whole random-forest chunk.

- :func:`hist` is the wrapper: on CUDA tensors it launches the hand-written
  kernel ``csrc/hist.cu`` (built by ``ops._build`` at first use) or raises;
  on CPU tensors it takes :func:`hist_plain`.  There is no fallback from
  one to the other.
- :func:`hist_plain` is the same function in plain PyTorch: a one-hot
  matmul over feature chunks.
- ``HIST_LAUNCHES`` counts kernel launches, so a run can show that its
  trees went through the kernel.

What bounds the kernel on the H100: the function must move the bytes of
``bins``, ``m`` and the output; the adds it needs are far fewer, since on
the tree path each row of ``m`` has one nonzero per tree.  The kernel
instead does ``n`` adds for every output (wc, f) pair, reading ``bins``
and ``m`` through L1 per row: it is bound by instruction issue, not by
memory.  The design keeps each accumulator private to one thread in
shared memory (no atomics, exact for integer weights) and writes the
output once, coalesced.  Its times are in PERF.md.

With integer weights (DT's ones, RF's Poisson counts) every partial sum is
an exact integer below 2**24, so kernel and plain version agree bit for
bit whatever their order of summation.
"""

from __future__ import annotations

import ctypes

import torch

from har_tpu_torch.ops import _build

# kernel launches since import (or since the caller last reset it)
HIST_LAUNCHES = 0

# Hopper: a block may use 227 KB of dynamic shared memory
_SMEM_BYTES = 232_448
_THREADS = 256
# the plain version's one-hot temporary per feature chunk
_PLAIN_TEMP_BYTES = 64 << 20


def hist_plain(bins: torch.Tensor, m: torch.Tensor, max_bins: int) -> torch.Tensor:
    """``m^T @ one_hot(bins)`` in plain PyTorch, feature chunk by chunk."""
    n, d = bins.shape
    trees, _, wc = m.shape
    out = m.new_empty((trees, wc, d * max_bins))
    levels = torch.arange(max_bins, device=bins.device, dtype=bins.dtype)
    mt = m.transpose(1, 2)  # (T, WC, n)
    chunk = max(1, _PLAIN_TEMP_BYTES // max(1, n * max_bins * 4))
    for f0 in range(0, d, chunk):
        f1 = min(d, f0 + chunk)
        onehot = (bins[:, f0:f1, None] == levels).to(m.dtype)
        out[:, :, f0 * max_bins : f1 * max_bins] = mt @ onehot.reshape(
            n, (f1 - f0) * max_bins
        )
    return out


def _smem_bytes(max_bins: int, threads: int) -> int:
    return max_bins * (threads + 1) * 4


def tile_shape(wc: int, max_bins: int) -> tuple[int, int]:
    """(wc_tile, f_tile) of one block: about 256 threads, each owning one
    (wc, feature) pair's ``max_bins`` accumulators in shared memory.
    Raises when even a 32-thread block's accumulators exceed it."""
    wc_tile = min(wc, _THREADS)
    f_tile = max(1, _THREADS // wc_tile)
    while f_tile > 1 and _smem_bytes(max_bins, wc_tile * f_tile) > _SMEM_BYTES:
        f_tile -= 1
    while wc_tile > 32 and _smem_bytes(max_bins, wc_tile) > _SMEM_BYTES:
        wc_tile = max(32, wc_tile // 2)
    if _smem_bytes(max_bins, wc_tile * f_tile) > _SMEM_BYTES:
        raise ValueError(
            f"max_bins={max_bins} needs {_smem_bytes(max_bins, wc_tile)} "
            f"bytes of shared memory per block, over Hopper's {_SMEM_BYTES}"
        )
    return wc_tile, f_tile


def _check(bins: torch.Tensor, m: torch.Tensor, max_bins: int) -> None:
    if bins.dim() != 2 or m.dim() != 3 or m.shape[1] != bins.shape[0]:
        raise ValueError(
            f"hist takes bins (n, d) and m (T, n, WC); got "
            f"{tuple(bins.shape)} and {tuple(m.shape)}"
        )
    if bins.dtype != torch.int32 or m.dtype != torch.float32:
        raise TypeError(
            f"hist takes int32 bins and float32 m; got {bins.dtype}, {m.dtype}"
        )
    if max_bins < 1:
        raise ValueError(f"max_bins must be >= 1, got {max_bins}")


def hist(bins: torch.Tensor, m: torch.Tensor, max_bins: int) -> torch.Tensor:
    """(T, WC, d*max_bins) class histograms; the kernel on CUDA tensors,
    the plain version on CPU tensors."""
    _check(bins, m, max_bins)
    if bins.device.type == "cpu" and m.device.type == "cpu":
        return hist_plain(bins, m, max_bins)
    if not (bins.is_cuda and m.is_cuda and bins.device == m.device):
        raise ValueError(
            f"hist needs bins and m on one device; got {bins.device}, {m.device}"
        )
    return _launch(bins.contiguous(), m.contiguous(), max_bins)


def _launch(bins: torch.Tensor, m: torch.Tensor, max_bins: int) -> torch.Tensor:
    global HIST_LAUNCHES
    n, d = bins.shape
    trees, _, wc = m.shape
    if torch.cuda.get_device_capability(bins.device) != (9, 0):
        raise RuntimeError(
            "the hist kernel is built for sm_90a (Hopper); device "
            f"{torch.cuda.get_device_name(bins.device)} is not one"
        )
    if trees > 65535 or -(-wc // 32) > 65535 or max(n, d * max_bins) >= 2**31:
        raise ValueError(
            f"hist shape outside the kernel's grid and int32 indices: "
            f"T={trees}, n={n}, d={d}, B={max_bins}, WC={wc}"
        )
    out = torch.empty((trees, wc, d * max_bins), device=bins.device)
    if out.numel() == 0:
        return out
    wc_tile, f_tile = tile_shape(wc, max_bins)
    lib = _build.load("hist")
    fn = lib.har_hist_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(bins.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = fn(
        bins.data_ptr(), m.data_ptr(), out.data_ptr(),
        n, d, max_bins, trees, wc, wc_tile, f_tile, stream,
    )
    if err != 0:
        raise RuntimeError(f"hist kernel launch failed: CUDA error {err}")
    HIST_LAUNCHES += 1
    return out
