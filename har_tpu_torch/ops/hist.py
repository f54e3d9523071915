"""Class histograms for tree induction: kernel K1 of the port.

Replaces ``har_tpu/ops/pallas_hist.py::_hist_kernel`` (launched by
``_hist_padded``, wrapped by ``hist_matmul``), the histogram every
decision-tree and random-forest level's split search reads::

    hist(bins (n, d) int32, m (T, n, WC) f32, B) -> (T, WC, d*B) f32
    out[t, wc, f*B + b] = sum_r m[t, r, wc] * [bins[r, f] == b]

``m`` holds each row's (node, class) weight for tree ``t``; the leading
tree axis lets one launch serve a whole random-forest chunk.  Two entries
compute it, each with its own hand-written kernel in ``csrc/hist.cu``:

- :func:`hist` takes any dense ``m`` (float weights in any column).  No
  path of the port calls it since the tree grower moved to
  :func:`hist_rows`; boosted trees use :func:`hist_rows` too (their ``m``
  is row one-hot per gradient channel).
  :func:`hist_plain` is its plain PyTorch version, a one-hot matmul over
  feature chunks; ``HIST_LAUNCHES`` counts its kernel's launches.
- :func:`hist_rows` takes ``m`` row one-hot, as a tree level builds it:
  row ``r`` of tree ``t`` puts ``weight[t, r]`` into column
  ``slot[t, r]`` and nothing elsewhere.  The tree grower calls this one,
  and so does a boosting round's level, with one (tree) channel for the
  gradients and one for the hessians of each class tree.
  :func:`hist_rows_plain` is its plain version, an ``index_add_`` over
  (tree, slot, feature, bin); ``HIST_ROWS_LAUNCHES`` counts its kernel's
  launches.

Each wrapper launches its kernel on CUDA tensors (built by ``ops._build``
at first use) or raises, and takes its plain version on CPU tensors.
There is no fallback from one to the other.

What bounds the dense kernel on the H100: it does ``n`` adds for every
output (wc, f) pair, reading ``bins`` and ``m`` through L1 per row, even
where ``m`` is zero: it is bound by instruction issue.  The row-sparse
kernel reads each live row's bins once and does one shared-memory add per
(row, feature), so it is bound by the bytes of ``bins`` and the output
(see ``csrc/hist.cu``).  Their times are in PERF.md.

With integer weights (DT's ones, RF's Poisson counts) every partial sum is
an exact integer below 2**24, so kernels and plain versions agree bit for
bit whatever their order of summation.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from har_tpu_torch.ops import _build

# kernel launches since import (or since the caller last reset it)
HIST_LAUNCHES = 0
HIST_ROWS_LAUNCHES = 0

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


# the row-sparse kernel: 32 features per block (one per lane), and enough
# row chunks for two blocks per SM (the launch reads the card's SM count;
# a plan made without a card assumes an H100 SXM's)
_ROWS_F_TILE = 32
_ROWS_MIN_CHUNK = 256
_ROWS_BLOCKS_PER_SM = 2
H100_SMS = 132
# a block's accumulators stay within half an SM's shared memory, so two
# blocks share one SM
_ROWS_SMEM_TARGET = _SMEM_BYTES // 2 - 1024


def hist_rows_plain(
    bins: torch.Tensor,
    slot: torch.Tensor,
    weight: torch.Tensor,
    wc: int,
    max_bins: int,
) -> torch.Tensor:
    """:func:`hist_plain` of the row one-hot ``m`` in plain PyTorch: each
    kept row adds its weight at (tree, slot, feature, bin), tree by tree."""
    n, d = bins.shape
    trees = slot.shape[0]
    out = torch.zeros((trees, wc * d * max_bins), device=bins.device)
    features = torch.arange(d, device=bins.device)
    for t in range(trees):
        (rows,) = ((weight[t] != 0) & (slot[t] >= 0) & (slot[t] < wc)).nonzero(
            as_tuple=True
        )
        b = bins[rows].long()  # (k, d)
        index = (slot[t, rows, None].long() * d + features) * max_bins + b
        values = weight[t, rows, None].expand(-1, d)
        ok = (b >= 0) & (b < max_bins)
        out[t].index_add_(0, index[ok], values[ok])
    return out.view(trees, wc, d * max_bins)


def _rows_slot_bytes(max_bins: int) -> int:
    """Shared memory of one slot's accumulators: 32 features, each padded
    to an odd stride of words."""
    return _ROWS_F_TILE * (max_bins | 1) * 4


def rows_plan(
    n: int, d: int, max_bins: int, wc: int, trees: int, sms: int = H100_SMS
) -> tuple[int, int, int, int]:
    """(wc_tile, slot_tiles, chunk_rows, chunks) of a :func:`hist_rows`
    launch on a card of ``sms`` SMs.  A block owns (tree, slot tile, 32
    features, row chunk).  The slot tile keeps its accumulators within
    half an SM's shared memory; rows are split into chunks until the grid
    has about two blocks per SM, each chunk at least 256 rows.  With more
    than one chunk, blocks add into an output zeroed first.  Raises when
    one slot's accumulators exceed a block's shared memory."""
    slot_bytes = _rows_slot_bytes(max_bins)
    if slot_bytes > _SMEM_BYTES:
        raise ValueError(
            f"max_bins={max_bins} needs {slot_bytes} bytes of shared memory "
            f"per slot, over Hopper's {_SMEM_BYTES}"
        )
    n, wc = max(n, 1), max(wc, 1)
    slot_tiles = -(-wc // max(1, _ROWS_SMEM_TARGET // slot_bytes))
    wc_tile = -(-wc // slot_tiles)  # balanced tiles, none of them empty
    slot_tiles = -(-wc // wc_tile)
    blocks = trees * slot_tiles * -(-d // _ROWS_F_TILE)
    target = _ROWS_BLOCKS_PER_SM * sms
    chunks = max(1, min(-(-target // max(blocks, 1)),
                        n // _ROWS_MIN_CHUNK))
    chunk_rows = -(-n // chunks)
    chunk_rows = -(-chunk_rows // 32) * 32
    return wc_tile, slot_tiles, chunk_rows, -(-n // chunk_rows)


def _check_rows(bins, slot, weight, wc, max_bins) -> None:
    if (
        bins.dim() != 2
        or slot.dim() != 2
        or weight.shape != slot.shape
        or slot.shape[1] != bins.shape[0]
    ):
        raise ValueError(
            f"hist_rows takes bins (n, d), slot and weight (T, n); got "
            f"{tuple(bins.shape)}, {tuple(slot.shape)} and {tuple(weight.shape)}"
        )
    if (
        bins.dtype != torch.int32
        or slot.dtype != torch.int32
        or weight.dtype != torch.float32
    ):
        raise TypeError(
            f"hist_rows takes int32 bins and slot and float32 weight; got "
            f"{bins.dtype}, {slot.dtype}, {weight.dtype}"
        )
    if max_bins < 1 or wc < 0:
        raise ValueError(f"hist_rows needs max_bins >= 1 and wc >= 0; got "
                         f"{max_bins}, {wc}")


def hist_rows(
    bins: torch.Tensor,
    slot: torch.Tensor,
    weight: torch.Tensor,
    wc: int,
    max_bins: int,
) -> torch.Tensor:
    """(T, wc, d*max_bins) class histograms of the row one-hot ``m``
    (``m[t, r] = weight[t, r] * e_slot[t, r]``).  Rows with weight 0 or a
    slot outside [0, wc), and bin ids outside [0, max_bins), contribute
    nothing.  The kernel on CUDA tensors, the plain version on CPU
    tensors."""
    _check_rows(bins, slot, weight, wc, max_bins)
    tensors = (bins, slot, weight)
    if all(x.device.type == "cpu" for x in tensors):
        return hist_rows_plain(bins, slot, weight, wc, max_bins)
    if not all(x.is_cuda and x.device == bins.device for x in tensors):
        raise ValueError(
            "hist_rows needs bins, slot and weight on one device; got "
            f"{bins.device}, {slot.device}, {weight.device}"
        )
    return _launch_rows(
        bins.contiguous(), slot.contiguous(), weight.contiguous(), wc, max_bins
    )


@functools.cache
def _is_hopper(index: int) -> bool:
    return torch.cuda.get_device_capability(index) == (9, 0)


@functools.cache
def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _rows_kernel():
    """The row-sparse kernel's C entry, loaded (and built) once."""
    fn = _build.load("hist").har_hist_rows_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_rows(bins, slot, weight, wc: int, max_bins: int) -> torch.Tensor:
    global HIST_ROWS_LAUNCHES
    n, d = bins.shape
    trees = slot.shape[0]
    index = bins.device.index
    if not _is_hopper(index):
        raise RuntimeError(
            "the hist_rows kernel is built for sm_90a (Hopper); device "
            f"{torch.cuda.get_device_name(bins.device)} is not one"
        )
    shape = (trees, wc, d * max_bins)
    if n == 0 or 0 in shape:
        return torch.zeros(shape, device=bins.device)
    wc_tile, slot_tiles, chunk_rows, chunks = rows_plan(
        n, d, max_bins, wc, trees, sm_count(index)
    )
    if (
        trees * slot_tiles >= 2**31
        or -(-d // _ROWS_F_TILE) > 65535
        or chunks > 65535
        or max(n, d * max_bins) >= 2**31
    ):
        raise ValueError(
            f"hist_rows shape outside the kernel's grid and int32 indices: "
            f"T={trees}, n={n}, d={d}, B={max_bins}, wc={wc}"
        )
    # several row chunks add into one output: it starts at zero
    alloc = torch.zeros if chunks > 1 else torch.empty
    out = alloc(shape, device=bins.device)
    # the C entry sets its attribute and launches on the current device
    with torch.cuda.device(bins.device):
        err = _rows_kernel()(
            bins.data_ptr(), slot.data_ptr(), weight.data_ptr(), out.data_ptr(),
            n, d, max_bins, trees, wc, wc_tile, slot_tiles, chunk_rows, chunks,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"hist_rows kernel launch failed: CUDA error {err}")
    HIST_ROWS_LAUNCHES += 1
    return out
