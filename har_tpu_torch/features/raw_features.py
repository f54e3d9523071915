"""Raw-window → WISDM-transformed feature extraction, batched on the device.

Port of ``har_tpu/features/raw_features.py`` (a ``jax.vmap`` over
windows) as batched torch ops over the window axis: the 43-feature
reduction of each 10 s window that the WISDM "transformed" dataset holds.

Feature layout matches the CSV column order (``FEATURE_NAMES``):
  X0..X9, Y0..Y9, Z0..Z9   per-axis 10-bin histogram fractions over [min, max]
  XAVG, YAVG, ZAVG         per-axis means
  XPEAK, YPEAK, ZPEAK      average time between detected peaks, milliseconds
  XABSDEV...               mean |x - mean|
  XSTDDEV...               population standard deviation
  RESULTANT                mean ℓ2 magnitude of (x, y, z)

A peak is a strict local maximum above mean + 0.1·std (the population
std, as ``jnp.std`` takes it).  The histogram bin of a sample is the int
cast of ``(x − lo) / width · 10``, clipped to [0, 9], computed in the
JAX package's order, so the bins, and the fractions, are the same.
"""

from __future__ import annotations

import numpy as np
import torch

from har_tpu_torch.data.raw_windows import SAMPLE_HZ

NUM_BINS = 10

FEATURE_NAMES = (
    tuple(f"{axis}{i}" for axis in ("X", "Y", "Z") for i in range(NUM_BINS))
    + ("XAVG", "YAVG", "ZAVG")
    + ("XPEAK", "YPEAK", "ZPEAK")
    + ("XABSDEV", "YABSDEV", "ZABSDEV")
    + ("XSTDDEV", "YSTDDEV", "ZSTDDEV")
    + ("RESULTANT",)
)


def _axis_histograms(a: torch.Tensor) -> torch.Tensor:
    """(n, 3, T) → (n, 3, 10): fraction of each axis's samples in 10
    equal-width bins over its [min, max]."""
    lo = a.amin(dim=-1, keepdim=True)
    hi = a.amax(dim=-1, keepdim=True)
    width = torch.clamp(hi - lo, min=1e-12)
    bins = torch.clamp(((a - lo) / width * NUM_BINS).to(torch.int32), 0, NUM_BINS - 1)
    counts = torch.zeros(a.shape[:-1] + (NUM_BINS,), dtype=a.dtype, device=a.device)
    counts.scatter_add_(-1, bins.long(), torch.ones_like(a))
    # the JAX package's counts / T, which XLA computes as counts · (1 / T)
    return counts * (torch.tensor(1.0, dtype=a.dtype) / a.shape[-1]).to(a.device)


def _avg_peak_gap_ms(a: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """(n, 3, T) → (n, 3): average distance between strict local maxima
    above the height threshold, in milliseconds; 0 with fewer than 2."""
    mid = a[..., 1:-1]
    is_peak = (mid > a[..., :-2]) & (mid > a[..., 2:]) & (mid > mean + 0.1 * std)
    n_peaks = is_peak.sum(-1)
    pos = torch.arange(1, a.shape[-1] - 1, dtype=a.dtype, device=a.device)
    first = torch.where(is_peak, pos, torch.inf).amin(-1)
    last = torch.where(is_peak, pos, -torch.inf).amax(-1)
    span_ms = (last - first) * (1000.0 / SAMPLE_HZ)
    gap = span_ms / torch.clamp(n_peaks - 1, min=1).to(a.dtype)
    return torch.where(n_peaks > 1, gap, torch.zeros_like(gap))


def extract_features(windows) -> torch.Tensor:
    """(n, T, 3) raw windows → (n, 43) float32 features on the windows'
    device (a numpy array is taken to the CPU)."""
    w = torch.as_tensor(np.asarray(windows) if not torch.is_tensor(windows) else windows)
    a = w.to(torch.float32).transpose(1, 2)  # (n, 3, T)
    mean = a.mean(-1, keepdim=True)
    std = a.std(-1, correction=0, keepdim=True)
    features = [
        _axis_histograms(a).flatten(1),
        mean[..., 0],
        _avg_peak_gap_ms(a, mean, std),
        (a - mean).abs().mean(-1),
        std[..., 0],
        torch.sqrt((a * a).sum(1)).mean(-1, keepdim=True),
    ]
    return torch.cat(features, dim=1)
