"""Everything a run is given, drawn from ``--seed``: sub-seeds, raw
windows and labels, and a model's initial weights.

Inputs are made on the run's device with a ``torch.Generator`` of that
device, in a few large calls, so the same seed on the same kind of device
gives the same tensors; the reference draws them again after the window
rather than reading anything the program holds.
"""

from __future__ import annotations

import math
import zlib

import numpy as np
import torch

# lecun_normal is a normal truncated at two standard deviations, whose
# standard deviation is this fraction of the untruncated one
_TRUNC_STD = 0.87962566103423978


def sub_seed(seed: int, tag: str) -> int:
    """A seed below 2**62 for the stream ``tag`` of run seed ``seed``
    (any whole number)."""
    words = [abs(int(seed)), int(seed < 0), zlib.crc32(tag.encode())]
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    return int(state >> np.uint64(2))


def generator(seed: int, tag: str, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def raw_windows(seed: int, n: int, t: int, c: int, num_classes: int,
                device: torch.device, signal: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """``n`` (t, c) windows and uniform labels, on ``device``; every row
    differs.  Each window is standard-normal noise plus, with ``signal``
    > 0, its class's pattern: on each axis a sinusoid of 1 to 4 cycles a
    window, amplitude ``signal`` × 0.5 to 1.5 and a phase, drawn per class
    and axis (as activities differ in their accelerometer rhythm)."""
    g = generator(seed, "windows", device)
    x = torch.randn((n, t, c), generator=g, device=device, dtype=torch.float32)
    y = torch.randint(0, num_classes, (n,), generator=g, device=device)
    if signal > 0:
        freq, amp, phase = torch.rand((3, num_classes, 1, c), generator=g, device=device)
        tau = torch.arange(t, device=device, dtype=torch.float32)[None, :, None] / t
        pattern = (signal * (0.5 + amp)
                   * torch.sin(2 * math.pi * ((1 + 3 * freq) * tau + phase)))
        x += pattern[y]
    return x, y.to(torch.int32)


def initial_weights(shapes: dict[str, tuple[int, ...]], seed: int,
                    device: torch.device) -> dict[str, torch.Tensor]:
    """float32 weights for a state dict of ``shapes``: every matrix
    (out, in) lecun-normal truncated at two standard deviations (fan-in
    ``in``), every vector named ``*.weight`` (a norm's scale) 1 + 0.02·N,
    every other vector (a bias) 0.02·N.  Two draws in all: one for the
    matrices, one for the vectors."""
    g = generator(seed, "weights", device)
    mats = {k: s for k, s in shapes.items() if len(s) == 2}
    vecs = {k: s for k, s in shapes.items() if len(s) != 2}
    flat_m = torch.empty(sum(math.prod(s) for s in mats.values()), device=device)
    torch.nn.init.trunc_normal_(flat_m, std=1.0, a=-2.0, b=2.0, generator=g)
    flat_v = torch.randn(sum(math.prod(s) for s in vecs.values()), generator=g,
                         device=device) * 0.02
    out, off = {}, 0
    for k, s in mats.items():
        n = math.prod(s)
        std = math.sqrt(1.0 / s[1]) / _TRUNC_STD
        out[k] = (flat_m[off:off + n] * std).view(s)
        off += n
    off = 0
    for k, s in vecs.items():
        n = math.prod(s)
        v = flat_v[off:off + n].view(s)
        out[k] = v + 1.0 if k.endswith(".weight") else v
        off += n
    return {k: out[k] for k in shapes}
