"""The chip's peaks and the roofline bound of kernel K2.

Peaks are NVIDIA's H100 SXM data sheet (dense, without sparsity), as
``har_tpu_torch/utils/mfu.py`` and ``chip_smoke.py`` state them; they are
copied here so that a change to the program cannot move the yardstick.
"""

from __future__ import annotations

# dense bf16 tensor-core FLOP/s of one card, by the name
# torch.cuda.get_device_name() gives (H100 SXM5 at 700 W)
PEAK_BF16_BY_NAME = (
    ("H100 80GB HBM3", 989.4e12),
    ("H100 SXM", 989.4e12),
    ("H100 NVL", 835.5e12),
    ("H100 PCIe", 756.5e12),
)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
# the special-function units: 16 exponentials per SM per clock, 132 SMs,
# 1.98 GHz boost
SFU_EXP_PER_S = 16 * 132 * 1.98e9

ELEMENT_BYTES = {"c10::BFloat16": 2, "c10::Half": 2, "float": 4, "double": 8}


def peak_bf16_flops(device_name: str) -> float | None:
    """Peak bf16 FLOP/s of the card ``device_name``, None if unknown."""
    for key, peak in PEAK_BF16_BY_NAME:
        if key in device_name:
            return peak
    return None


def flash_bound_s(b: int, t: int, h: int, d: int, element_bytes: int,
                  with_lse: bool = False) -> float:
    """Least seconds for one K2 forward on (B, T, H, D): q, k and v read
    once and out (and lse, float32) written once over the HBM rate, or
    4·B·H·T²·D flops over the bf16 tensor-core rate, or B·H·T²
    exponentials over the special-function units' rate, whichever is
    largest (``chip_smoke.py::flash_bound``)."""
    numel = b * t * h * d
    nbytes = 4 * numel * element_bytes + (4 * b * h * t if with_lse else 0)
    bytes_s = nbytes / HBM_BYTES_PER_S
    ops_s = max(4 * b * h * t * t * d / BF16_FLOPS_PER_S, b * h * t * t / SFU_EXP_PER_S)
    return max(bytes_s, ops_s)
