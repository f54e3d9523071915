"""Device resolution for the port's entry points.

Every entry point takes a ``device`` name and defaults to ``cuda``.  A
missing GPU is an error, never a quiet switch to the CPU: the CPU runs only
when the caller names it, as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    """The torch device for ``name``; raises when CUDA is asked for and
    absent."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(name)!r} requested but "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "(--device cpu) to run on the CPU"
            )
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {str(name)!r}: use cuda or cpu")
    return device
