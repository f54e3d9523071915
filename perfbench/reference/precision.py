"""The matrix products of the reference, in float32 or, for the control,
with their operands rounded to float8 (e4m3).

The control is the reference computed in the precision next below the
configuration's bfloat16: every operand of every product (the dense
layers and both products of attention) is scaled per tensor so that its
largest magnitude meets e4m3's largest finite value, rounded to e4m3 and
scaled back, and the product accumulates in float32.  The rounding is
passed straight through in the backward (the gradient of a rounded
operand is the gradient of the operand), so the backward's products use
the rounded operands, as an fp8 step would.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def exact_tf32_off() -> None:
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().clamp_min(1e-30)
        scale = E4M3_MAX / amax
        return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale

    @staticmethod
    def backward(ctx, g):
        return g


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    return _RoundFp8.apply(x)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def matmul_fp8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(round_fp8(a), round_fp8(b))


MATMULS = {"float32": matmul_f32, "fp8": matmul_fp8}
