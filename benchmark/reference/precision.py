"""Precision of the plain reference: every matrix product's operands
(linear layers, convolutions and the two products of attention) pass
through a :class:`Precision` before the product, which runs in float32.

* :data:`FP32`: the reference itself, float32 with TF32 off.
* :data:`FP8`: the control, the step below bf16: each operand rounded to
  float8 e4m3 with one scale per tensor (amax / 448), as an fp8 GEMM
  takes it; the product and everything else stay float32.  The rounding
  passes the gradient straight through, so a training step runs its
  backward on the rounded forward.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


class Precision:
    name = "fp32"

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x


class Fp8(Precision):
    name = "fp8"

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        scale = x.detach().abs().amax().float().clamp_min(1e-30) / E4M3_MAX
        q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (q.to(x.dtype) - x).detach()


FP32 = Precision()
FP8 = Fp8()
PRECISIONS = {"fp32": FP32, "fp8": FP8}


def no_tf32() -> None:
    """Float32 products in float32 (cuBLAS and cuDNN would take TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
