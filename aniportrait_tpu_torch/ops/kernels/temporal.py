"""Wrapper of the temporal-attention CUDA kernel (``csrc/temporal_attn.cu``)
and its plain PyTorch version.

:func:`nat_temporal` replaces K3 of ``aniportrait_tpu/ops/pallas_attention.py``
(``nat_temporal_attention_pallas`` through ``nat_packed``): attention along
the frame axis of natural ``(b * f, s, c)`` activations, independently per
spatial position and head.  It keeps the JAX function's scale contract (the
base-2 scale ``log2(e) / sqrt(d)``) and converts it to the natural scale that
the kernel and the plain version take.
"""

from __future__ import annotations

import math

import torch

from aniportrait_tpu_torch.ops.kernels import build
from aniportrait_tpu_torch.ops.kernels.flash import check_operands

LN2 = math.log(2.0)


def plain_nat_temporal(qbf, kbf, vbf, frames: int, heads: int, scale: float):
    """Explicit einsum + float32 softmax; ``scale`` is the natural scale."""
    bf, s, c = qbf.shape
    b, d = bf // frames, c // heads

    def split(x):
        return x.float().reshape(b, frames, s, heads, d)

    logits = torch.einsum("bfshd,bgshd->bshfg", split(qbf), split(kbf)) * scale
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bshfg,bgshd->bfshd", probs, split(vbf))
    return out.reshape(bf, s, c).to(qbf.dtype)


def nat_temporal(qbf, kbf, vbf, frames: int, heads: int, scale: float):
    """Temporal attention over ``(b * f, s, c)``.  ``scale`` follows the JAX
    ``nat_packed`` contract: q is scaled by it and the softmax is base 2, so
    the usual call passes ``log2(e) / sqrt(d)``."""
    natural = scale * LN2
    if qbf.device.type == "cpu":
        return plain_nat_temporal(qbf, kbf, vbf, frames, heads, natural)
    bf, s, c = qbf.shape
    if bf % frames or c % heads or kbf.shape != qbf.shape or vbf.shape != qbf.shape:
        raise ValueError(
            f"nat_temporal: shapes {qbf.shape} frames {frames} heads {heads}"
        )
    d = c // heads
    check_operands("nat_temporal", (qbf, kbf, vbf), d)
    out = torch.empty_like(qbf)
    err = build.library().aniportrait_temporal_fwd(
        build.DTYPE_CODES[qbf.dtype], qbf.data_ptr(), kbf.data_ptr(),
        vbf.data_ptr(), out.data_ptr(), bf // frames, frames, s, heads, d,
        natural, build.stream_handle(),
    )
    build.check(err, "nat_temporal")
    nat_temporal.launches += 1
    return out


nat_temporal.launches = 0
