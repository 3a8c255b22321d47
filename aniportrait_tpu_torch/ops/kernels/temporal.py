"""Wrapper of the temporal-attention CUDA kernels (``csrc/temporal_attn.cu``,
``csrc/temporal_attn_sm90.cu``) and their plain PyTorch versions.

:func:`nat_temporal` replaces K3 of ``aniportrait_tpu/ops/pallas_attention.py``
(``nat_temporal_attention_pallas`` through ``nat_packed``): attention along
the frame axis of natural ``(b * f, s, c)`` activations, independently per
spatial position and head.  It keeps the JAX function's scale contract (the
base-2 scale ``log2(e) / sqrt(d)`` multiplies q, the softmax is base 2).

The kernel has two forms (:func:`forward_form`): bf16 with a head dim that is
a multiple of 8 runs the tensor-core kernel (``temporal_attn_sm90.cu``:
mma.sync, all heads of a run of positions per block) in the Pallas body's
rounding, whose plain version is :func:`plain_nat_temporal_rounded`; float32
runs the FMA kernel (``temporal_attn.cu``), the exact softmax of
:func:`plain_nat_temporal`.  ``tensor_core_launches`` counts the calls that
took the tensor-core form.
"""

from __future__ import annotations

import math

import torch

from aniportrait_tpu_torch.ops.kernels import build
from aniportrait_tpu_torch.ops.kernels.flash import check_operands, scaled_in_dtype

LN2 = math.log(2.0)
tensor_core_launches = 0


def forward_form(dtype, d: int) -> str:
    """The form a CUDA call with operands of ``dtype`` and head dim ``d``
    takes: ``"mma"`` (bf16, d % 8 == 0: tensor cores,
    ``csrc/temporal_attn_sm90.cu``) or ``"fma"`` (float32, and bf16 at other
    head dims: ``csrc/temporal_attn.cu``).  The C entry point chooses the
    same way."""
    if dtype == torch.bfloat16:
        return "mma" if d % 8 == 0 else "fma"
    if dtype == torch.float32:
        return "fma"
    raise TypeError(f"dtype {dtype} not supported (bf16 or float32)")


def _split(x, frames, heads):
    bf, s, c = x.shape
    return x.float().reshape(bf // frames, frames, s, heads, c // heads)


def plain_nat_temporal(qbf, kbf, vbf, frames: int, heads: int, scale: float):
    """Explicit einsum + float32 softmax; ``scale`` is the natural scale."""
    bf, s, c = qbf.shape
    logits = torch.einsum("bfshd,bgshd->bshfg", _split(qbf, frames, heads),
                          _split(kbf, frames, heads)) * scale
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bshfg,bgshd->bfshd", probs, _split(vbf, frames, heads))
    return out.reshape(bf, s, c).to(qbf.dtype)


def plain_nat_temporal_rounded(qbf, kbf, vbf, frames: int, heads: int, scale: float):
    """The Pallas body's rounding contract (``pallas_attention.py:1986-2007``),
    step by step: q times the base-2 ``scale`` in q's dtype (the scale
    rounded to it first), logits summed in float32, ``p = exp2(logit -
    max)``, p rounded to v's dtype for PV, and the float32 PV sum times
    ``1 / sum(p)`` of the unrounded p.  In float32 it is
    :func:`plain_nat_temporal` up to summation order."""
    bf, s, c = qbf.shape
    q = _split(scaled_in_dtype(qbf, scale), frames, heads)
    logits = torch.einsum("bfshd,bgshd->bshfg", q, _split(kbf, frames, heads))
    p = torch.exp2(logits - logits.amax(-1, keepdim=True))
    r = 1.0 / p.sum(-1, keepdim=True)
    pv = torch.einsum("bshfg,bgshd->bshfd", p.to(vbf.dtype).float(),
                      _split(vbf, frames, heads)) * r
    return pv.permute(0, 3, 1, 2, 4).reshape(bf, s, c).to(qbf.dtype)


def nat_temporal(qbf, kbf, vbf, frames: int, heads: int, scale: float):
    """Temporal attention over ``(b * f, s, c)``.  ``scale`` follows the JAX
    ``nat_packed`` contract: q is scaled by it and the softmax is base 2, so
    the usual call passes ``log2(e) / sqrt(d)``."""
    bf, s, c = qbf.shape
    if qbf.device.type == "cpu":  # the plain version of the form the card takes
        if forward_form(qbf.dtype, c // heads) == "mma":
            return plain_nat_temporal_rounded(qbf, kbf, vbf, frames, heads, scale)
        return plain_nat_temporal(qbf, kbf, vbf, frames, heads, scale * LN2)
    if bf % frames or c % heads or kbf.shape != qbf.shape or vbf.shape != qbf.shape:
        raise ValueError(
            f"nat_temporal: shapes {qbf.shape} frames {frames} heads {heads}"
        )
    d = c // heads
    check_operands("nat_temporal", (qbf, kbf, vbf), d)
    mma = forward_form(qbf.dtype, d) == "mma"
    # the tensor-core form's 16-byte vector loads
    if mma and (not 1 <= frames <= 64 or any(x.data_ptr() % 16 for x in (qbf, kbf, vbf))):
        raise ValueError(f"nat_temporal: {frames} frames (1 ... 64) or operands that "
                         "do not start on 16 bytes")
    out = torch.empty_like(qbf)
    err = build.library().aniportrait_temporal_fwd(
        build.DTYPE_CODES[qbf.dtype], qbf.data_ptr(), kbf.data_ptr(),
        vbf.data_ptr(), out.data_ptr(), bf // frames, frames, s, heads, d,
        scale, build.stream_handle(),
    )
    build.check(err, "nat_temporal")
    nat_temporal.launches += 1
    if mma:
        global tensor_core_launches
        tensor_core_launches += 1
    return out


nat_temporal.launches = 0
