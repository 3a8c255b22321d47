"""Wrapper of the short-sequence attention CUDA kernel
(``csrc/small_seq_attn.cu``) and its plain PyTorch version.

:func:`ctg_packed` replaces K6 of ``aniportrait_tpu/ops/pallas_attention.py``
(``ctg_seq_attention_pallas`` through ``ctg_packed``): attention within each
contiguous sequence of ``seq`` rows of a token-layout ``(..., C)`` tensor,
heads sliced from ``C = heads * d``.  The JAX function takes tiles
``(n, g * seq, C)`` of ``g`` packed sequences; that is the same memory as
``(n * g, seq, C)``, and both wrappers here take any leading shape whose rows
divide into sequences.

The contract is ``_ctg_kernel``'s: ``scale`` multiplies q in q's dtype (the
callers pass ``log2(e) / sqrt(d)``), the softmax is base 2, the float32
probabilities are rounded to v's dtype before the PV product and each row is
normalised after it by the sum of the unrounded probabilities.
"""

from __future__ import annotations

import torch

from aniportrait_tpu_torch.ops.kernels import build
from aniportrait_tpu_torch.ops.kernels.flash import check_operands

MAX_SEQ = 32


def plain_ctg_packed(qp, kp, vp, seq: int, heads: int, scale: float):
    """Explicit einsum + float32 base-2 softmax, rounded as the kernel."""
    c = qp.shape[-1]
    d = c // heads

    def split(x):  # (..., C) -> (N, seq, heads, d)
        return x.reshape(-1, seq, heads, d)

    q = split(qp * torch.tensor(scale, dtype=qp.dtype)).float()
    logits = torch.einsum("nihd,njhd->nhij", q, split(kp).float())
    p = torch.exp2(logits - logits.amax(-1, keepdim=True))
    r = 1.0 / p.sum(-1)  # (N, heads, seq)
    pv = torch.einsum("nhij,njhd->nihd", p.to(vp.dtype).float(), split(vp).float())
    return (pv * r.transpose(1, 2)[..., None]).reshape(qp.shape).to(qp.dtype)


def ctg_packed(qp, kp, vp, seq: int, heads: int, scale: float):
    """Attention within each run of ``seq`` contiguous rows of ``(..., C)``
    token tensors, ``C = heads * d``; returns q's shape and dtype."""
    if qp.device.type == "cpu":
        return plain_ctg_packed(qp, kp, vp, seq, heads, scale)
    c = qp.shape[-1]
    rows = qp.numel() // max(c, 1)
    if (c % heads or not 1 <= seq <= MAX_SEQ or rows % seq
            or kp.shape != qp.shape or vp.shape != qp.shape):
        raise ValueError(
            f"ctg_packed: shapes {qp.shape} {kp.shape} {vp.shape} seq {seq} "
            f"heads {heads}"
        )
    d = c // heads
    check_operands("ctg_packed", (qp, kp, vp), d)
    out = torch.empty_like(qp)
    err = build.library().aniportrait_ctg_fwd(
        build.DTYPE_CODES[qp.dtype], qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        out.data_ptr(), rows // seq, seq, heads, d, scale, build.stream_handle(),
    )
    build.check(err, "ctg_packed")
    ctg_packed.launches += 1
    return out


ctg_packed.launches = 0
