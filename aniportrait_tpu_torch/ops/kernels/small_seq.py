"""Wrappers of the short-sequence attention CUDA kernels
(``csrc/small_seq_attn.cu``) and their plain PyTorch versions.

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

:func:`ssa_packed` replaces K9 (``small_seq_attention_pallas`` through
``ssa_packed``): head-folded tiles ``(n, T, dp)``, each row attending within
its group of ``seq`` rows; rows from ``n_valid_rows`` on are dead padding
that attends within its group, and valid rows see only valid columns.  The
contract is ``_small_seq_kernel``'s: q arrives pre-scaled, the softmax is
base e and each row is normalised before p is rounded to v's dtype.
"""

from __future__ import annotations

import torch

from aniportrait_tpu_torch.ops.kernels import build
from aniportrait_tpu_torch.ops.kernels.flash import check_operands

MAX_SEQ = 32
MAX_TILE = 128  # K9's rows per tile


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


def ssa_mask(t: int, seq: int, n_valid_rows: int, device=None):
    """K9's ``(T, T)`` boolean mask: same group of ``seq`` rows, and the
    column valid or the row dead."""
    r = torch.arange(t, device=device)
    same = (r[:, None] // seq) == (r[None, :] // seq)
    return same & ((r < n_valid_rows)[None, :] | (r >= n_valid_rows)[:, None])


def plain_ssa_packed(qp, kp, vp, seq: int, n_valid_rows: int | None = None):
    """Explicit einsum + float32 base-e softmax with the -1e9 mask,
    normalised, then rounded to v's dtype for the PV product."""
    t = qp.shape[1]
    nv = t if n_valid_rows is None else n_valid_rows
    logits = torch.einsum("ntd,nsd->nts", qp.float(), kp.float())
    logits = logits.masked_fill(~ssa_mask(t, seq, nv, qp.device), -1e9)
    p = torch.softmax(logits, dim=-1).to(vp.dtype).float()
    return torch.einsum("nts,nsd->ntd", p, vp.float()).to(qp.dtype)


def ssa_packed(qp, kp, vp, seq: int, n_valid_rows: int | None = None):
    """Attention within groups of ``seq`` rows of head-folded ``(n, T, dp)``
    tiles (q pre-scaled); returns q's shape and dtype."""
    if qp.device.type == "cpu":
        return plain_ssa_packed(qp, kp, vp, seq, n_valid_rows)
    n, t, dp = qp.shape if qp.dim() == 3 else (0, 0, 0)
    nv = t if n_valid_rows is None else n_valid_rows
    if (qp.dim() != 3 or not 1 <= t <= MAX_TILE or not 1 <= seq <= MAX_SEQ
            or not 0 <= nv <= t or kp.shape != qp.shape or vp.shape != qp.shape):
        raise ValueError(
            f"ssa_packed: shapes {qp.shape} {kp.shape} {vp.shape} seq {seq} "
            f"n_valid_rows {n_valid_rows} (T <= {MAX_TILE}, seq <= {MAX_SEQ})"
        )
    check_operands("ssa_packed", (qp, kp, vp), dp)
    out = torch.empty_like(qp)
    err = build.library().aniportrait_ssa_fwd(
        build.DTYPE_CODES[qp.dtype], qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        out.data_ptr(), n, t, seq, dp, nv, build.stream_handle(),
    )
    build.check(err, "ssa_packed")
    ssa_packed.launches += 1
    return out


ssa_packed.launches = 0
