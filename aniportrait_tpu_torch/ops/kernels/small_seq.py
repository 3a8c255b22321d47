"""Wrappers of the short-sequence attention CUDA kernels
(``csrc/small_seq_attn.cu``, ``csrc/small_seq_attn_sm90.cu``) and their
plain PyTorch versions.

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

Each kernel has two forms (:func:`forward_form`): bf16 with a head dim that
is a multiple of 8 runs the tensor-core kernel (``small_seq_attn_sm90.cu``:
mma.sync on whole sequences or tiles per block), float32 the FMA kernel
(``small_seq_attn.cu``).  Both keep the contract above, so one plain version
serves each.  ``tensor_core_launches`` counts the calls of either wrapper
that took the tensor-core form.
"""

from __future__ import annotations

import torch

from aniportrait_tpu_torch.ops.kernels import build
from aniportrait_tpu_torch.ops.kernels.flash import check_operands

MAX_SEQ = 32
MAX_TILE = 128  # K9's rows per tile
tensor_core_launches = 0


def forward_form(dtype, d: int) -> str:
    """The form a CUDA call of either kernel with operands of ``dtype`` and
    head dim ``d`` takes: ``"mma"`` (bf16, d % 8 == 0: tensor cores,
    ``csrc/small_seq_attn_sm90.cu``) or ``"fma"`` (float32, and bf16 at
    other head dims: ``csrc/small_seq_attn.cu``).  The C entry points choose
    the same way."""
    if dtype == torch.bfloat16:
        return "mma" if d % 8 == 0 else "fma"
    if dtype == torch.float32:
        return "fma"
    raise TypeError(f"dtype {dtype} not supported (bf16 or float32)")


def _launch(name, entry, tensors, d, *args):
    """Check the operands, run the C entry ``entry`` and count a tensor-core
    launch; returns the output."""
    check_operands(name, tensors, d)
    mma = forward_form(tensors[0].dtype, d) == "mma"
    if mma and any(t.data_ptr() % 16 for t in tensors):  # its 16-byte vector loads
        raise ValueError(f"{name}: operands that do not start on 16 bytes")
    out = torch.empty_like(tensors[0])
    q, k, v = (t.data_ptr() for t in tensors)
    err = getattr(build.library(), entry)(
        build.DTYPE_CODES[out.dtype], q, k, v, out.data_ptr(), *args, build.stream_handle())
    build.check(err, name)
    if mma:
        global tensor_core_launches
        tensor_core_launches += 1
    return out


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
    out = _launch("ctg_packed", "aniportrait_ctg_fwd", (qp, kp, vp), d,
                  rows // seq, seq, heads, d, scale)
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
    out = _launch("ssa_packed", "aniportrait_ssa_fwd", (qp, kp, vp), dp,
                  n, t, seq, dp, nv)
    ssa_packed.launches += 1
    return out


ssa_packed.launches = 0
