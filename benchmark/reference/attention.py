"""Plain softmax attention, the reference's only attention: float32
scores, softmax and weighted sum, computed in blocks of (row, head) pairs so
that one block's scores stay under ``BLOCK_BYTES``.  Under autograd each
block is checkpointed, so its scores are recomputed in the backward and
never kept.

``recording(calls)`` collects one entry per call (the shapes of the work,
for the harness's count of attention operations and bytes), which is how
the harness walks every attention call of a request or a training step on
the ``meta`` device.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
from torch.utils.checkpoint import checkpoint

from .precision import FP32, Precision

BLOCK_BYTES = 1 << 30
_CALLS: contextvars.ContextVar = contextvars.ContextVar("reference_attention_calls",
                                                        default=None)


@contextlib.contextmanager
def recording(calls: list):
    """Append ``dict(rows, heads, sq, skv, d, backward)`` for each attention
    call made inside the block to ``calls``."""
    token = _CALLS.set(calls)
    try:
        yield calls
    finally:
        _CALLS.reset(token)


def _block(q, k, v, scale, prec):
    s = torch.einsum("nqd,nkd->nqk", q, k) * scale
    return torch.einsum("nqk,nkd->nqd", prec(torch.softmax(s, dim=-1)), v)


def attention(q, k, v, prec: Precision = FP32):
    """q (N, Sq, H, D), k and v (N, Skv, H, D) -> (N, Sq, H, D) float32."""
    n, sq, h, d = q.shape
    skv = k.shape[1]
    calls = _CALLS.get()
    if calls is not None:
        calls.append(dict(rows=n, heads=h, sq=sq, skv=skv, d=d,
                          backward=bool(q.requires_grad or k.requires_grad
                                        or v.requires_grad)))

    def heads_first(x):
        return prec(x.float()).permute(0, 2, 1, 3).reshape(n * h, x.shape[1], d)

    qf, kf, vf = heads_first(q), heads_first(k), heads_first(v)
    scale = d ** -0.5
    if q.device.type == "meta":
        out = _block(qf, kf, vf, scale, prec)
    else:
        per = max(1, BLOCK_BYTES // (4 * sq * skv))
        grad = torch.is_grad_enabled() and (qf.requires_grad or kf.requires_grad
                                            or vf.requires_grad)
        outs = []
        for i in range(0, n * h, per):
            args = (qf[i:i + per], kf[i:i + per], vf[i:i + per], scale, prec)
            outs.append(checkpoint(_block, *args, use_reentrant=False) if grad
                        else _block(*args))
        out = torch.cat(outs)
    return out.reshape(n, h, sq, d).permute(0, 2, 1, 3)
