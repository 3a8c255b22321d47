"""Gradients of the attention kernels: one ``torch.autograd.Function`` per
custom VJP of ``aniportrait_tpu/ops/pallas_attention.py``.

* :class:`FlashAttention` (``_flash``, :359-599): with any input needing a
  gradient the forward runs K5a and keeps its output and LSE; otherwise it
  runs K4.  The backward runs K5b.
* :class:`TokFlash` (``tok_flash``, :1358-1395): K2 forward; the backward
  recomputes the output and LSE through K5a on the ``(B, S, H, D)`` view and
  runs K5b, as ``_tok_flash_bwd`` does.
* :class:`TokFlashBanked` (``tok_flash_banked``, :1675-1721): K1 forward;
  the backward builds the concat ``[k | repeat(kb, rep)]``, runs K5a and K5b
  and sums the bank's gradients over the ``rep`` rows that share it.
* :class:`NatTemporal` (``nat_packed``, :2134-2156): K3 forward; the
  backward is autograd of the plain version, as the JAX backward is the XLA
  core and not a Pallas kernel.  It runs inside the profiler range
  :data:`K3_BACKWARD`, so a profile can tell its device time apart, and in
  a tracer span of the same name (on a GPU, on autograd's thread).
* :class:`CtgPacked` (``ctg_packed``, :2194-2215): K6 forward; the backward
  is autograd of the plain version, as ``_ctg_bwd`` is the XLA core's VJP.
* :class:`SsaPacked` (``ssa_packed``, :2252-2271): K9 forward; the backward
  is autograd of the plain version, as ``_ssa_bwd`` is the XLA core's VJP.

Each forward and backward goes through the kernel wrappers, so on CPU
tensors they run the plain versions and on CUDA tensors the kernels.
"""

from __future__ import annotations

import torch

from aniportrait_tpu_torch.ops.kernels import flash, small_seq, temporal
from aniportrait_tpu_torch.utils.profiling import span

K3_BACKWARD = "K3 plain backward"


def _needs_grad(ctx, n: int) -> bool:
    return any(ctx.needs_input_grad[:n])


class FlashAttention(torch.autograd.Function):
    """``(B, Sq, H, D)`` attention with the optional bank-drop mask."""

    @staticmethod
    def forward(ctx, q, k, v, drop_tail=None, kv_split=None):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if not _needs_grad(ctx, 3):
            return flash.flash_attention(q, k, v, drop_tail, kv_split)
        out, lse = flash.flash_attention_fwd_lse(q, k, v, drop_tail, kv_split)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.drop = (drop_tail, kv_split)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash.flash_attention_bwd(q, k, v, out, lse, g, *ctx.drop)
        return dq, dk, dv, None, None


def _bshd_grads(q, k, v, g, heads):
    """K5a then K5b on the ``(B, S, H, D)`` views of token-layout operands;
    returns token-layout ``(dq, dk, dv)``."""
    b, sq, c = q.shape
    skv, d = k.shape[1], c // heads
    q4, k4, v4 = (x.reshape(x.shape[0], x.shape[1], heads, d) for x in (q, k, v))
    out, lse = flash.flash_attention_fwd_lse(q4, k4, v4)
    dq, dk, dv = flash.flash_attention_bwd(q4, k4, v4, out, lse,
                                           g.reshape(b, sq, heads, d))
    return dq.reshape(b, sq, c), dk.reshape(b, skv, c), dv.reshape(b, skv, c)


class TokFlash(torch.autograd.Function):
    """Token-layout ``(B, S, C)`` attention, heads sliced from C."""

    @staticmethod
    def forward(ctx, q, k, v, heads):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if _needs_grad(ctx, 3):
            ctx.save_for_backward(q, k, v)
            ctx.heads = heads
        return flash.tok_flash(q, k, v, heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*_bshd_grads(q, k, v, g, ctx.heads), None)


class TokFlashBanked(torch.autograd.Function):
    """Attention of ``q (B, S, C)`` over ``[k | repeat(kb, rep)]``."""

    @staticmethod
    def forward(ctx, q, k, v, kb, vb, heads, rep):
        q, k, v, kb, vb = (x.contiguous() for x in (q, k, v, kb, vb))
        if _needs_grad(ctx, 5):
            ctx.save_for_backward(q, k, v, kb, vb)
            ctx.heads, ctx.rep = heads, rep
        return flash.tok_flash_banked(q, k, v, kb, vb, heads, rep)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kb, vb = ctx.saved_tensors
        rep, s = ctx.rep, k.shape[1]
        kc = torch.cat([k, kb.repeat_interleave(rep, dim=0)], dim=1)
        vc = torch.cat([v, vb.repeat_interleave(rep, dim=0)], dim=1)
        dq, dkc, dvc = _bshd_grads(q, kc, vc, g, ctx.heads)

        def bank(x):  # (B, L, C) -> (B // rep, L, C), summed over the rep rows
            return x.reshape(-1, rep, *x.shape[1:]).float().sum(1).to(x.dtype)

        return (dq, dkc[:, :s], dvc[:, :s], bank(dkc[:, s:]), bank(dvc[:, s:]),
                None, None)


class NatTemporal(torch.autograd.Function):
    """Frame-axis attention of natural ``(b * f, s, c)`` activations;
    ``scale`` is the base-2 scale of the JAX ``nat_packed`` contract."""

    @staticmethod
    def forward(ctx, q, k, v, frames, heads, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if _needs_grad(ctx, 3):
            ctx.save_for_backward(q, k, v)
            ctx.args = (frames, heads, scale * temporal.LN2)
        return temporal.nat_temporal(q, k, v, frames, heads, scale)

    @staticmethod
    def backward(ctx, g):
        with torch.profiler.record_function(K3_BACKWARD), span(K3_BACKWARD):
            inputs = [x.detach().requires_grad_() for x in ctx.saved_tensors]
            with torch.enable_grad():
                out = temporal.plain_nat_temporal(*inputs, *ctx.args)
            grads = torch.autograd.grad(out, inputs, g)
        return (*grads, None, None, None)


class CtgPacked(torch.autograd.Function):
    """Attention within contiguous ``seq``-row sequences of token-layout
    ``(..., C)`` tensors; ``scale`` is the base-2 scale of the JAX
    ``ctg_packed`` contract."""

    @staticmethod
    def forward(ctx, q, k, v, seq, heads, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if _needs_grad(ctx, 3):
            ctx.save_for_backward(q, k, v)
            ctx.args = (seq, heads, scale)
        return small_seq.ctg_packed(q, k, v, seq, heads, scale)

    @staticmethod
    def backward(ctx, g):
        inputs = [x.detach().requires_grad_() for x in ctx.saved_tensors]
        with torch.enable_grad():
            out = small_seq.plain_ctg_packed(*inputs, *ctx.args)
        return (*torch.autograd.grad(out, inputs, g), None, None, None)


class SsaPacked(torch.autograd.Function):
    """Attention within groups of ``seq`` rows of head-folded ``(n, T, dp)``
    tiles, q pre-scaled; rows from ``n_valid_rows`` on are dead (the JAX
    ``ssa_packed`` contract)."""

    @staticmethod
    def forward(ctx, q, k, v, seq, n_valid_rows=None):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if _needs_grad(ctx, 3):
            ctx.save_for_backward(q, k, v)
            ctx.args = (seq, n_valid_rows)
        return small_seq.ssa_packed(q, k, v, seq, n_valid_rows)

    @staticmethod
    def backward(ctx, g):
        inputs = [x.detach().requires_grad_() for x in ctx.saved_tensors]
        with torch.enable_grad():
            out = small_seq.plain_ssa_packed(*inputs, *ctx.args)
        return (*torch.autograd.grad(out, inputs, g), None, None)
