"""Wrappers of the flash-attention CUDA kernel (``csrc/flash_attn.cu``) and
their plain PyTorch versions.

Three entry points share the kernel, one per Pallas kernel they replace
(``aniportrait_tpu/ops/pallas_attention.py``):

* :func:`tok_flash_banked` (K1, ``_tok_flash_banked_impl``): token layout
  ``(B, S, C)`` attention over the row's own keys followed by a reference
  bank ``(B // rep, S_bank, C)`` that row ``r`` reads at bank row ``r // rep``.
* :func:`tok_flash` (K2, ``flash_attention_tokens_unshifted`` and its
  running-max fallback ``flash_attention_tokens``): token layout self
  attention, heads sliced from ``C``.
* :func:`flash_attention` (K4, ``_flash_nopad``): ``(B, S, H, D)`` attention;
  rows flagged in ``drop_tail`` ignore keys at or past ``kv_split``.

On a CPU tensor each wrapper returns its plain version; on a CUDA tensor it
launches the kernel or raises.  Each counts its launches in ``.launches``.
"""

from __future__ import annotations

import torch

from aniportrait_tpu_torch.ops.kernels import build

MAX_HEAD_DIM = 256


# ------------------------------------------------------------ plain versions
def plain_attention_bshd(q, k, v, drop_tail=None, kv_split=None):
    """Reference math of all three entry points: explicit einsum and a
    float32 softmax over ``(B, S, H, D)`` operands, optional drop mask."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
    if drop_tail is not None:
        cols = torch.arange(k.shape[1], device=q.device) >= kv_split
        mask = drop_tail.to(torch.bool)[:, None, None, None] & cols
        logits = logits.masked_fill(mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def _heads(x, heads):
    b, s, c = x.shape
    return x.reshape(b, s, heads, c // heads)


def plain_tok_flash(q, k, v, heads):
    b, sq, c = q.shape
    out = plain_attention_bshd(_heads(q, heads), _heads(k, heads), _heads(v, heads))
    return out.reshape(b, sq, c)


def plain_tok_flash_banked(q, k, v, kb, vb, heads, rep):
    kc = torch.cat([k, kb.repeat_interleave(rep, dim=0)], dim=1)
    vc = torch.cat([v, vb.repeat_interleave(rep, dim=0)], dim=1)
    return plain_tok_flash(q, kc, vc, heads)


# ------------------------------------------------------------------ checks
def check_operands(name, tensors, head_dim):
    """Raise unless the operands are what the CUDA kernel takes."""
    dtype, device = tensors[0].dtype, tensors[0].device
    if not tensors[0].is_cuda:
        raise RuntimeError(f"{name}: tensor on {device}, expected CPU or CUDA")
    if dtype not in build.DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} not supported (bf16 or float32)")
    for t in tensors:
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"{name}: operands must share device and dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                f"{name}: no backward on CUDA yet (the flash backward, K5, "
                "is not ported)"
            )
    if not 1 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {head_dim} unsupported (1 ... 256)")


def _launch(name, q, k, v, kb, vb, drop, out, batch, sq, skv, sbank, heads,
            d, rep, kv_split):
    lib = build.library()
    ptr = lambda t: None if t is None else t.data_ptr()
    err = lib.aniportrait_flash_fwd(
        build.DTYPE_CODES[q.dtype], ptr(q), ptr(k), ptr(v), ptr(kb), ptr(vb),
        ptr(drop), ptr(out), batch, sq, skv, sbank, heads, d, rep, kv_split,
        float(d) ** -0.5, build.stream_handle(),
    )
    build.check(err, name)


# ---------------------------------------------------------------- wrappers
def tok_flash(q, k, v, heads: int):
    """K2: softmax(q k^T / sqrt(d)) v per head over token layout tensors.
    q: (B, Sq, C), k/v: (B, Skv, C), C = heads * d.  Returns (B, Sq, C)."""
    if q.device.type == "cpu":
        return plain_tok_flash(q, k, v, heads)
    b, sq, c = q.shape
    skv = k.shape[1]
    if c % heads or k.shape != (b, skv, c) or v.shape != k.shape:
        raise ValueError(f"tok_flash: shapes {q.shape} {k.shape} {v.shape}")
    check_operands("tok_flash", (q, k, v), c // heads)
    out = torch.empty_like(q)
    _launch("tok_flash", q, k, v, None, None, None, out, b, sq, skv, 0,
            heads, c // heads, 1, 0)
    tok_flash.launches += 1
    return out


def tok_flash_banked(q, k, v, kb, vb, heads: int, rep: int):
    """K1: attention of q over ``[k | repeat(kb, rep)]`` without building the
    concat.  q/k/v: (B, S, C); kb/vb: (B // rep, S_bank, C)."""
    if q.device.type == "cpu":
        return plain_tok_flash_banked(q, k, v, kb, vb, heads, rep)
    b, sq, c = q.shape
    skv, sbank = k.shape[1], kb.shape[1]
    if (c % heads or k.shape != (b, skv, c) or v.shape != k.shape
            or kb.shape != (b // rep, sbank, c) or vb.shape != kb.shape
            or kb.shape[0] * rep != b):
        raise ValueError(
            f"tok_flash_banked: shapes q {q.shape} k {k.shape} kb {kb.shape} "
            f"rep {rep}"
        )
    check_operands("tok_flash_banked", (q, k, v, kb, vb), c // heads)
    out = torch.empty_like(q)
    _launch("tok_flash_banked", q, k, v, kb, vb, None, out, b, sq, skv,
            sbank, heads, c // heads, rep, 0)
    tok_flash_banked.launches += 1
    return out


def flash_attention(q, k, v, drop_tail=None, kv_split=None):
    """K4: (B, Sq, H, D) attention over (B, Skv, H, D) keys/values; rows with
    ``drop_tail`` set attend to keys ``[0, kv_split)`` only."""
    if q.device.type == "cpu":
        return plain_attention_bshd(q, k, v, drop_tail, kv_split)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if k.shape != (b, skv, h, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes {q.shape} {k.shape} {v.shape}")
    check_operands("flash_attention", (q, k, v), d)
    drop = None
    if drop_tail is not None:
        if kv_split is None or not 1 <= kv_split <= skv or drop_tail.shape != (b,):
            raise ValueError("flash_attention: drop_tail needs 1 <= kv_split <= Skv")
        drop = drop_tail.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    _launch("flash_attention", q, k, v, None, None, drop, out, b, sq, skv, 0,
            h, d, 1, kv_split or 0)
    flash_attention.launches += 1
    return out


tok_flash.launches = 0
tok_flash_banked.launches = 0
flash_attention.launches = 0
