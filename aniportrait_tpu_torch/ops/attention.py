"""The port's single attention dispatch point.

Routing mirrors the JAX package on an accelerator
(``aniportrait_tpu/ops/attention.py:140-256`` and
``aniportrait_tpu/models/attention.py:82-180``), so each kernel sees the
shapes its TPU counterpart saw.  :func:`attention_route` is the decision as a
pure function of the shapes:

* ``"K1"``: self + reference-bank attention at ``inner <= 320``
  (:func:`ops.kernels.tok_flash_banked`);
* ``"K2"``: token-layout attention at ``inner <= 640``
  (:func:`ops.kernels.tok_flash`);
* ``"K3"``: temporal attention on natural ``(b, f, s, c)`` activations
  (:func:`ops.kernels.nat_temporal`);
* ``"K4"``: any other attention with ``Sq * Skv >= FLASH_MIN_LOGITS``
  and head dim <= 256, with or without the bank-drop mask
  (:func:`ops.kernels.flash_attention`);
* ``"K6"``: self attention of many short sequences (<= 32 rows, at least
  ``SMALL_SEQ_MIN_ROWS`` sequence-heads): :func:`small_seq_attention`
  (:func:`ops.kernels.ctg_packed`).  The temporal attention reaches it when
  K3 cannot pack the latent grid (``s % temporal_pack(f) != 0``);
* ``"single_kv"``: one key (the CLIP image token), whose softmax is 1, so the
  output is V broadcast;
* ``"sdpa"``: what the JAX package leaves to XLA (CLIP, the VAE's d=512
  head, everything below the flash threshold, with the bank-drop mask as a
  boolean mask where the JAX package adds a -1e9 bias):
  ``F.scaled_dot_product_attention``.

:func:`small_seq_attention_folded` is the head-folded form of the short
sequence attention through K9 (:func:`ops.kernels.ssa_packed`); no route
takes it, as no route of the JAX package takes ``ssa_packed``.

Every kernel route goes through the kernel's ``torch.autograd.Function``
(``ops/kernels/autograd.py``): where an input needs a gradient, K1, K2 and K4
keep what their backward needs and the backward runs K5a and K5b (the flash
forward with LSE and the flash backward).  On a CPU tensor every kernel
wrapper runs its plain version, so the CPU path computes the same routes in
plain PyTorch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from aniportrait_tpu_torch.ops.kernels.autograd import (
    CtgPacked,
    FlashAttention,
    NatTemporal,
    SsaPacked,
    TokFlash,
    TokFlashBanked,
)
from aniportrait_tpu_torch.ops.kernels.flash import scaled_in_dtype

# Same thresholds as aniportrait_tpu/ops/attention.py
FLASH_MIN_LOGITS = 1 << 20
SMALL_SEQ_MAX = 32
SMALL_SEQ_MIN_ROWS = 1024
MAX_FLASH_HEAD_DIM = 256
BANKED_MAX_INNER = 320
TOKEN_MAX_INNER = 640


def temporal_pack(frames: int) -> int:
    """Spatial positions the JAX temporal kernel packs per tile (0: the
    frame count has no natural-layout route)."""
    return 1 << int(math.log2(128 // frames)) if 2 <= frames <= 64 else 0


def sdpa_route(batch: int, sq: int, skv: int, heads: int, head_dim: int,
               masked: bool = False) -> str:
    """Route of the generic ``(B, S, H, D)`` entry
    (``aniportrait_tpu/ops/attention.py:180-256``); ``masked``: the call
    carries the bank-drop mask, which only the flash kernel and the plain
    attention take."""
    if not masked and skv == 1:
        return "single_kv"
    if (not masked and sq == skv and 2 <= sq <= SMALL_SEQ_MAX
            and batch * heads >= SMALL_SEQ_MIN_ROWS):
        return "K6"
    if sq * skv >= FLASH_MIN_LOGITS and head_dim <= MAX_FLASH_HEAD_DIM:
        return "K4"
    return "sdpa"


def attention_route(batch: int, sq: int, skv: int, heads: int, head_dim: int,
                    bank: int = 0, frames: int = 0) -> str:
    """Route of one ``CrossAttention`` call.

    batch/sq/skv: the token-layout query and key shapes; heads/head_dim:
    the attention's; bank: length of the reference bank appended to the
    keys (0: none); frames: temporal call on ``(batch, frames, sq, c)``
    activations (``sq`` is then the spatial size).
    """
    inner = heads * head_dim
    if frames:
        pack = temporal_pack(frames)
        if pack and sq % pack == 0:
            return "K3"
        return sdpa_route(batch * sq, frames, frames, heads, head_dim)
    if bank:
        if (sq * (skv + bank) >= FLASH_MIN_LOGITS
                and head_dim <= MAX_FLASH_HEAD_DIM and inner <= BANKED_MAX_INNER):
            return "K1"
        skv += bank
    if (sq * skv >= FLASH_MIN_LOGITS and head_dim <= MAX_FLASH_HEAD_DIM
            and inner <= TOKEN_MAX_INNER):
        return "K2"
    return sdpa_route(batch, sq, skv, heads, head_dim)


def small_seq_attention(q, k, v):
    """Self attention of ``(B, S, H, D)`` tensors with a short ``S``
    (``aniportrait_tpu/ops/attention.py:57-87``): the token-layout
    ``(B, S, C)`` view through K6 with the base-2 scale."""
    b, s, h, d = q.shape
    out = CtgPacked.apply(
        q.reshape(b, s, h * d), k.reshape(b, s, h * d), v.reshape(b, s, h * d),
        s, h, math.log2(math.e) / math.sqrt(d),
    )
    return out.reshape(b, s, h, d)


def small_seq_attention_folded(q, k, v):
    """Self attention of ``(B, S, H, D)`` tensors with a short ``S`` through
    K9: the head-folded packing of ``aniportrait_tpu/ops/attention.py:89-119``
    with the Pallas kernel's tile math.  The ``B * H`` sequences are folded
    out of the heads, q is scaled by ``1/sqrt(D)`` in its dtype, and
    ``128 // S`` sequences fill a tile of ``(128 // S) * S`` rows; the last
    tile is filled up with dead (zero) sequences, which are sliced away."""
    b, s, h, d = q.shape
    g = max(1, 128 // s)
    rows = b * h
    pad = (-rows) % g

    def pack(x):  # (B, S, H, D) -> (n, g * S, D)
        x = x.permute(0, 2, 1, 3).reshape(rows, s, d)
        return F.pad(x, (0, 0, 0, 0, 0, pad)).reshape(-1, g * s, d)

    out = SsaPacked.apply(pack(scaled_in_dtype(q, d ** -0.5)), pack(k), pack(v), s)
    return out.reshape(-1, s, d)[:rows].reshape(b, h, s, d).permute(0, 2, 1, 3)


def scaled_dot_product_attention(q, k, v, kv_split=None, drop_tail=None):
    """Multi-head attention over ``(B, S, H, D)`` tensors; returns
    ``(B, Sq, H, D)`` in q's dtype.  ``kv_split``/``drop_tail``: the keys
    are ``[self (kv_split) | bank]`` and the rows flagged in ``drop_tail``
    (B,) ignore the bank."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    masked = kv_split is not None and drop_tail is not None
    route = sdpa_route(b, sq, skv, h, d, masked)
    if route == "K4":
        return FlashAttention.apply(q, k, v, *((drop_tail, kv_split) if masked else ()))
    if route == "single_kv":
        return v.expand(b, sq, h, d).to(q.dtype)
    if route == "K6":
        return small_seq_attention(q, k, v)
    keep = None
    if masked:
        bank = torch.arange(skv, device=q.device) >= kv_split
        drop = drop_tail.to(device=q.device, dtype=torch.bool)
        keep = ~(drop[:, None, None, None] & bank)  # (B, 1, 1, Skv)
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=keep
    )
    return out.transpose(1, 2)


def token_attention(q, k, v, heads: int):
    """Attention over token-layout ``(B, S, C)`` projections."""
    b, sq, c = q.shape
    skv, d = k.shape[1], c // heads
    if attention_route(b, sq, skv, heads, d) == "K2":
        return TokFlash.apply(q, k, v, heads)
    out = scaled_dot_product_attention(
        q.reshape(b, sq, heads, d), k.reshape(b, skv, heads, d),
        v.reshape(b, skv, heads, d),
    )
    return out.reshape(b, sq, c)


def banked_attention(q, k, v, kb, vb, heads: int, rep: int):
    """Attention of q ``(B, S, C)`` over ``[k | repeat(kb, rep)]``; the bank
    ``kb/vb (B // rep, S_bank, C)`` serves ``rep`` consecutive rows."""
    b, sq, c = q.shape
    if kb.shape[0] * rep != b:
        raise ValueError(f"bank rows {kb.shape[0]} x rep {rep} != batch {b}")
    route = attention_route(b, sq, k.shape[1], heads, c // heads, bank=kb.shape[1])
    if route == "K1":
        return TokFlashBanked.apply(q, k, v, kb, vb, heads, rep)
    k = torch.cat([k, kb.repeat_interleave(rep, dim=0)], dim=1)
    v = torch.cat([v, vb.repeat_interleave(rep, dim=0)], dim=1)
    return token_attention(q, k, v, heads)


def dropped_bank_attention(q, k, v, kb, vb, heads: int, rep: int, drop_tail):
    """:func:`banked_attention` where the rows flagged in ``drop_tail`` (B,)
    ignore the bank (the JAX package's traced CFG-dropout mask).  As there
    (``aniportrait_tpu/models/attention.py:89-136``) the banked kernel is
    skipped: the concat goes through the masked flash call."""
    b, sq, c = q.shape
    s, d = k.shape[1], c // heads
    k = torch.cat([k, kb.repeat_interleave(rep, dim=0)], dim=1)
    v = torch.cat([v, vb.repeat_interleave(rep, dim=0)], dim=1)
    skv = k.shape[1]
    out = scaled_dot_product_attention(
        q.reshape(b, sq, heads, d), k.reshape(b, skv, heads, d),
        v.reshape(b, skv, heads, d), kv_split=s, drop_tail=drop_tail,
    )
    return out.reshape(b, sq, c)


def temporal_attention(q, k, v, heads: int):
    """Self attention along the frame axis of natural ``(b, f, s, c)``
    activations, independently per spatial position and head."""
    b, f, s, c = q.shape
    d = c // heads
    if attention_route(b, s, s, heads, d, frames=f) == "K3":
        out = NatTemporal.apply(
            q.reshape(b * f, s, c), k.reshape(b * f, s, c),
            v.reshape(b * f, s, c), f, heads, math.log2(math.e) / math.sqrt(d),
        )
        return out.reshape(b, f, s, c)

    def tok(x):
        return x.permute(0, 2, 1, 3).reshape(b * s, f, heads, d)

    out = scaled_dot_product_attention(tok(q), tok(k), tok(v))
    return out.reshape(b, s, f, c).permute(0, 2, 1, 3)
