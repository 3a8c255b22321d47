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
  and head dim <= 256 (:func:`ops.kernels.flash_attention`);
* ``"K6"``: many short sequences (the JAX package's packed small-sequence
  kernel), not ported yet: a CUDA call raises;
* ``"single_kv"``: one key (the CLIP image token), whose softmax is 1, so the
  output is V broadcast;
* ``"sdpa"``: what the JAX package leaves to XLA (CLIP, the VAE's d=512
  head, everything below the flash threshold):
  ``F.scaled_dot_product_attention``.

On a CPU tensor every kernel wrapper runs its plain version, so the CPU
path computes the same routes in plain PyTorch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from aniportrait_tpu_torch.ops import kernels

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


def sdpa_route(batch: int, sq: int, skv: int, heads: int, head_dim: int) -> str:
    """Route of the generic ``(B, S, H, D)`` entry
    (``aniportrait_tpu/ops/attention.py:180-256``)."""
    if skv == 1:
        return "single_kv"
    if sq == skv and 2 <= sq <= SMALL_SEQ_MAX and batch * heads >= SMALL_SEQ_MIN_ROWS:
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


def scaled_dot_product_attention(q, k, v):
    """Multi-head attention over ``(B, S, H, D)`` tensors; returns
    ``(B, Sq, H, D)`` in q's dtype."""
    b, sq, h, d = q.shape
    route = sdpa_route(b, sq, k.shape[1], h, d)
    if route == "single_kv":
        return v.expand(b, sq, h, d).to(q.dtype)
    if route == "K6" and q.is_cuda:
        raise NotImplementedError(
            "attention of many short sequences routes to K6 (ctg_packed, "
            "aniportrait_tpu/ops/pallas_attention.py:1918), not ported yet"
        )
    if route == "K4":
        return kernels.flash_attention(q, k, v)
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    )
    return out.transpose(1, 2)


def token_attention(q, k, v, heads: int):
    """Attention over token-layout ``(B, S, C)`` projections."""
    b, sq, c = q.shape
    skv, d = k.shape[1], c // heads
    if attention_route(b, sq, skv, heads, d) == "K2":
        return kernels.tok_flash(q, k, v, heads)
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
        return kernels.tok_flash_banked(q, k, v, kb, vb, heads, rep)
    k = torch.cat([k, kb.repeat_interleave(rep, dim=0)], dim=1)
    v = torch.cat([v, vb.repeat_interleave(rep, dim=0)], dim=1)
    return token_attention(q, k, v, heads)


def temporal_attention(q, k, v, heads: int):
    """Self attention along the frame axis of natural ``(b, f, s, c)``
    activations, independently per spatial position and head."""
    b, f, s, c = q.shape
    d = c // heads
    if attention_route(b, s, s, heads, d, frames=f) == "K3":
        out = kernels.nat_temporal(
            q.reshape(b * f, s, c), k.reshape(b * f, s, c),
            v.reshape(b * f, s, c), f, heads, math.log2(math.e) / math.sqrt(d),
        )
        return out.reshape(b, f, s, c)

    def tok(x):
        return x.permute(0, 2, 1, 3).reshape(b * s, f, heads, d)

    out = scaled_dot_product_attention(tok(q), tok(k), tok(v))
    return out.reshape(b, s, f, c).permute(0, 2, 1, 3)
