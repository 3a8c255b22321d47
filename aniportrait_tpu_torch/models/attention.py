"""Transformer blocks of the diffusion UNets (port of
``aniportrait_tpu/models/attention.py``).

``SpatialTransformerBlock`` is the reference's BasicTransformerBlock (the
ReferenceNet writer, ``capture_bank=True``) and TemporalBasicTransformerBlock
(the denoising-UNet reader, ``ref_bank=...``) in one class: both have the
same parameters.  All attention goes through ``ops/attention.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from aniportrait_tpu_torch.ops.attention import (
    banked_attention,
    dropped_bank_attention,
    temporal_attention,
    token_attention,
)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with float32 statistics, output in the input's dtype."""

    def forward(self, x):
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(),
            self.bias.float(), self.eps,
        ).to(x.dtype)


class CrossAttention(nn.Module):
    """Multi-head attention with separate query and key/value inputs
    (torch names ``to_q``, ``to_k``, ``to_v``, ``to_out.0``)."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 cross_attention_dim: int | None = None, bias: bool = False):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.to_q = nn.Linear(query_dim, inner, bias=bias)
        self.to_k = nn.Linear(cross_attention_dim or query_dim, inner, bias=bias)
        self.to_v = nn.Linear(cross_attention_dim or query_dim, inner, bias=bias)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x, context=None, extra_kv=None, extra_repeat: int = 1,
                drop_tail=None):
        """x: (B, Sq, C) tokens, or (b, f, s, c) natural-layout activations
        for temporal self attention along f.  context: (B, Skv, Ckv) or None
        (self attention).  extra_kv: (B // extra_repeat, L, C) reference-bank
        tokens appended to the keys after projection (projected once per
        bank row, not per frame row).  drop_tail: (B,) bool, rows that
        ignore the bank."""
        context = x if context is None else context
        q = self.to_q(x)
        k = self.to_k(context)
        v = self.to_v(context)
        if x.ndim == 4:
            out = temporal_attention(q, k, v, self.heads)
        elif extra_kv is not None and drop_tail is not None:
            out = dropped_bank_attention(
                q, k, v, self.to_k(extra_kv), self.to_v(extra_kv), self.heads,
                extra_repeat, drop_tail)
        elif extra_kv is not None:
            out = banked_attention(q, k, v, self.to_k(extra_kv),
                                   self.to_v(extra_kv), self.heads, extra_repeat)
        else:
            out = token_attention(q, k, v, self.heads)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    """proj -> split -> hidden * gelu(gate) (torch name ``proj``; the first
    half of the projection is the hidden state, the second the gate).  The
    gelu is the tanh approximation, as in the JAX package (flax's default)."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * dim_out)

    def forward(self, x):
        hidden, gate = self.proj(x).chunk(2, dim=-1)
        return hidden * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    """GEGLU feed-forward, mult 4 (torch names ``net.0``, ``net.2``)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x


class SpatialTransformerBlock(nn.Module):
    """norm1/attn1 (self, optionally + reference bank) -> norm2/attn2
    (cross) -> norm3/ff."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 cross_attention_dim: int | None = 768):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, heads, dim_head)
        if cross_attention_dim is not None:
            self.norm2 = LayerNorm(dim, eps=1e-5)
            self.attn2 = CrossAttention(dim, heads, dim_head, cross_attention_dim)
        else:
            self.norm2 = self.attn2 = None
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context=None, ref_bank=None, video_length: int = 1,
                capture_bank: bool = False, drop_mode: str = "none",
                drop_ref=None):
        """x: (B * F, S, C) tokens; context: (B * F, S_ctx, ctx_dim);
        ref_bank: (B, L, C) reference tokens, unrepeated.  drop_mode: 'none'
        (every row reads the bank), 'first_half' (CFG layout: the first
        half of the rows, the unconditional ones, attend to themselves only)
        or 'traced' (the rows of the batch entries flagged in ``drop_ref``
        (B,) ignore the bank, through the masked attention; the training
        path's CFG dropout).  The two halves of 'first_half' apart, for a
        rank of the CFG-split sampler that holds one: 'uncond' (no row reads
        the bank) and 'cond' (every row reads it; the bank's row for token
        row r is r // video_length of the local rows).
        Returns (x, the post-norm1 hidden states if capture_bank else None)."""
        h = self.norm1(x)
        bank = h if capture_bank else None
        if ref_bank is None or drop_mode == "uncond":
            x = x + self.attn1(h)
        elif drop_mode in ("none", "cond"):
            x = x + self.attn1(h, extra_kv=ref_bank, extra_repeat=video_length)
        elif drop_mode == "first_half":
            half, half_b = h.shape[0] // 2, ref_bank.shape[0] // 2
            out_u = self.attn1(h[:half])
            out_c = self.attn1(h[half:], extra_kv=ref_bank[half_b:],
                               extra_repeat=video_length)
            x = x + torch.cat([out_u, out_c], dim=0)
        elif drop_mode == "traced":
            if drop_ref is None:
                row_drop = torch.zeros(h.shape[0], dtype=torch.bool, device=h.device)
            else:
                row_drop = drop_ref.to(torch.bool).repeat_interleave(video_length)
            x = x + self.attn1(h, extra_kv=ref_bank, extra_repeat=video_length,
                               drop_tail=row_drop)
        else:
            raise ValueError(f"unknown drop_mode {drop_mode!r}")
        if self.attn2 is not None:
            x = x + self.attn2(self.norm2(x), context=context)
        x = x + self.ff(self.norm3(x))
        return x, bank
