"""Per-frame spatial transformer (port of
``aniportrait_tpu/models/transformer_spatial.py``): GroupNorm -> 1x1 proj_in
-> transformer block -> 1x1 proj_out -> residual.  The 1x1 projections keep
the checkpoint's conv shapes ``(C, C, 1, 1)`` and run as linear maps on
tokens."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from aniportrait_tpu_torch.models.attention import SpatialTransformerBlock
from aniportrait_tpu_torch.models.resnet import GroupNorm


def conv1x1_tokens(conv: nn.Conv2d, x):
    """A 1x1 conv applied to (N, S, C_in) tokens."""
    return F.linear(x, conv.weight[:, :, 0, 0], conv.bias)


def to_tokens(x):
    """(N, C, H, W) -> (N, H * W, C)."""
    n, c, h, w = x.shape
    return x.reshape(n, c, h * w).transpose(1, 2)


def from_tokens(x, h: int, w: int):
    """(N, H * W, C) -> (N, C, H, W)."""
    n, _, c = x.shape
    return x.transpose(1, 2).reshape(n, c, h, w)


class SpatialTransformer(nn.Module):
    def __init__(self, channels: int, heads: int, cross_attention_dim: int | None = 768,
                 norm_groups: int = 32):
        super().__init__()
        self.norm = GroupNorm(norm_groups, channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList([
            SpatialTransformerBlock(channels, heads, channels // heads,
                                    cross_attention_dim)
        ])
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x, video_length: int, context=None, ref_bank=None,
                capture_bank: bool = False, drop_mode: str = "none"):
        """x: (b * f, c, h, w); context: (b, S_ctx, ctx_dim) (repeated over
        frames here); ref_bank: (b, L, c).  Returns (x, captured banks)."""
        bf, c, h, w = x.shape
        hid = conv1x1_tokens(self.proj_in, to_tokens(self.norm(x)))
        if context is not None and context.shape[0] != bf:
            context = context.repeat_interleave(video_length, dim=0)
        banks = []
        for block in self.transformer_blocks:
            hid, bank = block(hid, context, ref_bank, video_length, capture_bank,
                              drop_mode)
            if bank is not None:
                banks.append(bank)
        hid = conv1x1_tokens(self.proj_out, hid)
        return x + from_tokens(hid, h, w), banks
