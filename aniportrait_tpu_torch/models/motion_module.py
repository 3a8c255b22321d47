"""AnimateDiff-style temporal motion module (port of
``aniportrait_tpu/models/motion_module.py``, whole-clip form).

GroupNorm (per frame) -> Linear proj_in -> temporal transformer block
(2 x temporal self attention with a sinusoidal positional encoding, GEGLU
feed-forward) -> Linear proj_out -> residual.  Attention runs along the frame
axis of natural ``(b, f, s, c)`` activations through the temporal kernel.
Parameter names are the reference checkpoint's
(``temporal_transformer.transformer_blocks.0.attention_blocks.N...``).
"""

from __future__ import annotations

import torch
from torch import nn

from aniportrait_tpu_torch.models.attention import CrossAttention, FeedForward, LayerNorm
from aniportrait_tpu_torch.models.embeddings import sinusoidal_positional_encoding
from aniportrait_tpu_torch.models.resnet import GroupNorm
from aniportrait_tpu_torch.models.transformer_spatial import from_tokens, to_tokens


class PositionalEncoding(nn.Module):
    """Holds the checkpoint's ``pe`` buffer (1, max_len, dim)."""

    def __init__(self, dim: int, max_len: int = 32):
        super().__init__()
        self.register_buffer("pe", torch.zeros(1, max_len, dim))
        self.reset_parameters()

    def reset_parameters(self):
        _, max_len, dim = self.pe.shape
        with torch.no_grad():
            self.pe.copy_(torch.from_numpy(sinusoidal_positional_encoding(max_len, dim)))


class TemporalAttention(CrossAttention):
    def __init__(self, dim: int, heads: int, pe_max_len: int = 32):
        super().__init__(dim, heads, dim // heads)
        self.pos_encoder = PositionalEncoding(dim, pe_max_len)


class TemporalTransformerBlock(nn.Module):
    """2 x (LayerNorm -> + PE -> temporal self attention -> residual) -> FF."""

    def __init__(self, dim: int, heads: int, num_attention_blocks: int = 2,
                 pe_max_len: int = 32):
        super().__init__()
        self.attention_blocks = nn.ModuleList(
            [TemporalAttention(dim, heads, pe_max_len)
             for _ in range(num_attention_blocks)]
        )
        self.norms = nn.ModuleList(
            [LayerNorm(dim, eps=1e-5) for _ in range(num_attention_blocks)]
        )
        self.ff = FeedForward(dim)
        self.ff_norm = LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        """x: (b, f, s, c) natural layout."""
        f = x.shape[1]
        for attn, norm in zip(self.attention_blocks, self.norms):
            pe = attn.pos_encoder.pe[:, :f, None, :].to(x.dtype)
            x = x + attn(norm(x) + pe)
        return x + self.ff(self.ff_norm(x))


class TemporalTransformer3D(nn.Module):
    def __init__(self, channels: int, heads: int = 8, num_transformer_blocks: int = 1,
                 num_attention_blocks: int = 2, pe_max_len: int = 32,
                 norm_groups: int = 32):
        super().__init__()
        self.norm = GroupNorm(norm_groups, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList([
            TemporalTransformerBlock(channels, heads, num_attention_blocks, pe_max_len)
            for _ in range(num_transformer_blocks)
        ])
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x, video_length: int, windows=None):
        """x: (b * f, c, h, w) -> same shape."""
        if windows is not None:
            raise NotImplementedError(
                "window-fused motion modules are not ported yet"
            )
        bf, c, h, w = x.shape
        hid = self.proj_in(to_tokens(self.norm(x)))
        hid = hid.reshape(bf // video_length, video_length, h * w, c)
        for block in self.transformer_blocks:
            hid = block(hid)
        hid = self.proj_out(hid.reshape(bf, h * w, c))
        return x + from_tokens(hid, h, w)


class MotionModule(nn.Module):
    """VanillaTemporalModule: holds ``temporal_transformer``."""

    def __init__(self, channels: int, heads: int = 8, num_transformer_blocks: int = 1,
                 pe_max_len: int = 32):
        super().__init__()
        self.temporal_transformer = TemporalTransformer3D(
            channels, heads, num_transformer_blocks, pe_max_len=pe_max_len
        )

    def forward(self, x, video_length: int, windows=None):
        return self.temporal_transformer(x, video_length, windows)
