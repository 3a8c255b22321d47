"""AutoencoderKL (port of ``aniportrait_tpu/models/vae.py``; diffusers
module names).  Images are ``(N, 3, H, W)`` in [-1, 1], latents
``(N, 4, H/8, W/8)``; the 0.18215 latent scale is the pipeline's job."""

from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from aniportrait_tpu_torch.models.resnet import GroupNorm, ResnetBlock3D
from aniportrait_tpu_torch.models.transformer_spatial import from_tokens, to_tokens
from aniportrait_tpu_torch.ops.attention import scaled_dot_product_attention


class _Block(nn.Module):
    """Container for one encoder/decoder block's modules (names only)."""


def vae_resnet(c_in: int, c_out: int) -> ResnetBlock3D:
    return ResnetBlock3D(c_in, c_out, None, groups=32, eps=1e-6)


class VaeAttentionBlock(nn.Module):
    """Single-head spatial self attention of the mid block."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = GroupNorm(32, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        _, _, h, w = x.shape
        hid = to_tokens(self.group_norm(x))
        q, k, v = (proj(hid)[:, :, None, :] for proj in (self.to_q, self.to_k, self.to_v))
        hid = scaled_dot_product_attention(q, k, v)[:, :, 0, :]
        return x + from_tokens(self.to_out[0](hid), h, w)


class VaeMidBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.resnets = nn.ModuleList([vae_resnet(channels, channels) for _ in range(2)])
        self.attentions = nn.ModuleList([VaeAttentionBlock(channels)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class VaeEncoder(nn.Module):
    def __init__(self, block_out_channels: Sequence[int], layers_per_block: int = 2,
                 latent_channels: int = 4):
        super().__init__()
        ch = list(block_out_channels)
        self.conv_in = nn.Conv2d(3, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        for i, c in enumerate(ch):
            blk = _Block()
            blk.resnets = nn.ModuleList([
                vae_resnet(ch[max(i - 1, 0)] if j == 0 else c, c)
                for j in range(layers_per_block)
            ])
            if i < len(ch) - 1:
                down = _Block()
                down.conv = nn.Conv2d(c, c, 3, stride=2)
                blk.downsamplers = nn.ModuleList([down])
            self.down_blocks.append(blk)
        self.mid_block = VaeMidBlock(ch[-1])
        self.conv_norm_out = GroupNorm(32, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], 2 * latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            for resnet in blk.resnets:
                x = resnet(x)
            if hasattr(blk, "downsamplers"):
                # diffusers Downsample2D: pad (0, 1, 0, 1), stride-2 valid conv
                x = blk.downsamplers[0].conv(F.pad(x, (0, 1, 0, 1)))
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VaeDecoder(nn.Module):
    def __init__(self, block_out_channels: Sequence[int], layers_per_block: int = 3,
                 out_channels: int = 3, latent_channels: int = 4):
        super().__init__()
        rev = list(block_out_channels)[::-1]
        self.conv_in = nn.Conv2d(latent_channels, rev[0], 3, padding=1)
        self.mid_block = VaeMidBlock(rev[0])
        self.up_blocks = nn.ModuleList()
        for i, c in enumerate(rev):
            blk = _Block()
            blk.resnets = nn.ModuleList([
                vae_resnet(rev[max(i - 1, 0)] if j == 0 else c, c)
                for j in range(layers_per_block)
            ])
            if i < len(rev) - 1:
                up = _Block()
                up.conv = nn.Conv2d(c, c, 3, padding=1)
                blk.upsamplers = nn.ModuleList([up])
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm(32, rev[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], out_channels, 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            for resnet in blk.resnets:
                x = resnet(x)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0].conv(F.interpolate(x, scale_factor=2.0,
                                                         mode="nearest"))
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 latent_channels: int = 4):
        super().__init__()
        self.encoder = VaeEncoder(block_out_channels, latent_channels=latent_channels)
        self.decoder = VaeDecoder(block_out_channels, latent_channels=latent_channels)
        self.quant_conv = nn.Conv2d(2 * latent_channels, 2 * latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(latent_channels, latent_channels, 1)

    def encode(self, x):
        """(N, 3, H, W) in [-1, 1] -> (mean, logvar), each (N, 4, H/8, W/8)."""
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z):
        """(N, 4, h, w) -> (N, 3, 8h, 8w)."""
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x):
        return self.decode(self.encode(x)[0])
