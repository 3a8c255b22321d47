"""Pseudo-3D conv/resnet primitives (port of ``aniportrait_tpu/models/resnet.py``).

Video activations are kept frames-folded and channels-first,
``(b * f, c, h, w)``: an inflated conv or group norm is then the plain 2D
op, and the frame count travels beside the tensor.  Parameter names are the
reference torch checkpoint's.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from aniportrait_tpu_torch.ops.kernels import norm


class GroupNorm(nn.GroupNorm):
    """GroupNorm with float32 statistics, output in the input's dtype
    (``aniportrait_tpu/models/resnet.py:58``).  On folded ``(b * f, c, h,
    w)`` input the statistics are per frame (``inflated``, the reference's
    InflatedGroupNorm), or with ``inflated=False`` taken over all
    ``video_length`` frames of a sample, as a plain GroupNorm on ``(b, c, f,
    h, w)`` (``GroupNorm5D(inflated=False)``,
    ``aniportrait_tpu/models/resnet.py:104-128``).  ``silu``: the SiLU that
    follows at the call site, applied in the input's dtype.  A CUDA bf16 call
    that autograd does not record runs kernel N1 (``ops/kernels/norm.py``),
    every other call the float32 composition."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 inflated: bool = True):
        super().__init__(num_groups, num_channels, eps=eps)
        self.inflated = inflated

    def forward(self, x, video_length: int = 1, silu: bool = False):
        frames = 1 if self.inflated else video_length
        if norm.engages(x, self.weight, self.bias):
            return norm.group_norm(x.contiguous(), self.num_groups, self.weight, self.bias,
                                   self.eps, frames, silu)
        return norm.plain_group_norm(x, self.num_groups, self.weight, self.bias, self.eps,
                                     frames, silu)


class Downsample3D(nn.Module):
    """Stride-2 3x3 conv (torch name ``conv``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample3D(nn.Module):
    """Nearest x2 spatial upsample + 3x3 conv (torch name ``conv``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class ResnetBlock3D(nn.Module):
    """GN -> SiLU -> conv -> (+temb) -> GN -> SiLU -> conv -> (+shortcut)."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int | None,
                 groups: int = 32, eps: float = 1e-5, inflated: bool = True):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, eps=eps, inflated=inflated)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = (
            nn.Linear(temb_channels, out_channels) if temb_channels else None
        )
        self.norm2 = GroupNorm(groups, out_channels, eps=eps, inflated=inflated)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (
            nn.Conv2d(in_channels, out_channels, 1)
            if in_channels != out_channels else None
        )

    def forward(self, x, temb=None, video_length: int = 1):
        """x: (b * f, c, h, w); temb: (b, temb_channels)."""
        h = self.conv1(self.norm1(x, video_length, silu=True))
        if temb is not None:
            t = self.time_emb_proj(F.silu(temb))
            h = h + t.repeat_interleave(video_length, dim=0)[:, :, None, None]
        h = self.conv2(self.norm2(h, video_length, silu=True))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h
