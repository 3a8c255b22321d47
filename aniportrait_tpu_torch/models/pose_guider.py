"""Multi-scale pose-conditioning encoder (port of
``aniportrait_tpu/models/pose_guider.py``).

Stem of conv+BatchNorm+ReLU layers (``conv_layers``), a zero-init 1x1
projection and a learnable scalar ``scale``, then a pyramid
(``conv_layers_1..n``), each stage followed by a self-attention transformer
(``cross_attn1..n``; 16 heads x 88 at full size).  As in the JAX package the
reference's dead reference-pose path is not run.  BatchNorm computes in
float32: in eval mode on the running statistics, in train mode on the batch's
with flax's semantics (see :class:`BatchNorm2d`).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from aniportrait_tpu_torch.models.attention import SpatialTransformerBlock
from aniportrait_tpu_torch.models.resnet import GroupNorm
from aniportrait_tpu_torch.models.transformer_spatial import (
    conv1x1_tokens,
    from_tokens,
    to_tokens,
)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm computed in float32, output in the input's dtype.

    Train mode follows flax's ``nn.BatchNorm`` (the JAX package's,
    ``aniportrait_tpu/models/pose_guider.py:51-57``), not torch's: the batch
    variance is the biased ``E[x^2] - E[x]^2`` (clipped at 0) both for the
    normalisation and for the running update, which moves the statistics by
    ``momentum`` (0.1 here, flax's 0.9 on the old value).  Torch's own
    update uses the unbiased variance."""

    def forward(self, x):
        xf = x.float()
        if not self.training:
            return F.batch_norm(
                xf, self.running_mean.float(), self.running_var.float(),
                self.weight.float(), self.bias.float(), False, 0.0, self.eps,
            ).to(x.dtype)
        mean = xf.mean((0, 2, 3))
        var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            self.running_mean.lerp_(mean.detach(), self.momentum)
            self.running_var.lerp_(var.detach(), self.momentum)
        mul = self.weight.float() * torch.rsqrt(var + self.eps)
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias.float()[:, None, None]
        return y.to(x.dtype)


def conv_bn_relu(c_in: int, c_out: int, kernel: int, stride: int) -> List[nn.Module]:
    return [nn.Conv2d(c_in, c_out, kernel, stride=stride, padding=1),
            BatchNorm2d(c_out, eps=1e-5, momentum=0.1), nn.ReLU()]


class PoseGuiderTransformer(nn.Module):
    """GroupNorm -> 1x1 proj_in (C -> heads * dim_head) -> self-attention
    block -> 1x1 proj_out -> residual."""

    def __init__(self, channels: int, heads: int = 16, dim_head: int = 88):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm(32, channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            [SpatialTransformerBlock(inner, heads, dim_head, cross_attention_dim=None)]
        )
        self.proj_out = nn.Conv2d(inner, channels, 1)

    def forward(self, x):
        _, _, h, w = x.shape
        hid = conv1x1_tokens(self.proj_in, to_tokens(self.norm(x)))
        hid, _ = self.transformer_blocks[0](hid)
        return x + from_tokens(conv1x1_tokens(self.proj_out, hid), h, w)


class PoseGuider(nn.Module):
    STEM = [(3, 3, 3, 1), (3, 16, 4, 2), (16, 16, 3, 1), (16, 32, 4, 2),
            (32, 32, 3, 1), (32, 64, 4, 2), (64, 64, 3, 1), (64, 128, 3, 1)]

    def __init__(self, noise_latent_channels: int = 320, attn_heads: int = 16,
                 attn_dim_head: int = 88, num_stages: int = 4):
        super().__init__()
        nc, n = noise_latent_channels, num_stages
        self.num_stages = n
        self.conv_layers = nn.Sequential(
            *[m for c_in, c_out, k, s in self.STEM for m in conv_bn_relu(c_in, c_out, k, s)]
        )
        self.final_proj = nn.Conv2d(128, nc, 1)
        self.scale = nn.Parameter(torch.full((1,), 2.0))
        outs = [nc * 2 ** min(i, n - 2) for i in range(n)] if n >= 2 else [nc]
        ins = [nc] + outs[:-1]
        for i in range(n):
            layers = conv_bn_relu(ins[i], ins[i], 3, 1)
            if i < n - 1:
                layers += conv_bn_relu(ins[i], outs[i], 3, 2)
            setattr(self, f"conv_layers_{i + 1}", nn.Sequential(*layers))
            setattr(self, f"cross_attn{i + 1}",
                    PoseGuiderTransformer(outs[i], attn_heads, attn_dim_head))

    def forward(self, pose):
        """pose: (b, f, 3, H, W) in [-1, 1].  Returns 1 + num_stages features
        (b, f, c_k, H / 2^k, W / 2^k), k = 3, 4, ..."""
        b, f = pose.shape[:2]
        x = self.conv_layers(pose.reshape(b * f, *pose.shape[2:]))
        x = self.final_proj(x) * self.scale.to(x.dtype)
        fea = [x]
        for i in range(self.num_stages):
            x = getattr(self, f"conv_layers_{i + 1}")(x)
            x = getattr(self, f"cross_attn{i + 1}")(x)
            fea.append(x)
        return [t.reshape(b, f, *t.shape[1:]) for t in fea]
