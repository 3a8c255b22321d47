"""The five AniPortrait models in plain PyTorch, float32: a frozen copy of
the port's model code (SD-1.5 UNet as ReferenceNet and as the denoising
UNet with AnimateDiff motion modules, PoseGuider, AutoencoderKL, CLIP
ViT-L/14 with projection), with every attention the plain softmax of
``attention.py`` and every matrix product's operands through the model's
:class:`~.precision.Precision`.  Module and parameter names are the
port's (the reference torch checkpoints'), so one state dict fills both.

Left out of the copy, as no cell takes them: the encoder cache split, the
window-fused motion windows, frame sharding over ranks, and a GroupNorm
pooled over frames.  Departures kept from the port, as its equations:
GEGLU's gelu is the tanh form, norms take float32 statistics, PoseGuider's
train-mode BatchNorm is flax's (biased variance, momentum 0.1).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .attention import attention
from .precision import FP32, Precision

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def set_precision(model: nn.Module, prec: Precision) -> nn.Module:
    for mod in model.modules():
        mod.prec = prec
    return model


def _prec(mod) -> Precision:
    return getattr(mod, "prec", FP32)


class Linear(nn.Linear):
    def forward(self, x):
        p = _prec(self)
        return F.linear(p(x), p(self.weight), self.bias)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        p = _prec(self)
        return F.conv2d(p(x), p(self.weight), self.bias, self.stride, self.padding)


def conv1x1_tokens(conv: Conv2d, x):
    """A 1x1 conv applied to (N, S, C_in) tokens."""
    p = _prec(conv)
    return F.linear(p(x), p(conv.weight[:, :, 0, 0]), conv.bias)


def to_tokens(x):
    n, c, h, w = x.shape
    return x.reshape(n, c, h * w).transpose(1, 2)


def from_tokens(x, h: int, w: int):
    n, _, c = x.shape
    return x.transpose(1, 2).reshape(n, c, h, w)


LayerNorm = nn.LayerNorm
GroupNorm = nn.GroupNorm  # per sample of the folded (b * f, c, h, w) input: per frame


# ---------------------------------------------------------------- attention
class CrossAttention(nn.Module):
    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 cross_attention_dim: int | None = None):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(cross_attention_dim or query_dim, inner, bias=False)
        self.to_v = Linear(cross_attention_dim or query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, query_dim)])

    def _heads(self, x):
        return x.reshape(*x.shape[:-1], self.heads, x.shape[-1] // self.heads)

    def forward(self, x, context=None, bank=None, bank_rows=None, rep: int = 1):
        """x (B, Sq, C) tokens, or (b, f, s, c) for attention along f.
        bank: (B // rep, L, C) reference tokens appended to the keys (after
        projection) of the rows whose batch entry ``bank_rows`` flags (a
        list of bools per entry; None: every entry)."""
        context = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(context), self.to_v(context)
        p = _prec(self)
        if x.ndim == 4:  # temporal: (b, f, s, c) -> (b * s, f, h, d)
            b, f, s, c = q.shape
            tok = lambda t: self._heads(t.permute(0, 2, 1, 3).reshape(b * s, f, c))
            out = attention(tok(q), tok(k), tok(v), p)
            out = out.reshape(b, s, f, c).permute(0, 2, 1, 3)
        elif bank is None:
            out = attention(self._heads(q), self._heads(k), self._heads(v), p)
            out = out.reshape(q.shape)
        else:
            kb, vb = self.to_k(bank), self.to_v(bank)
            rows = bank_rows if bank_rows is not None else [True] * kb.shape[0]
            outs = []
            for i, reads in enumerate(rows):
                sl = slice(i * rep, (i + 1) * rep)
                ki, vi = k[sl], v[sl]
                if reads:
                    ki = torch.cat([ki, kb[i:i + 1].expand(rep, -1, -1)], dim=1)
                    vi = torch.cat([vi, vb[i:i + 1].expand(rep, -1, -1)], dim=1)
                o = attention(self._heads(q[sl]), self._heads(ki), self._heads(vi), p)
                outs.append(o.reshape(q[sl].shape))
            out = torch.cat(outs)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim, 2 * dim_out)

    def forward(self, x):
        hidden, gate = self.proj(x).chunk(2, dim=-1)
        return hidden * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  Linear(dim * mult, dim)])

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x


class SpatialTransformerBlock(nn.Module):
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

    def forward(self, x, context=None, bank=None, bank_rows=None, rep: int = 1):
        """Returns (x, the post-norm1 hidden states: the bank this block
        writes when it runs in the ReferenceNet)."""
        h = self.norm1(x)
        x = x + self.attn1(h, bank=bank, bank_rows=bank_rows, rep=rep)
        if self.attn2 is not None:
            x = x + self.attn2(self.norm2(x), context=context)
        return x + self.ff(self.norm3(x)), h


class SpatialTransformer(nn.Module):
    def __init__(self, channels: int, heads: int, cross_attention_dim: int | None = 768):
        super().__init__()
        self.norm = GroupNorm(32, channels, eps=1e-6)
        self.proj_in = Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList([
            SpatialTransformerBlock(channels, heads, channels // heads, cross_attention_dim)])
        self.proj_out = Conv2d(channels, channels, 1)

    def forward(self, x, f: int, context, bank=None, bank_rows=None):
        bf, c, h, w = x.shape
        hid = conv1x1_tokens(self.proj_in, to_tokens(self.norm(x)))
        if context is not None and context.shape[0] != bf:
            context = context.repeat_interleave(f, dim=0)
        hid, captured = self.transformer_blocks[0](hid, context, bank, bank_rows, f)
        hid = conv1x1_tokens(self.proj_out, hid)
        return x + from_tokens(hid, h, w), captured


# ------------------------------------------------------------------ resnet
class Downsample3D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample3D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class ResnetBlock3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: int | None,
                 groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = Linear(temb_channels, out_channels) if temb_channels else None
        self.norm2 = GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x, temb=None, f: int = 1):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            t = self.time_emb_proj(F.silu(temb))
            h = h + t.repeat_interleave(f, dim=0)[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


# -------------------------------------------------------------- embeddings
def timestep_embedding(timesteps, dim: int, max_period: float = 10000.0):
    """diffusers' ``get_timestep_embedding``, flipped to [cos, sin]."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.linear_1 = Linear(in_dim, embed_dim)
        self.linear_2 = Linear(embed_dim, embed_dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


def sinusoidal_positional_encoding(max_len: int, d_model: int) -> np.ndarray:
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                      * (-math.log(10000.0) / d_model))
    pe = np.zeros((1, max_len, d_model), dtype=np.float32)
    pe[0, :, 0::2] = np.sin(position * div_term)
    pe[0, :, 1::2] = np.cos(position * div_term)
    return pe


# ------------------------------------------------------------ motion module
class PositionalEncoding(nn.Module):
    def __init__(self, dim: int, max_len: int = 32):
        super().__init__()
        self.register_buffer("pe", torch.zeros(1, max_len, dim))
        with torch.no_grad():
            self.pe.copy_(torch.from_numpy(sinusoidal_positional_encoding(max_len, dim)))


class TemporalAttention(CrossAttention):
    def __init__(self, dim: int, heads: int, pe_max_len: int = 32):
        super().__init__(dim, heads, dim // heads)
        self.pos_encoder = PositionalEncoding(dim, pe_max_len)


class TemporalTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, pe_max_len: int = 32):
        super().__init__()
        self.attention_blocks = nn.ModuleList(
            [TemporalAttention(dim, heads, pe_max_len) for _ in range(2)])
        self.norms = nn.ModuleList([LayerNorm(dim, eps=1e-5) for _ in range(2)])
        self.ff = FeedForward(dim)
        self.ff_norm = LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        f = x.shape[1]
        for attn, norm in zip(self.attention_blocks, self.norms):
            x = x + attn(norm(x) + attn.pos_encoder.pe[:, :f, None, :])
        return x + self.ff(self.ff_norm(x))


class TemporalTransformer3D(nn.Module):
    def __init__(self, channels: int, heads: int = 8, num_transformer_blocks: int = 1,
                 pe_max_len: int = 32):
        super().__init__()
        self.norm = GroupNorm(32, channels, eps=1e-6)
        self.proj_in = Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList([
            TemporalTransformerBlock(channels, heads, pe_max_len)
            for _ in range(num_transformer_blocks)])
        self.proj_out = Linear(channels, channels)

    def forward(self, x, f: int):
        bf, c, h, w = x.shape
        hid = self.proj_in(to_tokens(self.norm(x))).reshape(bf // f, f, h * w, c)
        for block in self.transformer_blocks:
            hid = block(hid)
        hid = self.proj_out(hid.reshape(bf, h * w, c))
        return x + from_tokens(hid, h, w)


class MotionModule(nn.Module):
    def __init__(self, channels: int, heads: int = 8, num_transformer_blocks: int = 1,
                 pe_max_len: int = 32):
        super().__init__()
        self.temporal_transformer = TemporalTransformer3D(
            channels, heads, num_transformer_blocks, pe_max_len)

    def forward(self, x, f: int):
        return self.temporal_transformer(x, f)


# --------------------------------------------------------------------- UNet
class _Block(nn.Module):
    pass


class UNet(nn.Module):
    """The ReferenceNet (``use_motion_module=False``, no output head; its
    spatial transformers' post-norm1 states are the banks) or the denoising
    UNet (reads the banks, adds the pose features, runs the motion
    modules).  ``checkpointing``: each resnet, spatial transformer and
    motion module recomputed in the backward (memory only)."""

    def __init__(self, block_out_channels: Sequence[int] = (320, 640, 1280, 1280),
                 layers_per_block: int = 2, attention_heads: int = 8,
                 cross_attention_dim: int = 768, use_motion_module: bool = False,
                 motion_module_mid_block: bool = True,
                 motion_module_resolutions: Sequence[int] = (1, 2, 4, 8),
                 motion_heads: int = 8, motion_transformer_blocks: int = 1,
                 motion_pe_max_len: int = 32, has_output_head: bool = True,
                 in_channels: int = 4, out_channels: int = 4):
        super().__init__()
        ch = list(block_out_channels)
        n = len(ch)
        self.layers_per_block = layers_per_block
        self.checkpointing = False
        temb = ch[0] * 4
        resnet = lambda i, o: ResnetBlock3D(i, o, temb)
        spatial = lambda c: SpatialTransformer(c, attention_heads, cross_attention_dim)
        motion = lambda c: MotionModule(c, motion_heads, motion_transformer_blocks,
                                        motion_pe_max_len)
        self.conv_in = Conv2d(in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], temb)
        self.down_blocks = nn.ModuleList()
        for i in range(n):
            blk = _Block()
            cin = ch[max(i - 1, 0)]
            blk.resnets = nn.ModuleList([resnet(cin if j == 0 else ch[i], ch[i])
                                         for j in range(layers_per_block)])
            if i < n - 1:
                blk.attentions = nn.ModuleList([spatial(ch[i]) for _ in range(layers_per_block)])
                blk.downsamplers = nn.ModuleList([Downsample3D(ch[i])])
            if use_motion_module and 2 ** i in motion_module_resolutions:
                blk.motion_modules = nn.ModuleList([motion(ch[i]) for _ in range(layers_per_block)])
            self.down_blocks.append(blk)
        self.mid_block = _Block()
        self.mid_block.resnets = nn.ModuleList([resnet(ch[-1], ch[-1]) for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList([spatial(ch[-1])])
        if use_motion_module and motion_module_mid_block:
            self.mid_block.motion_modules = nn.ModuleList([motion(ch[-1])])
        rev = ch[::-1]
        self.up_blocks = nn.ModuleList()
        for i in range(n):
            blk = _Block()
            prev_out, out_c, in_c = rev[max(i - 1, 0)], rev[i], rev[min(i + 1, n - 1)]
            blk.resnets = nn.ModuleList([
                resnet((prev_out if j == 0 else out_c)
                       + (in_c if j == layers_per_block else out_c), out_c)
                for j in range(layers_per_block + 1)])
            if i > 0:
                blk.attentions = nn.ModuleList([spatial(out_c)
                                                for _ in range(layers_per_block + 1)])
            if use_motion_module and 2 ** (n - 1 - i) in motion_module_resolutions:
                blk.motion_modules = nn.ModuleList([motion(out_c)
                                                    for _ in range(layers_per_block + 1)])
            if i < n - 1:
                blk.upsamplers = nn.ModuleList([Upsample3D(out_c)])
            self.up_blocks.append(blk)
        if has_output_head:
            self.conv_norm_out = GroupNorm(32, ch[0], eps=1e-5)
            self.conv_out = Conv2d(ch[0], out_channels, 3, padding=1)
        else:
            self.conv_norm_out = self.conv_out = None

    def _run(self, block, *args):
        if self.checkpointing and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def forward(self, sample, timesteps, context, pose_fea: Optional[List] = None,
                banks: Optional[Dict[str, torch.Tensor]] = None, bank_rows=None):
        """sample (b, f, 4, h, w); timesteps (b,); context (b, S, C);
        pose_fea: (b, f, c_k, h_k, w_k) per level; banks {key: (b, L, c)}
        read by the batch entries ``bank_rows`` flags.  Returns (output
        (b, f, 4, h, w) or None without a head, the banks this UNet writes)."""
        b, f = sample.shape[:2]
        written: Dict[str, torch.Tensor] = {}
        fold = lambda t: t.reshape(b * f, *t.shape[2:])

        def spatial(attn, x, key):
            bank = None if banks is None else banks[key]
            x, captured = self._run(attn, x, f, context, bank, bank_rows)
            written[key] = captured
            return x

        def motion(mm, x):
            return self._run(mm, x, f)

        emb = self.time_embedding(timestep_embedding(timesteps, self.conv_in.out_channels))
        x = self.conv_in(fold(sample).float())
        if pose_fea is not None:
            x = x + fold(pose_fea[0])
        stack = [x]
        for i, blk in enumerate(self.down_blocks):
            for j in range(self.layers_per_block):
                x = self._run(blk.resnets[j], x, emb, f)
                if hasattr(blk, "attentions"):
                    x = spatial(blk.attentions[j], x, f"down_{i}_{j}")
                if hasattr(blk, "motion_modules"):
                    x = motion(blk.motion_modules[j], x)
                stack.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                stack.append(x)
            if pose_fea is not None:
                x = x + fold(pose_fea[i + 1])
        mid = self.mid_block
        x = self._run(mid.resnets[0], x, emb, f)
        x = spatial(mid.attentions[0], x, "mid_0")
        if hasattr(mid, "motion_modules"):
            x = motion(mid.motion_modules[0], x)
        x = self._run(mid.resnets[1], x, emb, f)
        for i, blk in enumerate(self.up_blocks):
            for j in range(self.layers_per_block + 1):
                x = self._run(blk.resnets[j], torch.cat([x, stack.pop()], dim=1), emb, f)
                if hasattr(blk, "attentions"):
                    x = spatial(blk.attentions[j], x, f"up_{i}_{j}")
                if hasattr(blk, "motion_modules"):
                    x = motion(blk.motion_modules[j], x)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)
        if self.conv_out is None:
            return None, written
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.reshape(b, f, *x.shape[1:]), written


# -------------------------------------------------------------- PoseGuider
class BatchNorm2d(nn.BatchNorm2d):
    """Eval: the running statistics.  Train: flax's batch statistics (the
    biased variance E[x^2] - E[x]^2, clipped at 0), the running ones moved by
    ``momentum``."""

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        mean, sq = x.mean((0, 2, 3)), (x * x).mean((0, 2, 3))
        var = (sq - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            self.running_mean.lerp_(mean.detach(), self.momentum)
            self.running_var.lerp_(var.detach(), self.momentum)
        mul = self.weight * torch.rsqrt(var + self.eps)
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


def conv_bn_relu(c_in, c_out, kernel, stride):
    return [Conv2d(c_in, c_out, kernel, stride=stride, padding=1),
            BatchNorm2d(c_out, eps=1e-5, momentum=0.1), nn.ReLU()]


class PoseGuiderTransformer(nn.Module):
    def __init__(self, channels: int, heads: int = 16, dim_head: int = 88):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm(32, channels, eps=1e-6)
        self.proj_in = Conv2d(channels, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            [SpatialTransformerBlock(inner, heads, dim_head, cross_attention_dim=None)])
        self.proj_out = Conv2d(inner, channels, 1)

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
            *[m for ci, co, k, s in self.STEM for m in conv_bn_relu(ci, co, k, s)])
        self.final_proj = Conv2d(128, nc, 1)
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
        """pose (b, f, 3, H, W) in [-1, 1] -> 1 + num_stages features."""
        b, f = pose.shape[:2]
        x = self.conv_layers(pose.reshape(b * f, *pose.shape[2:]))
        x = self.final_proj(x) * self.scale
        fea = [x]
        for i in range(self.num_stages):
            x = getattr(self, f"cross_attn{i + 1}")(getattr(self, f"conv_layers_{i + 1}")(x))
            fea.append(x)
        return [t.reshape(b, f, *t.shape[1:]) for t in fea]


# ---------------------------------------------------------------------- VAE
def vae_resnet(c_in, c_out):
    return ResnetBlock3D(c_in, c_out, None, groups=32, eps=1e-6)


class VaeAttentionBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = GroupNorm(32, channels, eps=1e-6)
        self.to_q = Linear(channels, channels)
        self.to_k = Linear(channels, channels)
        self.to_v = Linear(channels, channels)
        self.to_out = nn.ModuleList([Linear(channels, channels)])

    def forward(self, x):
        _, _, h, w = x.shape
        hid = to_tokens(self.group_norm(x))
        q, k, v = (p(hid)[:, :, None, :] for p in (self.to_q, self.to_k, self.to_v))
        hid = attention(q, k, v, _prec(self))[:, :, 0, :]
        return x + from_tokens(self.to_out[0](hid), h, w)


class VaeMidBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.resnets = nn.ModuleList([vae_resnet(channels, channels) for _ in range(2)])
        self.attentions = nn.ModuleList([VaeAttentionBlock(channels)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class VaeEncoder(nn.Module):
    def __init__(self, ch: Sequence[int], layers_per_block: int = 2, latent: int = 4):
        super().__init__()
        ch = list(ch)
        self.conv_in = Conv2d(3, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        for i, c in enumerate(ch):
            blk = _Block()
            blk.resnets = nn.ModuleList([vae_resnet(ch[max(i - 1, 0)] if j == 0 else c, c)
                                         for j in range(layers_per_block)])
            if i < len(ch) - 1:
                down = _Block()
                down.conv = Conv2d(c, c, 3, stride=2)
                blk.downsamplers = nn.ModuleList([down])
            self.down_blocks.append(blk)
        self.mid_block = VaeMidBlock(ch[-1])
        self.conv_norm_out = GroupNorm(32, ch[-1], eps=1e-6)
        self.conv_out = Conv2d(ch[-1], 2 * latent, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            for resnet in blk.resnets:
                x = resnet(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0].conv(F.pad(x, (0, 1, 0, 1)))
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VaeDecoder(nn.Module):
    def __init__(self, ch: Sequence[int], layers_per_block: int = 3, latent: int = 4):
        super().__init__()
        rev = list(ch)[::-1]
        self.conv_in = Conv2d(latent, rev[0], 3, padding=1)
        self.mid_block = VaeMidBlock(rev[0])
        self.up_blocks = nn.ModuleList()
        for i, c in enumerate(rev):
            blk = _Block()
            blk.resnets = nn.ModuleList([vae_resnet(rev[max(i - 1, 0)] if j == 0 else c, c)
                                         for j in range(layers_per_block)])
            if i < len(rev) - 1:
                up = _Block()
                up.conv = Conv2d(c, c, 3, padding=1)
                blk.upsamplers = nn.ModuleList([up])
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm(32, rev[-1], eps=1e-6)
        self.conv_out = Conv2d(rev[-1], 3, 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            for resnet in blk.resnets:
                x = resnet(x)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0].conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512)):
        super().__init__()
        self.encoder = VaeEncoder(block_out_channels)
        self.decoder = VaeDecoder(block_out_channels)
        self.quant_conv = Conv2d(8, 8, 1)
        self.post_quant_conv = Conv2d(4, 4, 1)

    def encode(self, x):
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))


# --------------------------------------------------------------------- CLIP
class CLIPAttention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = Linear(hidden, hidden)
        self.k_proj = Linear(hidden, hidden)
        self.v_proj = Linear(hidden, hidden)
        self.out_proj = Linear(hidden, hidden)

    def forward(self, x):
        b, s, c = x.shape
        q, k, v = (p(x).reshape(b, s, self.heads, c // self.heads)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        return self.out_proj(attention(q, k, v, _prec(self)).reshape(b, s, c))


class CLIPMLP(nn.Module):
    def __init__(self, hidden: int, intermediate: int):
        super().__init__()
        self.fc1 = Linear(hidden, intermediate)
        self.fc2 = Linear(intermediate, hidden)

    def forward(self, x):
        x = self.fc1(x)
        return self.fc2(x * torch.sigmoid(1.702 * x))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, intermediate: int):
        super().__init__()
        self.self_attn = CLIPAttention(hidden, heads)
        self.layer_norm1 = LayerNorm(hidden, eps=1e-5)
        self.mlp = CLIPMLP(hidden, intermediate)
        self.layer_norm2 = LayerNorm(hidden, eps=1e-5)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, hidden, layers, heads, intermediate):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(hidden, heads, intermediate)
                                     for _ in range(layers)])


class CLIPEmbeddings(nn.Module):
    def __init__(self, hidden: int, patch: int, image_size: int):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.zeros(hidden))
        self.patch_embedding = Conv2d(3, hidden, patch, stride=patch, bias=False)
        self.position_embedding = nn.Embedding((image_size // patch) ** 2 + 1, hidden)

    def forward(self, pixel_values):
        patches = self.patch_embedding(pixel_values).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(patches.shape[0], 1, -1)
        return torch.cat([cls, patches], dim=1) + self.position_embedding.weight[None]


class CLIPVisionTransformer(nn.Module):
    def __init__(self, hidden, layers, heads, intermediate, patch, image_size):
        super().__init__()
        self.embeddings = CLIPEmbeddings(hidden, patch, image_size)
        self.pre_layrnorm = LayerNorm(hidden, eps=1e-5)
        self.encoder = CLIPEncoder(hidden, layers, heads, intermediate)
        self.post_layernorm = LayerNorm(hidden, eps=1e-5)

    def forward(self, pixel_values):
        x = self.pre_layrnorm(self.embeddings(pixel_values))
        for layer in self.encoder.layers:
            x = layer(x)
        return self.post_layernorm(x[:, 0])


class CLIPVisionModelWithProjection(nn.Module):
    def __init__(self, hidden: int = 1024, layers: int = 24, heads: int = 16,
                 intermediate: int = 4096, patch: int = 14, image_size: int = 224,
                 projection_dim: int = 768):
        super().__init__()
        self.image_size = image_size
        self.vision_model = CLIPVisionTransformer(hidden, layers, heads, intermediate,
                                                  patch, image_size)
        self.visual_projection = Linear(hidden, projection_dim, bias=False)

    def forward(self, pixel_values):
        return self.visual_projection(self.vision_model(pixel_values))


NORMS = (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d)


def make_models(sizes: dict) -> Dict[str, nn.Module]:
    """The five models of a configuration's ``models`` block (float32,
    default init; ``with torch.device('meta')`` builds them without
    memory)."""
    unet = dict(sizes["unet"])
    motion = dict(sizes.get("motion_module", {}))
    return dict(
        vae=AutoencoderKL(**sizes["vae"]),
        clip=CLIPVisionModelWithProjection(**sizes["clip"]),
        reference_unet=UNet(**unet, use_motion_module=False, has_output_head=False),
        denoising_unet=UNet(**unet, use_motion_module=True, **motion),
        pose_guider=PoseGuider(**sizes["pose_guider"]),
    )
