"""SD-1.5-family UNet (port of ``aniportrait_tpu/models/unet.py``).

One class in two roles, as in the JAX package:

* ReferenceNet: ``use_motion_module=False``, ``has_output_head=False``, run
  on one frame with ``capture_banks=True``; returns the dict of per-block
  post-norm1 hidden states ("banks"), keyed by structural position
  (``down_{i}_{j}``, ``mid_0``, ``up_{i}_{j}``).
* denoising UNet: reads the banks, adds the pose features after conv_in and
  after each down block, and runs the motion modules.

With ``gradient_checkpointing`` set, each resnet, spatial transformer and
motion module call that runs with gradients enabled goes through
``torch.utils.checkpoint`` (non-reentrant): its activations are dropped
after the forward and recomputed in the backward, the counterpart of the JAX
package's ``nn.remat`` of the same three blocks
(``aniportrait_tpu/models/unet.py:63-72,130-138``).  A recomputed block runs
its attention kernels a second time.

Module names follow the reference torch checkpoints (``down_blocks.i.
resnets.j``, ``...attentions.j``, ``...motion_modules.j``, ``mid_block``,
``up_blocks``, ``conv_norm_out``, ``conv_out``).  Video tensors are
``(b, f, c, h, w)`` at the boundary and frames-folded inside.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from aniportrait_tpu_torch.models.embeddings import TimestepEmbedding, timestep_embedding
from aniportrait_tpu_torch.models.motion_module import MotionModule
from aniportrait_tpu_torch.models.resnet import (
    Downsample3D,
    GroupNorm,
    ResnetBlock3D,
    Upsample3D,
)
from aniportrait_tpu_torch.models.transformer_spatial import SpatialTransformer


class _Block(nn.Module):
    """Container for one down/mid/up block's modules (names only)."""


class AniUNet(nn.Module):
    def __init__(self, in_channels: int = 4, out_channels: int = 4,
                 block_out_channels: Sequence[int] = (320, 640, 1280, 1280),
                 layers_per_block: int = 2, attention_heads: int = 8,
                 cross_attention_dim: int = 768, use_motion_module: bool = False,
                 motion_module_mid_block: bool = True,
                 motion_module_resolutions: Sequence[int] = (1, 2, 4, 8),
                 motion_heads: int = 8, motion_transformer_blocks: int = 1,
                 motion_pe_max_len: int = 32, use_inflated_groupnorm: bool = True,
                 has_output_head: bool = True):
        super().__init__()
        ch = list(block_out_channels)
        n = len(ch)
        self.layers_per_block = layers_per_block
        self.motion_pe_max_len = motion_pe_max_len
        self.gradient_checkpointing = False
        temb = ch[0] * 4

        def resnet(c_in, c_out):
            return ResnetBlock3D(c_in, c_out, temb, inflated=use_inflated_groupnorm)

        def spatial(c):
            return SpatialTransformer(c, attention_heads, cross_attention_dim)

        def motion(c):
            return MotionModule(c, motion_heads, motion_transformer_blocks,
                                motion_pe_max_len)

        self.conv_in = nn.Conv2d(in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], temb)

        self.down_blocks = nn.ModuleList()
        for i in range(n):
            blk = _Block()
            cin = ch[max(i - 1, 0)]
            blk.resnets = nn.ModuleList([
                resnet(cin if j == 0 else ch[i], ch[i])
                for j in range(layers_per_block)
            ])
            if i < n - 1:
                blk.attentions = nn.ModuleList(
                    [spatial(ch[i]) for _ in range(layers_per_block)])
                blk.downsamplers = nn.ModuleList([Downsample3D(ch[i])])
            if use_motion_module and 2 ** i in motion_module_resolutions:
                blk.motion_modules = nn.ModuleList(
                    [motion(ch[i]) for _ in range(layers_per_block)])
            self.down_blocks.append(blk)

        self.mid_block = _Block()
        self.mid_block.resnets = nn.ModuleList(
            [resnet(ch[-1], ch[-1]) for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList([spatial(ch[-1])])
        if use_motion_module and motion_module_mid_block:
            self.mid_block.motion_modules = nn.ModuleList([motion(ch[-1])])

        rev = ch[::-1]
        self.up_blocks = nn.ModuleList()
        for i in range(n):
            blk = _Block()
            prev_out, out_c = rev[max(i - 1, 0)], rev[i]
            in_c = rev[min(i + 1, n - 1)]
            blk.resnets = nn.ModuleList([
                resnet((prev_out if j == 0 else out_c)
                       + (in_c if j == layers_per_block else out_c), out_c)
                for j in range(layers_per_block + 1)
            ])
            if i > 0:
                blk.attentions = nn.ModuleList(
                    [spatial(out_c) for _ in range(layers_per_block + 1)])
            if use_motion_module and 2 ** (n - 1 - i) in motion_module_resolutions:
                blk.motion_modules = nn.ModuleList(
                    [motion(out_c) for _ in range(layers_per_block + 1)])
            if i < n - 1:
                blk.upsamplers = nn.ModuleList([Upsample3D(out_c)])
            self.up_blocks.append(blk)

        if has_output_head:
            self.conv_norm_out = GroupNorm(32, ch[0], eps=1e-5,
                                           inflated=use_inflated_groupnorm)
            self.conv_out = nn.Conv2d(ch[0], out_channels, 3, padding=1)
        else:
            self.conv_norm_out = self.conv_out = None

    def _run(self, block: nn.Module, *args):
        """``block(*args)``, through ``checkpoint`` when gradient
        checkpointing is on and gradients are being recorded."""
        if self.gradient_checkpointing and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def forward(self, sample, timesteps, encoder_hidden_states,
                pose_cond_fea: Optional[List[torch.Tensor]] = None,
                ref_banks: Optional[Dict[str, torch.Tensor]] = None,
                capture_banks: bool = False, drop_mode: str = "none",
                mode: str = "full", motion_windows=None, drop_ref=None,
                enc_features=None, frame_shard=None):
        """
        sample: (b, f, c_in, h, w) latents; timesteps: (b,);
        encoder_hidden_states: (b, S, ctx_dim); pose_cond_fea: list of
        (b, f, c_k, h_k, w_k); ref_banks: {key: (b, L, c)}; drop_mode:
        'none', 'first_half' or 'traced' (see SpatialTransformerBlock), the
        last with drop_ref (b,) bool, the CFG-dropped batch entries;
        motion_windows: the motion modules' (n_win, win_len) numpy window
        table, or None for whole-clip temporal attention; frame_shard: a
        ``parallel.FrameShard`` when ``sample`` holds one rank's block of
        the clip's frames (the motion modules then attend over the whole
        clip, ``motion_windows`` indexing it).

        mode: 'full'; 'encode' stops after the mid block and returns
        ``enc_features = (mid output, skip stack)`` (frames folded) in place
        of the output; 'decode' runs the up path from ``enc_features`` (the
        encoder cache of ``aniportrait_tpu/models/unet.py:167-227``), and
        ``sample`` only gives the shape.
        Returns (output (b, f, c_out, h, w), or enc_features, or None
        without an output head; banks dict).
        """
        if mode not in ("full", "encode", "decode"):
            raise ValueError(f"mode={mode!r}")
        b, f = sample.shape[:2]
        banks: Dict[str, torch.Tensor] = {}
        dtype = self.conv_in.weight.dtype

        def fold(x):
            return x.reshape(b * f, *x.shape[2:])

        def motion(mm, x):
            return self._run(mm, x, f, motion_windows, frame_shard)

        def spatial(attn, x, key):
            x, captured = self._run(
                attn, x, f, encoder_hidden_states,
                None if ref_banks is None else ref_banks.get(key),
                capture_banks, drop_mode, drop_ref,
            )
            if captured:
                banks[key] = captured[0]
            return x

        emb = self.time_embedding(
            timestep_embedding(timesteps, self.conv_in.out_channels).to(dtype)
        )
        if mode == "decode":
            x, stack = enc_features
            stack = list(stack)
        else:
            x, stack = self._encode(fold(sample).to(dtype), emb, f, fold,
                                    pose_cond_fea, spatial, motion)
        if mode == "encode":
            return (x, tuple(stack)), banks

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
            return None, banks
        x = self.conv_out(F.silu(self.conv_norm_out(x, f)))
        return x.reshape(b, f, *x.shape[1:]), banks

    def _encode(self, x, emb, f, fold, pose_cond_fea, spatial, motion):
        """conv_in, the down blocks and the mid block on frames-folded
        ``x``; returns (mid output, skip stack)."""
        x = self.conv_in(x)
        if pose_cond_fea is not None:
            x = x + fold(pose_cond_fea[0])
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
            if pose_cond_fea is not None:
                x = x + fold(pose_cond_fea[i + 1])

        mid = self.mid_block
        x = self._run(mid.resnets[0], x, emb, f)
        x = spatial(mid.attentions[0], x, "mid_0")
        if hasattr(mid, "motion_modules"):
            x = motion(mid.motion_modules[0], x)
        return self._run(mid.resnets[1], x, emb, f), stack
