"""AnimateDiff-style temporal motion module (port of
``aniportrait_tpu/models/motion_module.py``).

GroupNorm (per frame) -> Linear proj_in -> temporal transformer block
(2 x temporal self attention with a sinusoidal positional encoding, GEGLU
feed-forward) -> Linear proj_out -> residual.  Attention runs along the frame
axis of natural ``(b, f, s, c)`` activations through the temporal kernel.
Parameter names are the reference checkpoint's
(``temporal_transformer.transformer_blocks.0.attention_blocks.N...``).

With a window table (the pipeline's window-fused mode) the transformer
blocks see each window as its own sequence, stacked into the batch, with the
positional encoding indexed by position within the window; frames covered by
several windows average their hidden states before proj_out
(``aniportrait_tpu/models/motion_module.py:106-204``).

Under frame-block sharding (``frame_shard``, the multi-rank sampler) the
per-frame GroupNorm, ``proj_in`` and ``proj_out`` run on the rank's frames;
around the transformer blocks one ``all_to_all`` turns the frame shards into
spatial-position shards and another turns them back, so the temporal kernel
runs on every frame at ``s / ranks`` positions (temporal attention is
independent per position) and the window table applies to whole clips.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from aniportrait_tpu_torch.models.attention import CrossAttention, FeedForward, LayerNorm
from aniportrait_tpu_torch.models.embeddings import sinusoidal_positional_encoding
from aniportrait_tpu_torch.models.resnet import GroupNorm
from aniportrait_tpu_torch.models.transformer_spatial import from_tokens, to_tokens
from aniportrait_tpu_torch.parallel.mesh import (
    FrameShard,
    frames_to_positions,
    positions_to_frames,
)


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
            x = x + attn(norm(x, pe=attn.pos_encoder.pe[0, :f]))
        return x + self.ff(self.ff_norm(x))


def _is_contiguous(windows: np.ndarray) -> bool:
    return bool((windows == windows[:, :1] + np.arange(windows.shape[1])).all())


def split_windows(hid, windows: np.ndarray):
    """(b, f, s, c) -> (b * n_win, win_len, s, c), window rows stacked into
    the batch.  ``windows``: (n_win, win_len) frame indices that cover every
    frame at least once."""
    b, f, s, c = hid.shape
    n_win, win_len = windows.shape
    cover = np.bincount(windows.reshape(-1), minlength=f)
    if (cover == 0).any():
        raise ValueError(
            "motion window table leaves frames uncovered: "
            f"{np.nonzero(cover == 0)[0].tolist()} (of {f} frames; table shape "
            f"{windows.shape})"
        )
    if _is_contiguous(windows):
        hid = torch.stack([hid[:, int(a):int(a) + win_len] for a in windows[:, 0]], dim=1)
    else:
        hid = hid[:, torch.as_tensor(windows, dtype=torch.long, device=hid.device)]
    return hid.reshape(b * n_win, win_len, s, c)


def merge_windows(hid, windows: np.ndarray, frames: int):
    """Inverse of :func:`split_windows`: (b * n_win, win_len, s, c) ->
    (b, f, s, c), each frame the mean over the windows that cover it.

    Contiguous tables reassemble run by run: a run covered by one window is
    a slice, an overlap run the mean of its window slices in the activation
    dtype, as the JAX package computes it.  Other tables scatter-add into a
    float32 buffer and divide by the counts."""
    n_win, win_len = windows.shape
    _, _, s, c = hid.shape
    hid = hid.reshape(-1, n_win, win_len, s, c)
    if not _is_contiguous(windows):
        idx = torch.as_tensor(windows.reshape(-1), dtype=torch.long, device=hid.device)
        acc = torch.zeros((hid.shape[0], frames, s, c), dtype=torch.float32,
                          device=hid.device)
        acc.index_add_(1, idx, hid.float().reshape(hid.shape[0], -1, s, c))
        count = torch.as_tensor(np.bincount(windows.reshape(-1), minlength=frames),
                                dtype=torch.float32, device=hid.device)
        return (acc / count[None, :, None, None]).to(hid.dtype)
    cover = [[] for _ in range(frames)]  # frame -> [(window, position)]
    for wi, start in enumerate(windows[:, 0]):
        for p in range(win_len):
            cover[int(start) + p].append((wi, p))
    key = [tuple((wi, p - fr) for wi, p in cover[fr]) for fr in range(frames)]
    segs, a = [], 0
    for fr in range(1, frames + 1):
        if fr < frames and key[fr] == key[a]:
            continue
        parts = [hid[:, wi, p:p + fr - a] for wi, p in cover[a]]
        acc = parts[0]
        for part in parts[1:]:
            acc = acc + part
        if len(parts) > 1:
            acc = acc * torch.tensor(1.0 / len(parts), dtype=hid.dtype)
        segs.append(acc)
        a = fr
    return torch.cat(segs, dim=1)


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

    def forward(self, x, video_length: int, windows=None,
                frame_shard: FrameShard | None = None):
        """x: (b * f, c, h, w) -> same shape, f = ``video_length`` frames.
        windows: optional (n_win, win_len) numpy frame-index table over the
        whole clip (see the module doc).  frame_shard: the clip's frames
        split over ranks, of which ``x`` holds this rank's block."""
        bf, c, h, w = x.shape
        hid = self.proj_in(to_tokens(self.norm(x)))
        hid = hid.reshape(bf // video_length, video_length, h * w, c)
        frames = video_length
        if frame_shard is not None:
            hid = frames_to_positions(hid, frame_shard)
            frames = frame_shard.frames
        if windows is not None:
            hid = split_windows(hid, windows)
        if hid.shape[2]:  # a rank may hold no positions of a small level
            for block in self.transformer_blocks:
                hid = block(hid)
        if windows is not None:
            hid = merge_windows(hid, windows, frames)
        if frame_shard is not None:
            hid = positions_to_frames(hid, frame_shard, h * w)
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

    def forward(self, x, video_length: int, windows=None, frame_shard=None):
        return self.temporal_transformer(x, video_length, windows, frame_shard)
