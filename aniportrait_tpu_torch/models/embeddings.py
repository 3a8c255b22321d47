"""Timestep and positional embeddings (port of
``aniportrait_tpu/models/embeddings.py``)."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


def timestep_embedding(timesteps: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers ``get_timestep_embedding``):
    ``cat([sin, cos])``, flipped to ``[cos, sin]``.  (b,) -> (b, dim) f32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device
    ) / (half - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


class TimestepEmbedding(nn.Module):
    """Linear -> SiLU -> Linear (torch names ``linear_1``, ``linear_2``)."""

    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, embed_dim)
        self.linear_2 = nn.Linear(embed_dim, embed_dim)

    def forward(self, x):
        return self.linear_2(nn.functional.silu(self.linear_1(x)))


def sinusoidal_positional_encoding(max_len: int, d_model: int) -> np.ndarray:
    """Interleaved sin/cos table ``(1, max_len, d_model)``: the motion
    module's temporal positional encoding."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float64) * (-math.log(10000.0) / d_model)
    )
    pe = np.zeros((1, max_len, d_model), dtype=np.float32)
    pe[0, :, 0::2] = np.sin(position * div_term)
    pe[0, :, 1::2] = np.cos(position * div_term)
    return pe
