"""Audio2Pose: the autoregressive head-pose generator (port of
``aniportrait_tpu/audio/audio2pose.py``).

The reference's ``src/audio_models/pose_model.py``: wav2vec2 memory ->
``in_fn`` -> an 8-layer, 8-head post-norm ``nn.TransformerDecoder`` (d=512,
ff=1024, relu) decoded one frame at a time with

* an ALiBi-biased causal self-attention: bias[h, i, j] = -slope_h * (i - j)
  for j <= i, slopes 0.5**(h+1) for 8 heads (``init_biased_mask``,
  pose_model.py:11-32, period 1);
* a diagonal encoder-decoder memory mask (``enc_dec_mask``,
  pose_model.py:35-39): frame i attends only to audio frame i, so the cross
  attention is ``out_proj(v_proj(memory_i))`` (a softmax over one key is 1;
  the q and k projections cancel);
* a 100-way speaker embedding (``id_embed``) and the sinusoidal position
  table added to every decoder input, and the previous frame's pose fed back
  through ``pose_map``.

The reference re-runs the whole decoder for every emitted frame; the masks
are strictly causal, so each position's output does not change once
computed, and this decode (as the JAX package's ``nn.scan``) keeps a K/V
cache per layer and computes each frame once.  It is a Python loop over
frames on preallocated caches with no host read inside; the cross
attention of all frames is computed before it in one product per layer.

Module names are the reference checkpoint's (``transformer_decoder.layers.
{i}.self_attn.in_proj_weight``, ``multihead_attn.*``, ``norm1``-``norm3``,
``linear1``/``linear2``), so ``audio2pose.pt`` loads through
``load_state_dict``; ``multihead_attn``'s q and k thirds are kept as
parameters, unused.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from aniportrait_tpu_torch.audio.audio2mesh import encoder_features
from aniportrait_tpu_torch.audio.wav2vec2 import Wav2Vec2Model
from aniportrait_tpu_torch.models.attention import LayerNorm
from aniportrait_tpu_torch.models.embeddings import sinusoidal_positional_encoding


def alibi_slopes(n_head: int) -> np.ndarray:
    """ALiBi slopes (power-of-2 head counts): start * start**i,
    start = 2**(-2**-(log2(n)-3)); for 8 heads 0.5**(i+1)."""
    start = 2.0 ** (-(2.0 ** -(np.log2(n_head) - 3)))
    return np.array([start * (start**i) for i in range(n_head)], dtype=np.float32)


class MultiheadAttention(nn.Module):
    """The parameters of ``nn.MultiheadAttention`` (q, k, v packed in
    ``in_proj_*``), under its names."""

    def __init__(self, d: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d))
        self.out_proj = nn.Linear(d, d)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.in_proj_bias)

    def value_out(self, x):
        """``out_proj(v_proj(x))``: attention over one key."""
        d = x.shape[-1]
        return self.out_proj(F.linear(x, self.in_proj_weight[2 * d:],
                                      self.in_proj_bias[2 * d:]))


class DecoderLayer(nn.Module):
    """``nn.TransformerDecoderLayer`` (post-norm, relu), applied one new
    token at a time."""

    def __init__(self, d: int, heads: int, dim_ff: int):
        super().__init__()
        self.heads = heads
        self.self_attn = MultiheadAttention(d)
        self.multihead_attn = MultiheadAttention(d)
        self.linear1 = nn.Linear(d, dim_ff)
        self.linear2 = nn.Linear(dim_ff, d)
        self.norm1 = LayerNorm(d, eps=1e-5)
        self.norm2 = LayerNorm(d, eps=1e-5)
        self.norm3 = LayerNorm(d, eps=1e-5)

    def step(self, x, cross, k_cache, v_cache, t: int, bias):
        """x (b, d): frame t's input; cross (b, d): its cross attention;
        k_cache/v_cache (b, T, d), written at row t; bias (heads, t + 1)."""
        b, d = x.shape
        h, hd = self.heads, d // self.heads
        q, k, v = F.linear(x, self.self_attn.in_proj_weight,
                           self.self_attn.in_proj_bias).split(d, dim=-1)
        k_cache[:, t] = k
        v_cache[:, t] = v
        keys = k_cache[:, : t + 1].view(b, t + 1, h, hd)
        values = v_cache[:, : t + 1].view(b, t + 1, h, hd)
        logits = torch.einsum("bhd,bjhd->bhj", q.view(b, h, hd), keys) / math.sqrt(hd)
        probs = torch.softmax((logits + bias).float(), dim=-1).to(q.dtype)
        attn = torch.einsum("bhj,bjhd->bhd", probs, values).reshape(b, d)
        x = self.norm1(x + self.self_attn.out_proj(attn))
        x = self.norm2(x + cross)
        return self.norm3(x + self.linear2(F.relu(self.linear1(x))))


class TransformerDecoder(nn.Module):
    def __init__(self, d: int, heads: int, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(
            [DecoderLayer(d, heads, 2 * d) for _ in range(num_layers)]
        )


class Audio2PoseModel(nn.Module):
    def __init__(self, out_dim: int = 6, latent_dim: int = 512, num_layers: int = 8,
                 heads: int = 8, num_ids: int = 100, pe_max_len: int = 600,
                 only_last_features: bool = True, wav2vec2: dict | None = None):
        """``wav2vec2``: the encoder's sizes (``Wav2Vec2Model`` keyword
        arguments; default wav2vec2-base-960h)."""
        super().__init__()
        self.out_dim = out_dim
        self.heads = heads
        self.pe_max_len = pe_max_len
        self.only_last_features = only_last_features
        self.audio_encoder = Wav2Vec2Model(**(wav2vec2 or {}))
        hidden = self.audio_encoder.feature_projection.projection.out_features
        self.in_fn = nn.Linear(hidden, latent_dim)
        self.pose_map = nn.Linear(out_dim, latent_dim)
        self.pose_map_r = nn.Linear(latent_dim, out_dim)
        self.id_embed = nn.Embedding(num_ids, latent_dim)
        self.transformer_decoder = TransformerDecoder(latent_dim, heads, num_layers)

    def forward(self, wav: torch.Tensor, seq_len: int, id_seed: torch.Tensor
                ) -> torch.Tensor:
        """wav: (b, n_samples) normalised audio; id_seed: (b,) speaker ids
        in [0, num_ids).  Returns the (b, seq_len, 6) pose sequence: euler
        xyz degrees and translation."""
        if not 1 <= seq_len <= self.pe_max_len:
            raise ValueError(f"seq_len {seq_len} outside the position table "
                             f"[1, {self.pe_max_len}]")
        h = encoder_features(self.audio_encoder, wav, seq_len, self.only_last_features)
        return self.decode(self.in_fn(h), self.id_embed(id_seed))

    def decode(self, memory: torch.Tensor, id_emb: torch.Tensor) -> torch.Tensor:
        """The autoregressive decode of ``memory`` (b, T, d) for speakers
        ``id_emb`` (b, d)."""
        b, length, d = memory.shape
        layers = self.transformer_decoder.layers
        dev, dtype = memory.device, memory.dtype
        cross = [layer.multihead_attn.value_out(memory) for layer in layers]
        pe = torch.from_numpy(
            sinusoidal_positional_encoding(self.pe_max_len, d)[0, :length]).to(dev, dtype)
        slopes = torch.from_numpy(alibi_slopes(self.heads)).to(dev)
        pos = torch.arange(length, device=dev)
        dist = (pos[:, None] - pos[None, :]).float()  # (T, T): i - j
        bias = -slopes[:, None, None] * dist  # (heads, T, T); row i is read to j = i
        k_cache = memory.new_zeros(len(layers), b, length, d)
        v_cache = memory.new_zeros(len(layers), b, length, d)
        pose = memory.new_zeros(b, self.out_dim)
        out = memory.new_empty(b, length, self.out_dim)
        for t in range(length):
            x = self.pose_map(pose) + pe[t] + id_emb
            for i, layer in enumerate(layers):
                x = layer.step(x, cross[i][:, t], k_cache[i], v_cache[i], t,
                               bias[:, t, : t + 1])
            pose = self.pose_map_r(x)
            out[:, t] = pose
        return out
