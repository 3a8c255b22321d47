"""wav2vec2-base encoder with the reference's time resampling (port of
``aniportrait_tpu/audio/wav2vec2.py``).

Module names are those of transformers' ``Wav2Vec2Model`` (base config:
``do_stable_layer_norm=False``, ``conv_bias=False``,
``feat_extract_norm="group"``), so a ``wav2vec2-base-960h`` checkpoint loads
through ``load_state_dict`` once its weight-normed positional conv is merged
(``weights/convert.py:merge_pos_conv_weight_norm``).  The reference's change
(``src/audio_models/wav2vec2.py:30-32``): the conv features are linearly
interpolated (align corners) along time to exactly ``seq_len`` video frames
before the feature projection, so the ~49.9 Hz wav2vec frames match the
video's fps.

The self-attention goes through the port's
``ops.attention.scaled_dot_product_attention``: at ``seq_len * seq_len >=
FLASH_MIN_LOGITS`` (``seq_len >= 1024``, 34.2 s of audio at 30 fps) it takes
the flash kernel K4, as the JAX package's call does on an accelerator.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from aniportrait_tpu_torch.models.attention import LayerNorm
from aniportrait_tpu_torch.ops.attention import scaled_dot_product_attention

# (out_channels, kernel, stride): the wav2vec2-base feature extractor
CONV_LAYERS: Sequence[Tuple[int, int, int]] = (
    (512, 10, 5),
    (512, 3, 2),
    (512, 3, 2),
    (512, 3, 2),
    (512, 3, 2),
    (512, 2, 2),
    (512, 2, 2),
)


def linear_interpolation(x: torch.Tensor, seq_len: int) -> torch.Tensor:
    """Resample ``(b, t, c)`` along t to ``seq_len`` rows, linear with
    aligned corners (reference ``torch_utils.py:16-19``)."""
    if x.shape[1] == seq_len:
        return x
    out = F.interpolate(x.transpose(1, 2), size=seq_len, mode="linear", align_corners=True)
    return out.transpose(1, 2)


class ConvLayer(nn.Module):
    """One feature-extractor conv (no bias); layer 0 carries the GroupNorm
    with one group per channel (an instance norm over time)."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int, norm: bool):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, kernel, stride=stride, bias=False)
        if norm:
            self.layer_norm = nn.GroupNorm(c_out, c_out, affine=True)

    def forward(self, x):
        x = self.conv(x)
        if hasattr(self, "layer_norm"):  # float32 statistics, population variance
            ln = self.layer_norm
            x = F.group_norm(x.float(), ln.num_groups, ln.weight.float(), ln.bias.float(),
                             1e-5).to(x.dtype)
        return F.gelu(x)


class FeatureEncoder(nn.Module):
    def __init__(self, conv_layers: Sequence[Tuple[int, int, int]] = CONV_LAYERS):
        super().__init__()
        c_in, layers = 1, []
        for i, (c, k, s) in enumerate(conv_layers):
            layers.append(ConvLayer(c_in, c, k, s, norm=i == 0))
            c_in = c
        self.conv_layers = nn.ModuleList(layers)

    def forward(self, wav):
        """wav: (b, n_samples) -> (b, t, c)."""
        x = wav[:, None, :]
        for layer in self.conv_layers:
            x = layer(x)
        return x.transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, c_in: int, hidden: int):
        super().__init__()
        self.layer_norm = LayerNorm(c_in, eps=1e-5)
        self.projection = nn.Linear(c_in, hidden)

    def forward(self, x):
        return self.projection(self.layer_norm(x))


class PositionalConvEmbedding(nn.Module):
    """Grouped conv over time, kernel 128, padding 64; an even kernel gives
    one frame too many, which is trimmed; then the gelu."""

    def __init__(self, hidden: int, kernel: int, groups: int):
        super().__init__()
        self.conv = nn.Conv1d(hidden, hidden, kernel, padding=kernel // 2, groups=groups)

    def forward(self, x):
        pos = self.conv(x.transpose(1, 2))[:, :, : x.shape[1]]
        return F.gelu(pos).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(hidden, hidden)
        self.k_proj = nn.Linear(hidden, hidden)
        self.v_proj = nn.Linear(hidden, hidden)
        self.out_proj = nn.Linear(hidden, hidden)

    def forward(self, x):
        b, s, c = x.shape
        q, k, v = (p(x).reshape(b, s, self.heads, c // self.heads)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        return self.out_proj(scaled_dot_product_attention(q, k, v).reshape(b, s, c))


class FeedForward(nn.Module):
    def __init__(self, hidden: int, intermediate: int):
        super().__init__()
        self.intermediate_dense = nn.Linear(hidden, intermediate)
        self.output_dense = nn.Linear(intermediate, hidden)

    def forward(self, x):
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class EncoderLayer(nn.Module):
    """Post-norm transformer layer."""

    def __init__(self, hidden: int, heads: int, intermediate: int):
        super().__init__()
        self.attention = Attention(hidden, heads)
        self.layer_norm = LayerNorm(hidden, eps=1e-5)
        self.feed_forward = FeedForward(hidden, intermediate)
        self.final_layer_norm = LayerNorm(hidden, eps=1e-5)

    def forward(self, x):
        x = self.layer_norm(x + self.attention(x))
        return self.final_layer_norm(x + self.feed_forward(x))


class Encoder(nn.Module):
    def __init__(self, hidden: int, layers: int, heads: int, intermediate: int,
                 pos_conv_kernel: int, pos_conv_groups: int):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(hidden, pos_conv_kernel,
                                                      pos_conv_groups)
        self.layer_norm = LayerNorm(hidden, eps=1e-5)
        self.layers = nn.ModuleList(
            [EncoderLayer(hidden, heads, intermediate) for _ in range(layers)]
        )


class Wav2Vec2Model(nn.Module):
    def __init__(self, hidden: int = 768, layers: int = 12, heads: int = 12,
                 intermediate: int = 3072, pos_conv_kernel: int = 128,
                 pos_conv_groups: int = 16,
                 conv_layers: Optional[Sequence[Tuple[int, int, int]]] = None):
        super().__init__()
        conv_layers = conv_layers or CONV_LAYERS
        self.feature_extractor = FeatureEncoder(conv_layers)
        self.feature_projection = FeatureProjection(conv_layers[-1][0], hidden)
        self.encoder = Encoder(hidden, layers, heads, intermediate, pos_conv_kernel,
                               pos_conv_groups)

    def forward(self, wav: torch.Tensor, seq_len: int, output_hidden_states: bool = False
                ) -> Tuple[torch.Tensor, Optional[List[torch.Tensor]]]:
        """wav: (b, n_samples) normalised audio.  Returns the last hidden
        state (b, seq_len, hidden) and, with ``output_hidden_states``, the
        input of every layer and the last output (layers + 1 states)."""
        feats = linear_interpolation(self.feature_extractor(wav), seq_len)
        h = self.feature_projection(feats)
        enc = self.encoder
        h = enc.layer_norm(h + enc.pos_conv_embed(h))
        states = [h] if output_hidden_states else None
        for layer in enc.layers:
            h = layer(h)
            if states is not None:
                states.append(h)
        return h, states
