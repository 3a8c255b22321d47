"""Audio2Mesh: wav2vec2 features -> per-frame mesh vertex offsets (port of
``aniportrait_tpu/audio/audio2mesh.py``).

The reference's ``src/audio_models/model.py``: wav2vec2-base ->
``in_fn`` Linear(768 -> 512) -> ``out_fn`` Linear(512 -> 1404), 468 vertices
x 3, zero at initialisation.  With ``only_last_features=False`` the
encoder's hidden states of all layers are averaged (model.py:50-51); the
shipped config uses the last (``only_last_fetures: True``,
configs/inference/inference_audio.yaml:5).  The offsets are added to the
reference face's neutral ``lmks3d``.
"""

from __future__ import annotations

import torch
from torch import nn

from aniportrait_tpu_torch.audio.wav2vec2 import Wav2Vec2Model


def encoder_features(encoder: Wav2Vec2Model, wav: torch.Tensor, seq_len: int,
                     only_last_features: bool) -> torch.Tensor:
    """The last hidden state, or the mean of all of them."""
    last, states = encoder(wav, seq_len, output_hidden_states=not only_last_features)
    return last if only_last_features else sum(states) / len(states)


class Audio2MeshModel(nn.Module):
    def __init__(self, out_dim: int = 1404, latent_dim: int = 512,
                 only_last_features: bool = True, wav2vec2: dict | None = None):
        """``wav2vec2``: the encoder's sizes (``Wav2Vec2Model`` keyword
        arguments; default wav2vec2-base-960h)."""
        super().__init__()
        self.only_last_features = only_last_features
        self.audio_encoder = Wav2Vec2Model(**(wav2vec2 or {}))
        hidden = self.audio_encoder.feature_projection.projection.out_features
        self.in_fn = nn.Linear(hidden, latent_dim)
        self.out_fn = nn.Linear(latent_dim, out_dim)
        nn.init.zeros_(self.out_fn.weight)
        nn.init.zeros_(self.out_fn.bias)

    def forward(self, wav: torch.Tensor, seq_len: int) -> torch.Tensor:
        """wav: (b, n_samples) -> (b, seq_len, out_dim) vertex offsets."""
        h = encoder_features(self.audio_encoder, wav, seq_len, self.only_last_features)
        return self.out_fn(self.in_fn(h))
