"""CLIP vision encoder with projection (port of
``aniportrait_tpu/models/clip_vision.py``; module names of transformers'
``CLIPVisionModelWithProjection``).  ViT-L/14 at full size; its 257-token
attention stays on ``F.scaled_dot_product_attention`` as the JAX package
leaves it to XLA."""

from __future__ import annotations

import torch
from torch import nn

from aniportrait_tpu_torch.models.attention import LayerNorm
from aniportrait_tpu_torch.ops.attention import scaled_dot_product_attention

# OpenAI CLIP preprocessing constants (CLIPImageProcessor defaults)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
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


class CLIPMLP(nn.Module):
    def __init__(self, hidden: int, intermediate: int):
        super().__init__()
        self.fc1 = nn.Linear(hidden, intermediate)
        self.fc2 = nn.Linear(intermediate, hidden)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


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
    def __init__(self, hidden: int, layers: int, heads: int, intermediate: int):
        super().__init__()
        self.layers = nn.ModuleList(
            [CLIPEncoderLayer(hidden, heads, intermediate) for _ in range(layers)]
        )


class CLIPEmbeddings(nn.Module):
    def __init__(self, hidden: int, patch: int, image_size: int):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.zeros(hidden))
        self.patch_embedding = nn.Conv2d(3, hidden, patch, stride=patch, bias=False)
        self.position_embedding = nn.Embedding((image_size // patch) ** 2 + 1, hidden)

    def forward(self, pixel_values):
        patches = self.patch_embedding(pixel_values).flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(patches.dtype).expand(patches.shape[0], 1, -1)
        x = torch.cat([cls, patches], dim=1)
        return x + self.position_embedding.weight.to(x.dtype)[None]


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
        self.visual_projection = nn.Linear(hidden, projection_dim, bias=False)

    def forward(self, pixel_values):
        """pixel_values: (b, 3, s, s), CLIP-normalised -> (b, projection_dim)."""
        return self.visual_projection(self.vision_model(pixel_values))
