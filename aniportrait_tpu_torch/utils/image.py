"""Host-side image preprocessing (the port's own copy of
``aniportrait_tpu/utils/image.py``, which imports JAX through its CLIP
module).  Resizing is bicubic in PyTorch (no OpenCV needed)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def resize(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 (H, W, 3) -> uint8 (height, width, 3), bicubic (a = -0.75,
    half-pixel centres, no antialiasing: OpenCV's INTER_CUBIC kernel)."""
    if img.shape[1] == width and img.shape[0] == height:
        return img
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=(height, width), mode="bicubic", align_corners=False)
    return y[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()
