"""Quality metrics, PSNR / SSIM / LPIPS (port of ``aniportrait_tpu/utils/quality.py``).

PSNR and SSIM are numpy and scipy, copies of the JAX package's (held to
them by ``tests/test_torch_quality.py``).  LPIPS is the AlexNet variant
(Zhang et al. 2018) as an ``nn.Module`` in NCHW; its pretrained feature and
linear-calibration weights are not in the repository, so :class:`LPIPS`
loads the ``.npz`` that :func:`convert_lpips_weights` makes from the
official ``lpips`` checkpoint and torchvision's AlexNet state dict: HWIO
conv kernels and ``lin{i}`` vectors, the JAX package's contract, so one
file serves both packages.

Protocol (``scripts/quality_gate.py``): generate with the same seed, noise
and conditioning on both sides and compare frame by frame.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


# ----------------------------------------------------------------- PSNR/SSIM
def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    """Peak signal-to-noise ratio in dB.  Inputs any shape, same range."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    return g / g.sum()


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    """Mean SSIM over an image (H, W) or (H, W, C); standard 11x11
    gaussian window, K1=0.01, K2=0.03 (Wang et al. 2004)."""
    from scipy.ndimage import convolve1d

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 3:
        return float(
            np.mean([ssim(a[..., c], b[..., c], data_range) for c in range(a.shape[-1])])
        )
    k = _gaussian_kernel()

    def filt(x):
        return convolve1d(convolve1d(x, k, axis=0, mode="reflect"), k, axis=1, mode="reflect")

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a, mu_b = filt(a), filt(b)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sa = filt(a * a) - mu_aa
    sb = filt(b * b) - mu_bb
    sab = filt(a * b) - mu_ab
    num = (2 * mu_ab + c1) * (2 * sab + c2)
    den = (mu_aa + mu_bb + c1) * (sa + sb + c2)
    return float(np.mean(num / den))


# ---------------------------------------------------------------------- LPIPS
# AlexNet feature extractor config: (out_ch, kernel, stride, padding),
# with 3x3/2 max-pool after stages 0 and 1 (torchvision alexnet.features).
_ALEX_CONVS = (
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
)
# input normalisation of the LPIPS ScalingLayer (inputs in [-1, 1])
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def convert_lpips_weights(
    lpips_ckpt_path: str, alexnet_state_path: str, out_path: str
) -> None:
    """Build the LPIPS .npz from the official checkpoints.

    * ``lpips_ckpt_path``: the lpips package's ``weights/v0.1/alex.pth``
      (keys ``lin{i}.model.1.weight`` — 1x1 conv calibration weights).
    * ``alexnet_state_path``: torchvision ``alexnet-owt-*.pth`` state dict
      (keys ``features.{0,3,6,8,10}.{weight,bias}``).
    """
    lin = torch.load(lpips_ckpt_path, map_location="cpu", weights_only=True)
    alex = torch.load(alexnet_state_path, map_location="cpu", weights_only=True)
    out: Dict[str, np.ndarray] = {}
    for i, fidx in enumerate((0, 3, 6, 8, 10)):
        # OIHW -> HWIO, the JAX package's layout
        out[f"conv{i}_w"] = (
            alex[f"features.{fidx}.weight"].numpy().transpose(2, 3, 1, 0)
        )
        out[f"conv{i}_b"] = alex[f"features.{fidx}.bias"].numpy()
        key = f"lin{i}.model.1.weight"
        if key not in lin:  # some releases nest under 'lins.'
            key = f"lins.{i}.model.1.weight"
        out[f"lin{i}"] = lin[key].numpy().reshape(-1)  # (C,)
    np.savez(out_path, **out)


class LPIPS(nn.Module):
    """LPIPS(alex) in NCHW.  ``weights`` is the .npz from
    :func:`convert_lpips_weights` (or the same dict of arrays); the module
    lives on ``device`` in float32.  Calling it on two clips returns the
    per-item distances as numpy."""

    def __init__(self, weights, device="cpu"):
        super().__init__()
        if isinstance(weights, (str, os.PathLike)):
            if not os.path.exists(weights):
                raise FileNotFoundError(
                    f"LPIPS weights not found at {weights!r}. Convert them "
                    "once with aniportrait_tpu_torch.utils.quality."
                    "convert_lpips_weights(lpips_alex.pth, alexnet.pth, out.npz)"
                )
            weights = dict(np.load(weights))
        self.convs = nn.ModuleList()
        cin = 3
        for i, (cout, k, s, p) in enumerate(_ALEX_CONVS):
            conv = nn.Conv2d(cin, cout, k, stride=s, padding=p)
            conv.weight.data = torch.from_numpy(
                np.ascontiguousarray(np.asarray(weights[f"conv{i}_w"], np.float32)
                                     .transpose(3, 2, 0, 1)))
            conv.bias.data = torch.from_numpy(np.asarray(weights[f"conv{i}_b"], np.float32))
            self.convs.append(conv)
            self.register_buffer(f"lin{i}", torch.from_numpy(
                np.asarray(weights[f"lin{i}"], np.float32)).reshape(1, -1, 1, 1))
            cin = cout
        self.register_buffer("shift", torch.from_numpy(_SHIFT).reshape(1, 3, 1, 1))
        self.register_buffer("scale", torch.from_numpy(_SCALE).reshape(1, 3, 1, 1))
        self.to(device).eval().requires_grad_(False)

    def features(self, x: torch.Tensor):
        """x: (B, 3, H, W) in [-1, 1] -> the five ReLU feature maps."""
        x = (x - self.shift) / self.scale
        feats = []
        for i, conv in enumerate(self.convs):
            x = F.relu(conv(x))
            feats.append(x)
            if i < 2:
                x = F.max_pool2d(x, 3, 2)
        return feats

    def distance(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a, b: (B, 3, H, W) float in [-1, 1] -> (B,) distances."""
        total = 0.0
        for i, (xa, xb) in enumerate(zip(self.features(a), self.features(b))):
            na = xa / torch.sqrt(torch.sum(xa**2, dim=1, keepdim=True) + 1e-10)
            nb = xb / torch.sqrt(torch.sum(xb**2, dim=1, keepdim=True) + 1e-10)
            d = (na - nb) ** 2 * getattr(self, f"lin{i}")
            total = total + torch.mean(torch.sum(d, dim=1), dim=(1, 2))
        return total

    @torch.no_grad()
    def forward(self, a, b) -> np.ndarray:
        """a, b: (B, H, W, 3) float in [-1, 1] (or uint8, auto-scaled), numpy
        or tensors.  Returns per-item LPIPS distances (B,)."""
        device = self.shift.device

        def prep(x):
            x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
            if x.dtype == torch.uint8:
                x = x.to(device).float() / 127.5 - 1.0
            if x.ndim == 3:
                x = x[None]
            return x.to(device, torch.float32).permute(0, 3, 1, 2)

        return self.distance(prep(a), prep(b)).cpu().numpy()


# ------------------------------------------------------------------- summary
def compare_videos(
    ours: np.ndarray,
    theirs: np.ndarray,
    lpips_weights: Optional[str] = None,
    device="cpu",
) -> Dict[str, float]:
    """Frame-wise metric summary between two (F, H, W, 3) uint8 clips;
    LPIPS, where its weights are found, runs on ``device``."""
    if ours.shape != theirs.shape:
        raise ValueError(f"clips differ in shape: {ours.shape} vs {theirs.shape}")
    res = {
        "psnr": float(np.mean([psnr(a, b) for a, b in zip(ours, theirs)])),
        "ssim": float(np.mean([ssim(a, b) for a, b in zip(ours, theirs)])),
        "frames": int(ours.shape[0]),
    }
    if lpips_weights and os.path.exists(lpips_weights):
        metric = LPIPS(lpips_weights, device=device)
        res["lpips"] = float(np.mean(metric(ours, theirs)))
    return res
