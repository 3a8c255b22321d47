"""FiLM frame-interpolation network in NCHW (port of ``aniportrait_tpu/models/film_net.py``).

The reference loads the TorchScript ``film_net_fp16.pt`` (the dajes/
frame-interpolation-pytorch port of Google's FiLM, "Frame Interpolation for
Large Motion", Reda et al., ECCV 2022) at ``src/utils/frame_interpolation.py:
11-19``.  The module names here are that blob's, so
``torch.jit.load(pt).state_dict()`` loads with
``load_state_dict(strict=True)``; ``weights/convert.py:film_rules`` maps them
to the JAX package's flax paths.  The default config is the published
film_net one: pyramid_levels=7, fusion_pyramid_levels=5,
specialized_levels=3, sub_levels=4, filters=64, flow_convs=(3, 3, 3, 3),
flow_filters=(32, 64, 128, 256).

Structure:
  * cascaded feature pyramid: one shared sub-tree extractor runs on every
    image-pyramid level; the level-k feature map concatenates the
    same-resolution sub-features extracted from pyramid images k, k-1, ...,
    k-3.
  * coarse-to-fine residual flow: specialized flow CNNs at the 3 finest
    levels, one shared CNN for all coarser levels.
  * fusion: U-Net style decoder over the 5-level aligned pyramid (warped
    images + warped features + both flows), nearest-neighbour upsampling
    with a 2x2 "SAME" conv (padded right and bottom only), 3 output
    channels.

Hidden convs use leaky_relu(0.2); flow and fusion output convs are linear
and run in float32 whatever ``dtype`` the rest computes in, as in the JAX
package.  :func:`warp` builds its sample coordinates in float32 and
interpolates in float32 from the image's values, whatever the image's dtype
(a grid in bf16 would put the samples 2-4 px off at 512 px).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _leaky(x):
    return F.leaky_relu(x, negative_slope=0.2)


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` applied in its weights' dtype."""
    return conv(x.to(conv.weight.dtype))


def build_image_pyramid(image: torch.Tensor, levels: int) -> List[torch.Tensor]:
    pyr = []
    for i in range(levels):
        pyr.append(image)
        if i < levels - 1:
            image = F.avg_pool2d(image, 2, stride=2)
    return pyr


def warp(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp ``image`` by ``flow``: out(y, x) = image(y + fy, x + fx).

    image: (B, C, H, W); flow: (B, 2, H, W) with channels (dy, dx) in
    pixels.  Bilinear, with the coordinates clamped to [0, H-1] x [0, W-1]
    before the floor (border clamp).  Coordinates and weights are float32;
    the four neighbours are gathered in the image's dtype, interpolated in
    float32 and the result cast back, as the JAX package's gather and lerp."""
    b, c, h, w = image.shape
    dev = image.device
    gy = torch.arange(h, device=dev, dtype=torch.float32).view(1, h, 1)
    gx = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, w)
    y = torch.clamp(gy + flow[:, 0].float(), 0.0, h - 1.0)
    x = torch.clamp(gx + flow[:, 1].float(), 0.0, w - 1.0)
    y0, x0 = torch.floor(y), torch.floor(x)
    wy = (y - y0).reshape(-1, 1)
    wx = (x - x0).reshape(-1, 1)
    y0, x0 = y0.long(), x0.long()
    y1, x1 = torch.clamp(y0 + 1, max=h - 1), torch.clamp(x0 + 1, max=w - 1)
    flat = image.permute(0, 2, 3, 1).reshape(b * h * w, c)
    base = (torch.arange(b, device=dev) * (h * w)).view(b, 1, 1)

    def at(yy, xx):
        return flat[(base + yy * w + xx).reshape(-1)]

    top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
    out = top * (1 - wy) + bot * wy
    return out.to(image.dtype).reshape(b, h, w, c).permute(0, 3, 1, 2)


def _upsample_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` upsampling (half-pixel centres)."""
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False)


def flow_pyramid_synthesis(residual_pyramid: List[torch.Tensor]) -> List[torch.Tensor]:
    """Coarsest residual is the flow; finer flows = residual + 2x upsampled."""
    flow = residual_pyramid[-1]
    out = [flow]
    for residual in residual_pyramid[-2::-1]:
        flow = residual + 2.0 * _upsample_bilinear(flow, residual.shape[2:])
        out.insert(0, flow)
    return out


class SubTreeExtractor(nn.Module):
    """Shared conv cascade: sub-level i = two 3x3 convs at filters << i, with
    2x average pooling between sub-levels."""

    def __init__(self, in_channels: int = 3, filters: int = 64, sub_levels: int = 4):
        super().__init__()
        convs = []
        for i in range(sub_levels):
            convs.append(nn.ModuleList([
                nn.Conv2d(in_channels, filters << i, 3, padding=1),
                nn.Conv2d(filters << i, filters << i, 3, padding=1),
            ]))
            in_channels = filters << i
        self.convs = nn.ModuleList(convs)

    def forward(self, image: torch.Tensor, n: int) -> List[torch.Tensor]:
        head = image
        pyramid = []
        for i, (c0, c1) in enumerate(self.convs):
            if i >= n:
                break
            head = _leaky(_conv(c1, _leaky(_conv(c0, head))))
            pyramid.append(head)
            if i < n - 1:
                head = F.avg_pool2d(head, 2, stride=2)
        return pyramid


class FeatureExtractor(nn.Module):
    def __init__(self, in_channels: int = 3, filters: int = 64, sub_levels: int = 4):
        super().__init__()
        self.extract_sublevels = SubTreeExtractor(in_channels, filters, sub_levels)
        self.sub_levels = sub_levels

    def forward(self, image_pyramid: List[torch.Tensor]) -> List[torch.Tensor]:
        levels = len(image_pyramid)
        sub_pyramids = [
            self.extract_sublevels(image_pyramid[i], min(levels - i, self.sub_levels))
            for i in range(levels)
        ]
        feature_pyramid = []
        for i in range(levels):
            features = [sub_pyramids[i][0]]
            features += [sub_pyramids[i - j][j] for j in range(1, min(i + 1, self.sub_levels))]
            feature_pyramid.append(torch.cat(features, dim=1))
        return feature_pyramid


class FlowEstimator(nn.Module):
    def __init__(self, in_channels: int, num_convs: int, num_filters: int):
        super().__init__()
        convs = []
        for _ in range(num_convs):
            convs.append(nn.Conv2d(in_channels, num_filters, 3, padding=1))
            in_channels = num_filters
        self.convs = nn.ModuleList(convs)
        self.conv_bottleneck = nn.Conv2d(in_channels, num_filters // 2, 1)
        self.conv_out = nn.Conv2d(num_filters // 2, 2, 1)  # float32: see FilmInterpolator

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        x = torch.cat([a, b], dim=1)
        for conv in self.convs:
            x = _leaky(_conv(conv, x))
        x = _leaky(_conv(self.conv_bottleneck, x))
        return _conv(self.conv_out, x)


class PyramidFlowEstimator(nn.Module):
    def __init__(self, feature_channels: Sequence[int], flow_convs=(3, 3, 3, 3),
                 flow_filters=(32, 64, 128, 256)):
        super().__init__()
        specialized = len(flow_convs) - 1
        self.predictors = nn.ModuleList([
            FlowEstimator(2 * feature_channels[i], flow_convs[i], flow_filters[i])
            for i in range(specialized)
        ])
        self.shared_predictor = FlowEstimator(
            2 * feature_channels[specialized], flow_convs[-1], flow_filters[-1])
        self.specialized = specialized

    def _predictor(self, i: int) -> FlowEstimator:
        return self.predictors[i] if i < self.specialized else self.shared_predictor

    def forward(self, pyramid_a: List[torch.Tensor], pyramid_b: List[torch.Tensor]):
        levels = len(pyramid_a)
        v = self._predictor(levels - 1)(pyramid_a[-1], pyramid_b[-1])
        residuals = [v]
        for i in reversed(range(levels - 1)):
            v = 2.0 * _upsample_bilinear(v, pyramid_a[i].shape[2:])
            warped = warp(pyramid_b[i], v)
            v_residual = self._predictor(i)(pyramid_a[i], warped)
            residuals.insert(0, v_residual)
            v = v_residual + v
        return residuals


class Fusion(nn.Module):
    """U-Net decoder over the aligned pyramid -> RGB."""

    def __init__(self, pyramid_channels: Sequence[int], fusion_pyramid_levels: int = 5,
                 specialized_levels: int = 3, filters: int = 64):
        super().__init__()
        self.levels = fusion_pyramid_levels
        up_convs, convs = [], []
        prev = pyramid_channels[-1]
        for i in reversed(range(fusion_pyramid_levels - 1)):  # coarse to fine
            m = (filters << i if i < specialized_levels
                 else filters << specialized_levels)
            up_convs.insert(0, nn.Conv2d(prev, m, 2))
            convs.insert(0, nn.ModuleList([
                nn.Conv2d(pyramid_channels[i] + m, m, 3, padding=1),
                nn.Conv2d(m, m, 3, padding=1),
            ]))
            prev = m
        self.up_convs = nn.ModuleList(up_convs)
        self.convs = nn.ModuleList(convs)
        self.output_conv = nn.Conv2d(prev, 3, 1)  # float32: see FilmInterpolator

    def forward(self, pyramid: List[torch.Tensor]) -> torch.Tensor:
        net = pyramid[-1]
        for i in reversed(range(self.levels - 1)):
            net = F.interpolate(net, size=pyramid[i].shape[2:], mode="nearest")
            net = F.pad(net, (0, 1, 0, 1))  # TF "SAME" for an even kernel
            net = _conv(self.up_convs[i], net)
            net = torch.cat([pyramid[i], net.to(pyramid[i].dtype)], dim=1)
            net = _leaky(_conv(self.convs[i][0], net))
            net = _leaky(_conv(self.convs[i][1], net))
        return _conv(self.output_conv, net)


def feature_channels(filters: int, sub_levels: int, levels: int) -> List[int]:
    """Channels of each level of the cascaded feature pyramid."""
    return [sum(filters << j for j in range(min(i + 1, sub_levels))) for i in range(levels)]


class FilmInterpolator(nn.Module):
    """model(x0, x1, dt) -> the frame at time dt in (0, 1) between x0 and x1.

    x0, x1: (B, 3, H, W) in [0, 1]; H and W must be divisible by
    2 ** (pyramid_levels - 1) = 64.  ``dtype``: the compute dtype of every
    conv but the flows' and the output's (float32), and of the pyramids;
    the weights are held in it.
    """

    def __init__(self, pyramid_levels: int = 7, fusion_pyramid_levels: int = 5,
                 specialized_levels: int = 3, sub_levels: int = 4, filters: int = 64,
                 flow_convs: Sequence[int] = (3, 3, 3, 3),
                 flow_filters: Sequence[int] = (32, 64, 128, 256),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pyramid_levels = pyramid_levels
        self.fusion_pyramid_levels = fusion_pyramid_levels
        self.dtype = dtype
        feat_ch = feature_channels(filters, sub_levels, pyramid_levels)
        self.extract = FeatureExtractor(3, filters, sub_levels)
        self.predict_flow = PyramidFlowEstimator(feat_ch, tuple(flow_convs),
                                                 tuple(flow_filters))
        fusion_in = [2 * (3 + feat_ch[i]) + 4 for i in range(fusion_pyramid_levels)]
        self.fuse = Fusion(fusion_in, fusion_pyramid_levels, specialized_levels, filters)
        self.set_dtype(dtype)

    def set_dtype(self, dtype: torch.dtype) -> "FilmInterpolator":
        """Hold the weights in ``dtype``, the flow and output convs in float32."""
        self.dtype = dtype
        self.to(dtype)
        float32 = [self.fuse.output_conv, self.predict_flow.shared_predictor.conv_out,
                   *(p.conv_out for p in self.predict_flow.predictors)]
        for conv in float32:
            conv.float()
        return self

    def forward(self, x0: torch.Tensor, x1: torch.Tensor, dt) -> torch.Tensor:
        h, w = x0.shape[2:]
        step = 2 ** (self.pyramid_levels - 1)
        if h % step or w % step:
            raise ValueError(f"FiLM needs H and W divisible by {step}, got {h}x{w}")
        fuse_n = self.fusion_pyramid_levels
        dt = dt if torch.is_tensor(dt) else torch.tensor(dt)
        dt = dt.to(x0.device, torch.float32).reshape(-1, 1, 1, 1)

        pyr0 = build_image_pyramid(x0.to(self.dtype), self.pyramid_levels)
        pyr1 = build_image_pyramid(x1.to(self.dtype), self.pyramid_levels)
        feat0 = self.extract(pyr0)
        feat1 = self.extract(pyr1)
        fwd_residual = self.predict_flow(feat0, feat1)
        bwd_residual = self.predict_flow(feat1, feat0)
        fwd_flow = flow_pyramid_synthesis(fwd_residual)[:fuse_n]
        bwd_flow = flow_pyramid_synthesis(bwd_residual)[:fuse_n]

        # time-scaled flows: the backward flow (0 -> 1 motion) scaled by t
        # moves image 0 to time t; the forward flow scaled by 1 - t moves
        # image 1 back
        bwd_flow = [f * dt for f in bwd_flow]
        fwd_flow = [f * (1.0 - dt) for f in fwd_flow]
        aligned = []
        for i in range(fuse_n):
            warped0 = warp(torch.cat([pyr0[i], feat0[i]], dim=1), bwd_flow[i])
            warped1 = warp(torch.cat([pyr1[i], feat1[i]], dim=1), fwd_flow[i])
            aligned.append(torch.cat([warped0, warped1, bwd_flow[i].to(self.dtype),
                                      fwd_flow[i].to(self.dtype)], dim=1))
        return self.fuse(aligned)
