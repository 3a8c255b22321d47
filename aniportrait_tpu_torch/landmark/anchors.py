"""SSD anchor generation for BlazeFace short-range.

The port's copy of ``aniportrait_tpu/landmark/anchors.py`` (held to it by
``tests/test_torch_copies.py``).

Reimplements MediaPipe's SsdAnchorsCalculator for the face-detection
short-range config (the C++ graph behind the reference's vendored
FaceLandmarker, SURVEY §2.1): input 128x128, strides [8, 16, 16, 16],
min/max scale 0.1484375/0.75, aspect ratio 1.0, fixed anchor size,
interpolated scale aspect ratio 1.0 -> 896 anchors (16x16x2 + 8x8x6).
"""

from __future__ import annotations

import numpy as np


def blazeface_short_range_anchors() -> np.ndarray:
    """Returns (896, 4) array of [x_center, y_center, w, h] normalised."""
    strides = [8, 16, 16, 16]
    min_scale, max_scale = 0.1484375, 0.75
    input_size = 128
    anchor_offset = 0.5
    aspect_ratios = [1.0]
    interpolated_scale_aspect_ratio = 1.0

    num_layers = len(strides)

    def calc_scale(idx):
        if num_layers == 1:
            return (min_scale + max_scale) * 0.5
        return min_scale + (max_scale - min_scale) * idx / (num_layers - 1)

    anchors = []
    layer_id = 0
    while layer_id < num_layers:
        anchor_scales, anchor_ars = [], []
        last_same_stride = layer_id
        # merge consecutive layers with the same stride
        while (
            last_same_stride < num_layers
            and strides[last_same_stride] == strides[layer_id]
        ):
            scale = calc_scale(last_same_stride)
            for ar in aspect_ratios:
                anchor_ars.append(ar)
                anchor_scales.append(scale)
            if interpolated_scale_aspect_ratio > 0.0:
                scale_next = (
                    1.0 if last_same_stride == num_layers - 1
                    else calc_scale(last_same_stride + 1)
                )
                anchor_scales.append(np.sqrt(scale * scale_next))
                anchor_ars.append(interpolated_scale_aspect_ratio)
            last_same_stride += 1

        stride = strides[layer_id]
        feat = int(np.ceil(input_size / stride))
        for y in range(feat):
            for x in range(feat):
                for _ in range(len(anchor_ars)):
                    x_center = (x + anchor_offset) / feat
                    y_center = (y + anchor_offset) / feat
                    # fixed_anchor_size: w = h = 1.0
                    anchors.append([x_center, y_center, 1.0, 1.0])
        layer_id = last_same_stride

    return np.asarray(anchors, dtype=np.float32)
