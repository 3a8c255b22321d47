"""BlazeFace detection decode + weighted NMS.

The port's copy of ``aniportrait_tpu/landmark/blazeface.py`` (held to it by
``tests/test_torch_copies.py``).

Reimplements MediaPipe's TensorsToDetectionsCalculator (face short-range
options: 16 coords = box(4) + 6 keypoints x 2, x/y/w/h scale 128,
reverse_output_order, sigmoid scores clipped at +-100, min score 0.5) and
weighted non-max suppression (min_suppression_threshold 0.3).
"""

from __future__ import annotations

from typing import List

import numpy as np


def decode_detections(
    raw_boxes: np.ndarray,
    raw_scores: np.ndarray,
    anchors: np.ndarray,
    scale: float = 128.0,
    score_clip: float = 100.0,
    min_score: float = 0.5,
) -> np.ndarray:
    """raw_boxes (896, 16), raw_scores (896, 1), anchors (896, 4).
    Returns (n, 17): [score, x_min, y_min, x_max, y_max, kp0x, kp0y, ...]."""
    clipped = np.clip(raw_scores[:, 0], -score_clip, score_clip)
    scores = 1.0 / (1.0 + np.exp(-clipped.astype(np.float64)))
    keep = scores >= min_score
    if not keep.any():
        return np.zeros((0, 17), np.float32)

    rb = raw_boxes[keep]
    sc = scores[keep]
    an = anchors[keep]

    x_center = rb[:, 0] / scale * an[:, 2] + an[:, 0]
    y_center = rb[:, 1] / scale * an[:, 3] + an[:, 1]
    w = rb[:, 2] / scale * an[:, 2]
    h = rb[:, 3] / scale * an[:, 3]

    out = np.zeros((len(sc), 17), np.float32)
    out[:, 0] = sc
    out[:, 1] = x_center - w / 2
    out[:, 2] = y_center - h / 2
    out[:, 3] = x_center + w / 2
    out[:, 4] = y_center + h / 2
    for k in range(6):
        out[:, 5 + 2 * k] = rb[:, 4 + 2 * k] / scale * an[:, 2] + an[:, 0]
        out[:, 6 + 2 * k] = rb[:, 5 + 2 * k] / scale * an[:, 3] + an[:, 1]
    return out


def _iou(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    a = (box[2] - box[0]) * (box[3] - box[1])
    b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / np.maximum(a + b - inter, 1e-9)


def weighted_nms(detections: np.ndarray, iou_threshold: float = 0.3) -> np.ndarray:
    """MediaPipe weighted NMS: overlapping detections are averaged,
    weighted by score.  detections (n, 17) sorted output (m, 17)."""
    if len(detections) == 0:
        return detections
    dets = detections[np.argsort(-detections[:, 0])]
    out: List[np.ndarray] = []
    remaining = dets
    while len(remaining) > 0:
        best = remaining[0]
        ious = _iou(best[1:5], remaining[:, 1:5])
        cluster = remaining[ious > iou_threshold]
        remaining = remaining[ious <= iou_threshold]
        w = cluster[:, 0:1]
        merged = best.copy()
        merged[1:] = (cluster[:, 1:] * w).sum(axis=0) / w.sum()
        out.append(merged)
    return np.stack(out)
