"""OpenCV's ``cv2.resize(img, (W, H), interpolation=cv2.INTER_CUBIC)`` on
uint8 in numpy, to the same bytes (a frozen copy of the port's
``utils/image.py:resize``, which recomputes OpenCV's portable code): the
reference resizes the reference image to CLIP's input size as the pipeline
does."""

from __future__ import annotations

import numpy as np

COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS
COEF_SCALE = 1 << COEF_BITS


def _cubic_taps(dst: int, src: int):
    """OpenCV's tap table along one axis: source indices (dst, 4), clamped
    at the borders, and the fixed-point coefficients (dst, 4), the float32
    cubic weights (a = -0.75) at half-pixel centres times 2048, rounded
    half to even."""
    scale = 1.0 / (float(dst) / float(src))
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    start = np.floor(f)
    x = f - start  # float32, as every step below
    a = np.float32(-0.75)
    one = np.float32(1.0)
    c0 = ((a * (x + one) - 5 * a) * (x + one) + 8 * a) * (x + one) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + one
    c2 = ((a + 2) * (one - x) - (a + 3)) * (one - x) * (one - x) + one
    c3 = one - c0 - c1 - c2
    coef = np.rint(np.stack([c0, c1, c2, c3], axis=-1) * np.float32(COEF_SCALE))
    idx = start.astype(np.int64)[:, None] - 1 + np.arange(4)
    return np.clip(idx, 0, src - 1), coef.astype(np.int64)


VECTOR_LANES = 8  # int16 lanes of a 128-bit register: OpenCV's SSE vector step


def resize(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 (H, W, C) -> uint8 (height, width, C), the bytes of OpenCV's
    INTER_CUBIC: a horizontal pass in integers with 11-bit coefficients,
    then a vertical pass over each output row.  OpenCV's vector code takes
    the row in steps of 8 values and computes ``s0*b0 + (s1*b1 + (s2*b2 +
    s3*b3))`` in float32 (each product and sum rounded, no fused
    multiply-add) with round half to even; the row's last ``len % 8``
    values take the integer path, ``(sum + 2^21) >> 22``."""
    if img.shape[1] == width and img.shape[0] == height:
        return img
    src = np.ascontiguousarray(img)
    ix, cx = _cubic_taps(width, src.shape[1])
    iy, cy = _cubic_taps(height, src.shape[0])
    cx, cy = cx.astype(np.int32), cy.astype(np.int32)
    rows = sum(src[:, ix[:, k]].astype(np.int32) * cx[None, :, k, None] for k in range(4))
    rows = rows.reshape(src.shape[0], -1)  # (H, width * C), exact ints
    n_vec = rows.shape[-1] - rows.shape[-1] % VECTOR_LANES
    vec = rows[:, :n_vec].astype(np.float32)
    beta = cy.astype(np.float32) * np.float32(2.0 ** (-2 * COEF_BITS))
    acc = vec[iy[:, 3]] * beta[:, 3, None]
    for k in (2, 1, 0):
        acc = vec[iy[:, k]] * beta[:, k, None] + acc
    tail = sum(rows[iy[:, k], n_vec:].astype(np.int64) * cy[:, k, None] for k in range(4))
    tail = (tail + (1 << (2 * COEF_BITS - 1))) >> (2 * COEF_BITS)
    out = np.concatenate([np.rint(acc), tail.astype(np.float32)], axis=-1)
    return np.clip(out, 0, 255).astype(np.uint8).reshape(height, width, -1)
