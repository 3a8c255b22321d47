"""The AnimateDiff "uniform" context scheduler of the reference pipeline
(``src/pipelines/context.py:7-42``), a frozen copy of the port's
``pipelines/context.py``: overlapping frame-index windows with a per-step
bit-reversal offset and wraparound."""

from __future__ import annotations

import numpy as np


def ordered_halving(val: int) -> float:
    """Bit-reversed fraction in [0, 1): the van-der-Corput base-2 radical
    inverse of ``val`` over 64 bits.  Step s=1 -> 1/2, s=2 -> 1/4, s=3 -> 3/4,
    ... — a low-discrepancy phase used to rotate window boundaries between
    denoise steps (behaviour matches reference context.py:7-12)."""
    rev, v = 0, int(val)
    for _ in range(64):
        rev = (rev << 1) | (v & 1)
        v >>= 1
    return rev / 2.0**64


def uniform(
    step: int = 0,
    num_steps: int | None = None,
    num_frames: int = 0,
    context_size: int | None = None,
    context_stride: int = 3,
    context_overlap: int = 4,
    closed_loop: bool = True,
):
    """Yield overlapping frame-index windows.

    Closed-form construction: per dilation level ``d`` (a power of two), the
    starts form the arithmetic progression ``first + k*hop`` with
    ``hop = context_size*d - context_overlap``, and each window is
    ``start + d*[0..context_size)`` modulo ``num_frames``.  The progression's
    origin is rotated per denoise step by the van-der-Corput phase so window
    seams don't pile up at the same frames across steps.  Output is verified
    bit-identical to the reference scheduler (src/pipelines/context.py:15-42)
    by tests/test_pipeline.py::test_context_windows_golden.
    """
    if num_frames <= context_size:
        yield list(range(num_frames))
        return

    n_levels = min(
        context_stride, int(np.ceil(np.log2(num_frames / context_size))) + 1
    )
    phase = ordered_halving(step)
    pad = int(round(num_frames * phase))
    tail = 0 if closed_loop else -context_overlap

    for dilation in (1 << lvl for lvl in range(n_levels)):
        hop = context_size * dilation - context_overlap
        first = int(phase * dilation) + pad
        starts = np.arange(first, num_frames + pad + tail, hop, dtype=np.int64)
        offsets = np.arange(context_size, dtype=np.int64) * dilation
        windows = (starts[:, None] + offsets[None, :]) % num_frames
        for row in windows:
            yield [int(e) for e in row]


def uniform_context_windows(
    step: int,
    num_frames: int,
    context_size: int = 16,
    context_stride: int = 3,
    context_overlap: int = 4,
    closed_loop: bool = True,
) -> np.ndarray:
    """All windows for one denoise step as an ``(n_windows, context_size)``
    int32 array (static shape — short videos return a single window padded
    by repetition semantics of the reference: if ``num_frames <= context_size``
    the single window is ``range(num_frames)`` and the array is
    ``(1, num_frames)``)."""
    wins = list(
        uniform(
            step=step,
            num_frames=num_frames,
            context_size=context_size,
            context_stride=context_stride,
            context_overlap=context_overlap,
            closed_loop=closed_loop,
        )
    )
    return np.asarray(wins, dtype=np.int32)
