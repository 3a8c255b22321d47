"""Latent-space frame interpolation, linear or spherical (port of
``aniportrait_tpu/pipelines/interpolation.py``; the reference's
``interpolate_latents``, pipeline_pose2vid_long.py:293-336, and
``linear``/``slerp``, src/pipelines/utils.py:14-29)."""

from __future__ import annotations

import torch


def linear(v0, v1, t):
    return (1.0 - t) * v0 + t * v1


def slerp(v0, v1, t, dot_threshold: float = 0.9995):
    """Spherical interpolation over the whole tensors (the reference takes
    the norm of the whole per-frame latent)."""
    u0, u1 = v0 / v0.norm(), v1 / v1.norm()
    dot = (u0 * u1).sum()
    omega = torch.arccos(dot.clamp(-1.0, 1.0))
    sl = (torch.sin((1.0 - t) * omega) * v0 + torch.sin(t * omega) * v1) / torch.sin(omega)
    return torch.where(dot.abs() > dot_threshold, linear(v0, v1, t), sl)


def interpolate_latents(latents, interpolation_factor: int, method: str = "linear"):
    """latents: (b, f, h, w, 4) -> (b, (f - 1) * k + 1, h, w, 4)."""
    if interpolation_factor < 2:
        return latents
    fn = slerp if method == "slerp" else linear
    rates = [i / interpolation_factor for i in range(1, interpolation_factor)]
    frames = []
    for i in range(latents.shape[1] - 1):
        v0, v1 = latents[:, i], latents[:, i + 1]
        frames.append(v0)
        frames.extend(fn(v0, v1, t) for t in rates)
    frames.append(latents[:, -1])
    return torch.stack(frames, dim=1)
