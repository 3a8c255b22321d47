"""Frame interpolation for the ``-acc`` path (port of ``aniportrait_tpu/utils/frame_interpolation.py``).

The reference (``src/utils/frame_interpolation.py:22-69``) loads a
TorchScript FiLM net (``film_net_fp16.pt``) and inserts ``inter_frames``
midpoints between each adjacent frame pair by binary subdivision.  The
interpolators here:

  * ``film``: ``models/film_net.py:FilmInterpolator``, loaded from the
    TorchScript blob (its state dict has the port's module names) or from
    an ``.npz`` of the JAX package's ``/``-joined flax paths, or with
    ``random_init`` for the bench.  It computes in bf16 on the card
    (float32 on the CPU), clips to [0, 1], and takes pairs in batches of
    ``MAX_BATCH``; tensors in give tensors out on its device, numpy in
    gives numpy out.
  * ``linear``: the cross-fade midpoint, the CLIs' loud fallback when no
    FiLM weights are found (a weights fallback, not a device one).

A uint8 clip on the device (the pipeline's ``return_device=True`` output)
stays there through every subdivision round and comes back in one uint8
download (:func:`batch_images_interpolation_tool`).
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Callable

import numpy as np
import torch

DEFAULT_WEIGHTS = "./pretrained_model/film_net_fp16.pt"  # the reference's path
MAX_BATCH = 4  # pairs per FiLM call: pyramid activations at 512 px are GB-scale


def linear_midpoint(frame1: np.ndarray, frame2: np.ndarray) -> np.ndarray:
    """Cross-fade midpoint; explicit fallback when FiLM weights are absent."""
    return 0.5 * frame1 + 0.5 * frame2


@torch.no_grad()
def random_film(seed: int = 0, **config):
    """A ``FilmInterpolator`` (float32, CPU) with seeded random weights:
    He-normal convs (``N(0, 2 / fan_in)``), so that activations keep their
    scale through the network, and ``N(0, 0.01)`` biases."""
    from aniportrait_tpu_torch.models.film_net import FilmInterpolator

    model = FilmInterpolator(**config)
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, torch.nn.Conv2d):
            fan_in = mod.weight[0].numel()
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen)
                             * math.sqrt(2.0 / fan_in))
            mod.bias.copy_(torch.randn(mod.bias.shape, generator=gen) * 0.01)
    return model


def _film_state(model, weights_path: str) -> dict:
    """The state dict of a TorchScript blob, or of an ``.npz`` of flax paths
    (``weights/convert.py:convert_film``'s, ``/``-joined)."""
    if weights_path.endswith(".npz"):
        from aniportrait_tpu_torch.weights.convert import set_in
        from aniportrait_tpu_torch.weights.from_jax import film_from_jax

        flat = np.load(weights_path)
        params: dict = {}
        for k in flat.files:
            set_in(params, k, flat[k])
        return film_from_jax(model, params)
    return torch.jit.load(weights_path, map_location="cpu").state_dict()


def _load_film(weights_path: str | None, random_init: bool = False,
               device="cuda") -> Callable:
    """A FiLM midpoint fn (dt = 0.5) on ``device``: from ``weights_path``
    (TorchScript ``.pt`` or flax ``.npz``), or with ``random_init`` seeded
    random weights (the real architecture's time, for the bench)."""
    from aniportrait_tpu_torch.models.film_net import FilmInterpolator

    device = torch.device(device)
    if weights_path:
        if not os.path.exists(weights_path):
            raise FileNotFoundError(f"FiLM weights not found at {weights_path!r}")
        model = FilmInterpolator()
        model.load_state_dict(_film_state(model, weights_path), strict=True)
    elif random_init:
        model = random_film(0)
    else:
        raise FileNotFoundError(
            "film backend needs a weights path (film_net TorchScript .pt or npz)")
    model.set_dtype(torch.bfloat16 if device.type == "cuda" else torch.float32)
    model.to(device).eval().requires_grad_(False)

    @torch.no_grad()
    def fn(frame1, frame2):
        """(B, H, W, 3) or (H, W, 3) pairs in [0, 1] -> midpoints, float32:
        tensors stay on the device, numpy comes back as numpy."""
        on_device = torch.is_tensor(frame1)
        single = frame1.ndim == 3
        x0 = torch.as_tensor(frame1, device=device)
        x1 = torch.as_tensor(frame2, device=device)
        if single:
            x0, x1 = x0[None], x1[None]
        outs = []
        for i in range(0, x0.shape[0], MAX_BATCH):
            a = x0[i:i + MAX_BATCH].permute(0, 3, 1, 2).float()
            b = x1[i:i + MAX_BATCH].permute(0, 3, 1, 2).float()
            out = model(a, b, torch.full((a.shape[0],), 0.5, device=device))
            outs.append(torch.clamp(out, 0.0, 1.0).permute(0, 2, 3, 1))
        out = torch.cat(outs, dim=0)
        out = out[0] if single else out
        return out if on_device else out.cpu().numpy()

    fn.batched = True  # takes (B, H, W, 3) pairs, in MAX_BATCH chunks
    fn.device_io = True  # tensors in -> tensors out on ``fn.device``
    fn.device = device
    fn.model = model
    return fn


def init_frame_interpolation_model(backend: str = "film", weights_path: str | None = None,
                                   random_init: bool = False, device="cuda") -> Callable:
    """backend: 'film' (needs weights, or ``random_init=True`` for the
    bench) or 'linear' (cross-fade, explicit opt-in)."""
    if backend == "linear":
        return linear_midpoint
    if backend == "film":
        return _load_film(weights_path, random_init=random_init, device=device)
    raise ValueError(f"unknown interpolation backend {backend!r}")


def init_for_cli(weights_path: str | None, device="cuda") -> Callable:
    """The CLIs' ``-acc`` interpolator: FiLM when weights are found (the
    flag, or the reference's default path), otherwise a loud downgrade to
    the cross-fade, never a silent one.  A given path that does not load
    raises."""
    path = weights_path or (DEFAULT_WEIGHTS if os.path.exists(DEFAULT_WEIGHTS) else None)
    if path:
        return _load_film(path, device=device)
    warnings.warn(
        "-acc: no FiLM weights found (pass --fi_weights or place "
        f"{DEFAULT_WEIGHTS}); falling back to linear "
        "cross-fade — interpolated frames will ghost under large motion."
    )
    return linear_midpoint


def batch_images_interpolation_tool(video, model: Callable, inter_frames: int = 1,
                                    return_device: bool = False):
    """video: (b, f, h, w, c) float in [0, 1], or one clip (f, h, w, c).
    Insert ``inter_frames`` frames between each adjacent pair by recursive
    binary subdivision (the reference's midpoint order,
    frame_interpolation.py:22-60).

    With ``model.batched`` each subdivision round runs all pairs of the
    clip in one call.  ``video`` may also be a uint8 tensor on the device
    (the pipeline's ``return_device=True`` output, with or without the clip
    axis): with a device model the rounds then run on the device and the
    result comes back once as uint8 (interpolated frames are quantised to
    uint8, the precision of the video file they go to); ``return_device``
    returns that uint8 tensor (b, f', h, w, c) instead of float32 numpy."""
    device_in = torch.is_tensor(video)
    if video.ndim == 4:  # one clip: the pipeline's output
        video = video[None]
    if device_in and not (getattr(model, "batched", False)
                          and getattr(model, "device_io", False)):
        # a host model (the linear fallback): fetch once, float in [0, 1]
        video = video.cpu().numpy()
        if video.dtype == np.uint8:
            video = video.astype(np.float32) / 255.0
        device_in = False
    b, f = video.shape[:2]
    if getattr(model, "batched", False):
        device_io = getattr(model, "device_io", False)
        if device_io:
            stack = torch.stack
            if device_in:
                video_in = video.to(model.device)
                if video_in.dtype == torch.uint8:
                    video_in = video_in.float() / 255.0
            else:
                video_in = torch.as_tensor(video, device=model.device)  # one upload
        else:
            stack = np.stack
            video_in = video
        out_clips = []
        for bi in range(b):
            # per original pair, its growing sequence of frames
            seqs = [[video_in[bi, i], video_in[bi, i + 1]] for i in range(f - 1)]
            remaining = inter_frames
            while remaining > 0:
                inserts = []  # (pair index, position, left, right)
                for pi, seq in enumerate(seqs):
                    n_ins = 0
                    for j in range(len(seq) - 1):
                        if n_ins < remaining:
                            inserts.append((pi, j, seq[j], seq[j + 1]))
                            n_ins += 1
                if not inserts:
                    break
                mids = model(stack([it[2] for it in inserts]), stack([it[3] for it in inserts]))
                consumed_per_pair: dict = {}
                for (pi, j, _, _), m in zip(inserts, mids):
                    off = consumed_per_pair.get(pi, 0)
                    seqs[pi].insert(j + 1 + off, m)
                    consumed_per_pair[pi] = off + 1
                remaining -= max(consumed_per_pair.values())
            result = [seqs[0][0]]
            for seq in seqs:
                result.extend(seq[1:])
            out_clips.append(stack(result))
        if device_io and device_in:
            u8 = torch.round(torch.clamp(stack(out_clips), 0.0, 1.0) * 255.0).to(torch.uint8)
            if return_device:
                return u8
            return u8.cpu().numpy().astype(np.float32) / 255.0  # one uint8 download
        if device_io:
            return stack(out_clips).cpu().numpy()  # one download
        return stack(out_clips)

    out_clips = []
    for bi in range(b):
        frames = [video[bi, i] for i in range(f)]
        result = [frames[0]]
        for i in range(f - 1):
            segment = _subdivide(frames[i], frames[i + 1], inter_frames, model)
            result.extend(segment[1:])
        out_clips.append(np.stack(result))
    return np.stack(out_clips)


def _subdivide(f1, f2, inter_frames: int, model: Callable):
    """Return [f1, ...inter..., f2] with inter_frames inserted midpoints."""
    seq = [f1, f2]
    remaining = inter_frames
    while remaining > 0:
        new_seq = [seq[0]]
        inserted = 0
        for i in range(len(seq) - 1):
            if inserted < remaining:
                new_seq.append(model(seq[i], seq[i + 1]))
                inserted += 1
            new_seq.append(seq[i + 1])
        seq = new_seq
        remaining -= inserted
    return seq
