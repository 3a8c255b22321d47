"""One pose2vid request in plain PyTorch (the reference's counterpart of the
port's ``Pose2VideoPipeline.__call__``; AniPortrait's
``pipeline_pose2vid_long.py``): CLIP-embed the reference image (CFG pairs
it with a zero embedding), VAE-encode it, capture the ReferenceNet's banks,
run the PoseGuider on the pose maps, then per DDIM step the denoising UNet
on each context window, unconditional and conditional rows (only the
conditional ones read the banks), the predictions summed and counted over
the clip, CFG, the DDIM update; last the VAE decode to uint8 frames.

The initial noise is ``torch.randn`` of shape ``(1, L, h, w, 4)`` from a
``torch.Generator`` on the request's device seeded with the request's seed,
as the pipeline draws it.  Windows run one at a time and frames decode
``decode_chunk`` at a time, so a 48-frame request fits beside nothing
else.
"""

from __future__ import annotations

import numpy as np
import torch

from .context import uniform_context_windows
from .ddim import DDIMScheduler
from .image import resize
from .models import CLIP_MEAN, CLIP_STD

VAE_SCALE = 0.18215


@torch.no_grad()
def generate(models: dict, scheduler: DDIMScheduler, sampler: dict, ref_u8: np.ndarray,
             poses_u8: np.ndarray, seed: int, device, decode_chunk: int = 4) -> np.ndarray:
    """``ref_u8`` (H, W, 3), ``poses_u8`` (L, H, W, 3) uint8 at the request's
    size; ``sampler``: the configuration's ``steps``, ``guidance_scale``,
    ``context_frames``, ``context_stride``, ``context_overlap``.  Returns
    (L, H, W, 3) uint8."""
    vae, clip = models["vae"], models["clip"]
    L, height, width = poses_u8.shape[:3]
    dev = torch.device(device)
    ref = torch.from_numpy(ref_u8).to(dev).permute(2, 0, 1)[None].float() / 127.5 - 1.0
    s = clip.image_size
    clip_in = torch.from_numpy(resize(ref_u8, s, s)).to(dev).permute(2, 0, 1)[None].float()
    mean = torch.tensor(CLIP_MEAN, device=dev)[:, None, None]
    std = torch.tensor(CLIP_STD, device=dev)[:, None, None]
    ctx = clip((clip_in / 255.0 - mean) / std)[:, None, :]
    ctx_cfg = torch.cat([torch.zeros_like(ctx), ctx])
    ref_lat = vae.encode(ref)[0] * VAE_SCALE
    _, banks = models["reference_unet"](torch.cat([ref_lat] * 2)[:, None],
                                        torch.zeros(2, dtype=torch.long, device=dev), ctx_cfg)
    pose = torch.from_numpy(poses_u8).to(dev).permute(0, 3, 1, 2)[None].float() / 127.5 - 1.0
    pose_fea = models["pose_guider"](pose)
    del pose

    h, w = height // 8, width // 8
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    x = torch.randn((1, L, h, w, 4), generator=gen, device=dev, dtype=torch.float32)
    x = (x * scheduler.init_noise_sigma).permute(0, 1, 4, 2, 3).contiguous()
    steps, g = int(sampler["steps"]), float(sampler["guidance_scale"])
    cf = int(sampler["context_frames"])
    if L > cf:
        windows = uniform_context_windows(0, L, cf, int(sampler["context_stride"]),
                                          int(sampler["context_overlap"]))
    else:
        windows = np.arange(L)[None]
    for t in scheduler.timesteps(steps):
        t = int(t)
        noise_pred = torch.zeros((2,) + x.shape[1:], device=dev)
        counter = torch.zeros(L, device=dev)
        for win in windows:
            idx = torch.from_numpy(np.asarray(win, np.int64)).to(dev)
            xw = x[0][idx][None].expand(2, -1, -1, -1, -1)
            pw = [pf[0][idx][None].expand(2, -1, -1, -1, -1) for pf in pose_fea]
            pred, _ = models["denoising_unet"](
                xw, torch.full((2,), t, dtype=torch.long, device=dev), ctx_cfg, pw,
                banks, bank_rows=[False, True])
            noise_pred[:, idx] += pred
            counter[idx] += 1.0
        noise_pred = noise_pred / counter[None, :, None, None, None]
        pred = noise_pred[0:1] + g * (noise_pred[1:2] - noise_pred[0:1])
        x = scheduler.step(pred, t, x, steps)

    frames = []
    for z in (x[0] / VAE_SCALE).split(decode_chunk):
        img = (vae.decode(z) / 2 + 0.5).clamp(0.0, 1.0)
        img = torch.round(img * 255.0).to(torch.uint8).permute(0, 2, 3, 1)
        frames.append(img.cpu().numpy())
    return np.concatenate(frames)
