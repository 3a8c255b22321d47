"""Pose-conditioned video/image generation (port of
``aniportrait_tpu/pipelines/pose2vid.py``, exact path).

One generation (reference pipeline_pose2vid_long.py:339-584):

1. ``_encode_reference``: CLIP-embed the reference image (CFG pairs it with
   a zero embedding), VAE-encode it, and run the ReferenceNet once on the
   CFG-doubled latent to capture the attention banks.
2. ``_pose_features``: the PoseGuider pyramid for every frame, once.
3. the sampler of ``_build_sampler``: per DDIM step, the denoising UNet on
   the whole clip (one window) or on overlapping context windows whose
   predictions are scatter-added, counted and divided; CFG rows are
   ``[uncond..., cond...]`` with frames contiguous (``drop_mode=
   'first_half'``); banks and context are tiled once per clip.  Latents stay
   float32 across steps.
4. ``_decode``: VAE-decode in chunks to uint8 frames.

Inputs are uint8 ``(H, W, 3)`` images; the output is ``(L, H, W, 3)``.
Initial noise comes from ``torch.Generator(device).manual_seed(seed)``.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from aniportrait_tpu_torch.factory import PipelineModules
from aniportrait_tpu_torch.models.clip_vision import CLIP_MEAN, CLIP_STD
from aniportrait_tpu_torch.utils.image import resize
from aniportrait_tpu_torch.utils.profiling import PhaseTimer

VAE_SCALE = 0.18215


class Pose2VideoPipeline:
    def __init__(self, modules: PipelineModules, dtype=torch.float32,
                 context_frames: int = 16, context_stride: int = 1,
                 context_overlap: int = 4, window_batch: int = 4, mesh=None,
                 encoder_cache_interval: int = 1, window_fusion: bool = False,
                 context_rotate: bool = False):
        unported = dict(mesh=mesh is not None,
                        encoder_cache_interval=encoder_cache_interval != 1,
                        window_fusion=bool(window_fusion),
                        context_rotate=bool(context_rotate))
        asked = [k for k, v in unported.items() if v]
        if asked:
            raise NotImplementedError(f"pipeline options not ported yet: {asked}")
        self.m = modules
        self.dtype = dtype
        self.device = next(modules.vae.parameters()).device
        self.context_frames = context_frames
        self.context_stride = context_stride
        self.context_overlap = context_overlap
        self.window_batch = window_batch
        self.timer = PhaseTimer()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ stages
    def stage_inputs(self, ref_image, pose_images, width, height, device=True):
        """Resize on the host: (ref (1, H, W, 3), clip image (1, s, s, 3),
        poses (1, L, H, W, 3)), uint8 numpy arrays, or uint8 tensors on the
        pipeline's device with ``device=True``."""
        clip_size = self.m.clip.image_size
        ref = resize(ref_image, width, height)[None]
        clip_img = resize(ref_image, clip_size, clip_size)[None]
        poses = np.stack([resize(p, width, height) for p in pose_images])[None]
        if device:
            return tuple(torch.from_numpy(x).to(self.device)
                         for x in (ref, clip_img, poses))
        return ref, clip_img, poses

    @torch.no_grad()
    def _encode_reference(self, ref_u8, clip_u8):
        """ref_u8 (1, H, W, 3), clip_u8 (1, s, s, 3) uint8 tensors.  Returns
        (context (2, 1, proj) [uncond zero, cond], reference latents
        (1, h, w, 4), banks {key: (2, L, C)})."""
        m = self.m
        ref = ref_u8.permute(0, 3, 1, 2).to(self.dtype) / 127.5 - 1.0
        mean = torch.tensor(CLIP_MEAN, device=self.device)[:, None, None]
        std = torch.tensor(CLIP_STD, device=self.device)[:, None, None]
        clip = ((clip_u8.permute(0, 3, 1, 2).float() / 255.0 - mean) / std)
        ctx = m.clip(clip.to(self.dtype))[:, None, :]
        ctx_cfg = torch.cat([torch.zeros_like(ctx), ctx], dim=0)
        ref_latents = m.vae.encode(ref)[0] * VAE_SCALE  # (1, 4, h, w)
        ref_in = torch.cat([ref_latents] * 2, dim=0)[:, None]
        t0 = torch.zeros(2, dtype=torch.long, device=self.device)
        _, banks = m.reference_unet(ref_in, t0, ctx_cfg, capture_banks=True)
        return ctx_cfg, ref_latents.permute(0, 2, 3, 1), banks

    @torch.no_grad()
    def _pose_features(self, pose_u8):
        """pose_u8 (1, L, H, W, 3) uint8 -> list of (1, L, c_k, h_k, w_k)."""
        pose = pose_u8.permute(0, 1, 4, 2, 3).to(self.dtype) / 127.5 - 1.0
        return self.m.pose_guider(pose)

    def _build_sampler(self, video_length: int, hlat: int, wlat: int, steps: int,
                       guidance_scale: float, windowed: bool):
        """The denoise loop for one bucket: ``sample(latents, ctx_cfg, banks,
        pose_fea)`` with latents (1, L, h, w, 4) float32, returns the same."""
        m, sched = self.m, self.m.scheduler
        timesteps = [int(t) for t in sched.timesteps(steps)]
        do_cfg = guidance_scale > 1.0
        if windowed and video_length > self.context_frames:
            from aniportrait_tpu_torch.pipelines.context import (
                uniform_context_windows,
            )

            windows = uniform_context_windows(
                0, video_length, self.context_frames, self.context_stride,
                self.context_overlap,
            )
        else:
            windows = np.arange(video_length, dtype=np.int32)[None]
        n_win, win_len = windows.shape
        single = n_win == 1 and win_len == video_length
        wb = 1 if single else min(self.window_batch, n_win)
        n_pad = (-n_win) % wb
        if n_pad:
            windows = np.tile(windows, (1 + (n_pad + n_win - 1) // n_win, 1))[:n_win + n_pad]
        valid = np.arange(len(windows)) < n_win
        dev = self.device
        win_batches = [
            (torch.from_numpy(windows[i:i + wb].astype(np.int64)).to(dev), valid[i:i + wb])
            for i in range(0, len(windows), wb)
        ]
        drop_mode = "first_half" if do_cfg else "none"

        def cfg2(x):
            return torch.cat([x, x], dim=0) if do_cfg else x

        def tile_cfg(v, n_rows):
            """Rows [uncond x half, cond x half] (or cond only), once per clip."""
            if not do_cfg:
                return v[1:].repeat_interleave(n_rows, dim=0)
            half = n_rows // 2
            return torch.cat([v[:1].repeat_interleave(half, dim=0),
                              v[1:].repeat_interleave(half, dim=0)], dim=0)

        def unet(lat, t, ctx_t, banks_t, pose_w):
            b = lat.shape[0]
            out, _ = m.denoising_unet(
                lat.to(self.dtype), torch.full((b,), t, dtype=torch.long, device=dev),
                ctx_t, pose_cond_fea=pose_w, ref_banks=banks_t, drop_mode=drop_mode,
            )
            return out.float()

        def combine(pred_u, pred_c):
            return pred_u + guidance_scale * (pred_c - pred_u)

        @torch.no_grad()
        def sample(latents, ctx_cfg, banks, pose_fea):
            x = latents.permute(0, 1, 4, 2, 3).contiguous()  # (1, L, 4, h, w)
            n_rows = (2 if do_cfg else 1) * wb
            ctx_t = tile_cfg(ctx_cfg, n_rows)
            banks_t = {k: tile_cfg(v, n_rows) for k, v in banks.items()}
            if single:
                pose_w = [cfg2(pf) for pf in pose_fea]
                for t in timesteps:
                    pred = unet(cfg2(x), t, ctx_t, banks_t, pose_w)
                    if do_cfg:
                        pred = combine(*pred.chunk(2, dim=0))
                    x = sched.step(pred, t, x, steps)
                return x.permute(0, 1, 3, 4, 2).contiguous()

            pose_b = [[cfg2(pf[0][win]) for pf in pose_fea] for win, _ in win_batches]
            for t in timesteps:
                noise_pred = torch.zeros((2 if do_cfg else 1,) + x.shape[1:],
                                         dtype=torch.float32, device=dev)
                counter = torch.zeros(video_length, dtype=torch.float32, device=dev)
                for (win, ok), pose_w in zip(win_batches, pose_b):
                    pred = unet(cfg2(x[0][win]), t, ctx_t, banks_t, pose_w)
                    parts = pred.chunk(2, dim=0) if do_cfg else (pred,)
                    for k in range(win.shape[0]):
                        if not ok[k]:
                            continue
                        for row, part in enumerate(parts):
                            noise_pred[row].index_add_(0, win[k], part[k])
                        counter.index_add_(0, win[k], torch.ones(win_len, device=dev))
                noise_pred = noise_pred / counter[None, :, None, None, None]
                pred = combine(noise_pred[0:1], noise_pred[1:2]) if do_cfg else noise_pred
                x = sched.step(pred, t, x, steps)
            return x.permute(0, 1, 3, 4, 2).contiguous()

        return sample

    @torch.no_grad()
    def _decode(self, latents, decode_chunk: int = 8):
        """latents (1, L, h, w, 4) -> video (L, H, W, 3) uint8 on the device."""
        z = latents[0].permute(0, 3, 1, 2) / VAE_SCALE
        length = z.shape[0]
        decode_chunk = min(decode_chunk, length)
        pad = (-length) % decode_chunk
        if pad:
            z = torch.cat([z, z[:pad]], dim=0)
        out = []
        for chunk in z.split(decode_chunk):
            img = self.m.vae.decode(chunk.to(self.dtype)).float()
            img = (img / 2 + 0.5).clamp(0.0, 1.0)
            out.append(torch.round(img * 255.0).to(torch.uint8).permute(0, 2, 3, 1))
        return torch.cat(out, dim=0)[:length]

    # -------------------------------------------------------------- call
    def __call__(self, ref_image: np.ndarray, pose_images: List[np.ndarray],
                 ref_pose_image, width: int, height: int, video_length: int,
                 num_inference_steps: int = 25, guidance_scale: float = 3.5,
                 seed: int = 42, windowed: bool = True, decode_chunk: int = 8,
                 interpolation_factor: int = 1):
        """Images are uint8 RGB (H, W, 3) numpy arrays (``ref_pose_image`` is
        unused, as in the JAX package).  Returns (L, H, W, 3) float32 in
        [0, 1]."""
        if interpolation_factor > 1:
            raise NotImplementedError("latent interpolation is not ported yet")
        ref, clip_img, poses = self.stage_inputs(ref_image, pose_images, width,
                                                 height)
        with self.timer.phase("encode_reference"):
            ctx_cfg, _, banks = self._encode_reference(ref, clip_img)
            self._sync()
        with self.timer.phase("pose_features"):
            pose_fea = self._pose_features(poses)
            self._sync()

        hlat, wlat = height // 8, width // 8
        sampler = self._build_sampler(video_length, hlat, wlat, num_inference_steps,
                                      guidance_scale, windowed)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        latents = torch.randn((1, video_length, hlat, wlat, 4), generator=gen,
                              device=self.device, dtype=torch.float32)
        latents = latents * self.m.scheduler.init_noise_sigma
        with self.timer.phase("denoise"):
            latents = sampler(latents, ctx_cfg, banks, pose_fea)
            self._sync()
        with self.timer.phase("vae_decode"):
            video = self._decode(latents, decode_chunk)
            self._sync()
        return video.cpu().numpy().astype(np.float32) / 255.0


class Pose2ImagePipeline(Pose2VideoPipeline):
    """Single-frame pipeline (reference pipeline_pose2img.py)."""

    def __call__(self, ref_image, pose_image, width: int, height: int,
                 num_inference_steps: int = 25, guidance_scale: float = 3.5,
                 seed: int = 42):
        video = super().__call__(
            ref_image, [pose_image], None, width, height, video_length=1,
            num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
            seed=seed, windowed=False, decode_chunk=1,
        )
        return video[0]
