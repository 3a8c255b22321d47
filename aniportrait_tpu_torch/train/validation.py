"""Validation-time sampling during training (port of
``aniportrait_tpu/train/validation.py:23-96``): every ``validation_steps``
the trainer runs the inference pipeline over the models it trains, on
random samples of the dataset, and writes side-by-side reference / pose /
generated grids (the reference's ``log_validation``, train_stage_1.py:
131-208, train_stage_2.py:140-238).  Stage 1 samples one frame
(``Pose2ImagePipeline``), stage 2 a clip (``Pose2VideoPipeline``).

The pipeline runs over the training modules themselves; where the frozen
weights are stored in bf16 beside float32 trainables, it runs under
``torch.autocast`` in the training compute dtype.  Reading and writing
images needs OpenCV, so validation runs where the dataset does.
"""

from __future__ import annotations

import os
from contextlib import nullcontext

import numpy as np
import torch

from aniportrait_tpu_torch.factory import PipelineModules
from aniportrait_tpu_torch.pipelines.pose2vid import Pose2ImagePipeline, Pose2VideoPipeline
from aniportrait_tpu_torch.schedulers import DDIMScheduler


def pipeline_modules(modules: PipelineModules, scheduler_kwargs=None) -> PipelineModules:
    """The training models with an inference scheduler (the trainer's
    scheduler adds noise; sampling takes the inference settings)."""
    from aniportrait_tpu_torch.factory import INFERENCE_SCHEDULER

    return PipelineModules(scheduler=DDIMScheduler(**(scheduler_kwargs or INFERENCE_SCHEDULER)),
                           **modules.models())


@torch.no_grad()
def log_validation(modules: PipelineModules, dataset, out_dir: str, step: int,
                   n_samples: int = 2, image_mode: bool = True, width: int = 512,
                   height: int = 512, num_inference_steps: int = 20,
                   compute_dtype: torch.dtype = torch.float32, seed: int = 42) -> list:
    """Sample the models being trained and write one grid per sample:
    ``val_<step>_<i>.png`` (image mode) or ``.mp4``.  Returns the paths."""
    import cv2

    from aniportrait_tpu_torch.utils.util import save_videos_grid

    os.makedirs(out_dir, exist_ok=True)
    device = next(modules.denoising_unet.parameters()).device
    pg_training = modules.pose_guider.training
    modules.pose_guider.eval()
    pipe_cls = Pose2ImagePipeline if image_mode else Pose2VideoPipeline
    pipe = pipe_cls(pipeline_modules(modules), dtype=compute_dtype)
    autocast = (torch.autocast(device.type, dtype=compute_dtype)
                if compute_dtype != torch.float32 else nullcontext())
    rs = np.random.RandomState(seed + step)
    paths = []
    try:
        for i in range(n_samples):
            sample = dataset.validation_sample(rs.randint(0, len(dataset)))
            ref = sample["ref_image"]
            poses = [cv2.resize(p, (width, height)) for p in sample["pose_images"]]
            ref_row = cv2.resize(ref, (width, height)).astype(np.float32) / 255
            if image_mode:
                with autocast:
                    img = pipe(ref, poses[0], width, height, num_inference_steps)
                row = np.concatenate(
                    [ref_row, poses[0].astype(np.float32) / 255, img,
                     cv2.resize(sample["frames"][0], (width, height)).astype(np.float32)
                     / 255], axis=1)
                path = os.path.join(out_dir, f"val_{step}_{i}.png")
                cv2.imwrite(path, cv2.cvtColor((row * 255).astype(np.uint8),
                                               cv2.COLOR_RGB2BGR))
            else:
                length = len(poses)
                with autocast:
                    video = pipe(ref, poses, None, width, height, length,
                                 num_inference_steps)
                grid = np.stack([np.repeat(ref_row[None], length, axis=0),
                                 np.stack([p.astype(np.float32) / 255 for p in poses]),
                                 video])
                path = os.path.join(out_dir, f"val_{step}_{i}.mp4")
                save_videos_grid(grid, path, fps=8)
            paths.append(path)
    finally:
        modules.pose_guider.train(pg_training)
    return paths
