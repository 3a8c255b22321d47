"""Stage-2 (motion-module) training CLI (port of the root
``train_stage_2.py``).

    python -m aniportrait_tpu_torch.scripts.train_stage_2 --config ./configs/train/stage2.yaml

Flags as ``scripts/train_stage_1.py`` (the JAX CLI's plus ``--size`` and
``--device``; the card unless ``--device cpu``).  The denoising UNet has
the motion modules of the YAML's ``inference_config``
(``unet_additional_kwargs``); only they train, on clips of
``sample_n_frames`` frames, with the frozen weights stored in bf16 under
bf16 compute and gradient checkpointing as the YAML sets it.  Without
``--random-init`` the VAE and the CLIP image encoder load from the YAML's
paths, the ReferenceNet, the denoising UNet and the PoseGuider from stage
1's output (``<stage1_ckpt_dir>/<name>-<stage1_ckpt_step>.pth``, as
``scripts/train_stage_1.py`` and the reference write them), and the
AnimateDiff motion modules from ``mm_path`` over them, all through
``weights/load.py``.  At the end it writes the motion modules' state dict
under the reference's names, ``motion_module-<step>.pth``, which the
loader reads as a prompt config's ``motion_module_path``.  Under
``torchrun`` it trains data-parallel as ``scripts/train_stage_1.py`` does.
"""

from __future__ import annotations

import os

import torch

from aniportrait_tpu_torch import factory
from aniportrait_tpu_torch.config import load_config
from aniportrait_tpu_torch.scripts.loader import inference_settings
from aniportrait_tpu_torch.scripts.train_stage_1 import (
    check_device,
    data_parallel_mesh,
    finish_distributed,
    overlay,
    parse_args,
    run,
    save_state,
)
from aniportrait_tpu_torch.weights.load import find_weights


def is_motion(key: str) -> bool:
    return ".motion_modules." in key


def main(argv=None):
    from aniportrait_tpu_torch.train.stage2 import Stage2Settings

    args = parse_args(argv, "./configs/train/stage2.yaml")
    device = check_device(args.device)
    cfg = load_config(args.config)
    settings = Stage2Settings.from_config(cfg)
    mesh = data_parallel_mesh(settings, device)
    torch.manual_seed(settings.seed)
    overrides = inference_settings(cfg)[0] if cfg.get("inference_config") else None
    modules = factory.build_training_models(
        args.size, device, seed=settings.seed, frozen_dtype=settings.compute_dtype,
        scheduler_kwargs=settings.scheduler_kwargs(), stage=2,
        gradient_checkpointing=settings.gradient_checkpointing, unet_overrides=overrides)
    if not args.random_init:
        overlay(modules.vae, "vae", [find_weights(str(cfg.vae_model_path))])
        overlay(modules.clip, "clip", [find_weights(str(cfg.image_encoder_path))])
        s1 = lambda name: os.path.join(str(cfg.stage1_ckpt_dir),
                                       f"{name}-{cfg.stage1_ckpt_step}.pth")
        overlay(modules.reference_unet, "reference_unet", [s1("reference_unet")])
        overlay(modules.pose_guider, "pose_guider", [s1("pose_guider")])
        overlay(modules.denoising_unet, "denoising_unet",
                [s1("denoising_unet")] + ([str(cfg.mm_path)] if cfg.get("mm_path") else []))

    save_dir, history = run(cfg, settings, modules, args, device, mesh)
    step = history[-1]["step"] + 1 if history else 0
    if mesh.rank == 0:
        path = save_dir / f"motion_module-{step}.pth"
        save_state(modules.denoising_unet, path, is_motion)
        print(f"done, saved to {path}")
    finish_distributed()


if __name__ == "__main__":
    main()
