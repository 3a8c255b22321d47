"""Stage-1 (image) training CLI (port of the root ``train_stage_1.py``).

    python -m aniportrait_tpu_torch.scripts.train_stage_1 --config ./configs/train/stage1.yaml

The JAX CLI's flags (``--config``, ``--random-init``, ``--max-steps``,
``--tiny``) plus ``--size`` (``full``, ``tiny`` or ``micro``; ``--tiny`` is
``--size tiny``) and ``--device``: training runs on the card unless
``--device cpu`` asks for the CPU, and without a card it fails.

The YAML's settings go through ``Stage1Settings.from_config``; batches come
from ``FaceDataset`` over ``data.json_path`` (OpenCV), a thread ahead of the
step (``train/prefetch.py``).  Without ``--random-init`` the VAE, the CLIP
image encoder and the SD-1.5 UNet (into both UNets) load from the YAML's
paths through ``weights/load.py``; the PoseGuider starts from seeded random
weights, as in the JAX CLI.  Under ``<output_dir>/<exp_name>`` it writes
``train_log.jsonl``, trainable-only checkpoints every
``checkpointing_steps`` (``checkpoints/``), validation grids every
``validation_steps`` (``validation/``) and at the end the trained models'
state dicts under the reference's names, as the reference's stage 1 saves
them: ``reference_unet-<step>.pth``, ``denoising_unet-<step>.pth`` and
``pose_guider-<step>.pth`` (what stage 2's ``stage1_ckpt_dir`` and
``stage1_ckpt_step`` name).

Data-parallel under ``torchrun`` (one process a card, NCCL):

    torchrun --nproc_per_node=N -m aniportrait_tpu_torch.scripts.train_stage_1 --config ...

The world size is the data-parallel size and must divide ``train_bs``; each
rank reads ``train_bs / N`` rows a step from its shard of the dataset
(``FaceDataset.shard``), the optimizer state is sharded (ZeRO-1), and only
rank 0 logs, validates and writes checkpoints and the final ``.pth`` files.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Iterable, List

import torch

from aniportrait_tpu_torch import factory
from aniportrait_tpu_torch.config import Config, load_config
from aniportrait_tpu_torch.parallel import init_distributed, make_mesh
from aniportrait_tpu_torch.weights import convert as cv
from aniportrait_tpu_torch.weights.load import (
    find_weights,
    load_into,
    load_torch_state_dict,
    unet_rules,
)

RULES = {
    "vae": cv.vae_rules,
    "clip": cv.clip_vision_rules,
    "reference_unet": lambda: unet_rules(has_output_head=False),
    "denoising_unet": unet_rules,
    "pose_guider": cv.pose_guider_rules,
}


def parse_args(argv=None, default_config: str = "./configs/train/stage1.yaml"):
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, default=default_config)
    p.add_argument("--random-init", action="store_true",
                   help="skip pretrained weight loading (smoke runs)")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--tiny", action="store_true",
                   help="tiny model preset (CI/smoke runs); the same as --size tiny")
    p.add_argument("--size", choices=tuple(factory.SIZES), default=None,
                   help="model size preset (default full)")
    p.add_argument("--device", default="cuda",
                   help="where training runs: cuda (default) or cpu")
    args = p.parse_args(argv)
    args.size = args.size or ("tiny" if args.tiny else "full")
    return args


def check_device(device: str) -> torch.device:
    """``device``, refusing a CUDA device where there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: training runs on the card; pass --device cpu "
                         "to train on the CPU")
    return device


def overlay(model: torch.nn.Module, name: str, sources: Iterable) -> List[str]:
    """Load ``sources`` (file paths or state dicts, later ones over earlier
    ones) over ``model``'s own weights through the model's conversion rules;
    returns the keys no rule takes."""
    state: Dict[str, torch.Tensor] = dict(model.state_dict())
    for src in sources:
        state.update(load_torch_state_dict(src) if isinstance(src, str) else src)
    return load_into(model, state, RULES[name](), name)


def dataset_for(cfg: Config, settings, modules, is_image: bool):
    from aniportrait_tpu_torch.train.dataset import FaceDataset

    return FaceDataset(
        json_path=str(cfg.data.json_path), sample_size=settings.sample_size,
        sample_stride=settings.sample_stride, sample_n_frames=settings.sample_n_frames,
        sample_stride_aug=bool(getattr(settings, "sample_stride_aug", False)),
        is_image=is_image, seed=settings.seed, clip_size=modules.clip.image_size)


def data_parallel_mesh(settings, device: torch.device):
    """The mesh of the ``torchrun`` job this process belongs to (one rank
    without one; NCCL on the card, gloo for ``--device cpu``); its size must
    divide ``train_bs``."""
    init_distributed("gloo" if device.type == "cpu" else None)
    mesh = make_mesh()
    if settings.train_bs % mesh.size:
        raise SystemExit(f"train_bs {settings.train_bs} does not divide over "
                         f"{mesh.size} data-parallel ranks")
    return mesh


def run(cfg: Config, settings, modules, args, device, mesh) -> tuple:
    """Train over the YAML's dataset (this rank's shard of it); returns
    (save_dir, history)."""
    from aniportrait_tpu_torch.train.prefetch import prefetch
    from aniportrait_tpu_torch.train.stage1 import train
    from aniportrait_tpu_torch.train.trackers import Tracker

    dataset = dataset_for(cfg, settings, modules, is_image=settings.stage == 1)
    dataset.shard(mesh.rank, mesh.size)
    save_dir = Path(str(cfg.output_dir)) / str(cfg.exp_name)
    save_dir.mkdir(parents=True, exist_ok=True)
    tracker = Tracker(str(save_dir), str(cfg.exp_name), enable_tb=False) \
        if mesh.rank == 0 else None
    try:
        batches = dataset.batches(settings.train_bs // mesh.size)
        history = train(settings, modules, prefetch(batches, depth=2),
                        max_steps=args.max_steps, device=device, save_dir=str(save_dir),
                        dataset=dataset, tracker=tracker, mesh=mesh)
    finally:
        if tracker is not None:
            tracker.close()
    return save_dir, history


def save_state(model: torch.nn.Module, path: Path, keep=lambda k: True) -> None:
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items() if keep(k)},
               path)


def main(argv=None):
    from aniportrait_tpu_torch.train.stage1 import Stage1Settings

    args = parse_args(argv)
    device = check_device(args.device)
    cfg = load_config(args.config)
    settings = Stage1Settings.from_config(cfg)
    mesh = data_parallel_mesh(settings, device)
    torch.manual_seed(settings.seed)
    frozen_dtype = settings.compute_dtype
    modules = factory.build_training_models(
        args.size, device, seed=settings.seed, frozen_dtype=frozen_dtype,
        scheduler_kwargs=settings.scheduler_kwargs(), stage=1,
        gradient_checkpointing=settings.gradient_checkpointing)
    if not args.random_init:
        base = load_torch_state_dict(find_weights(str(cfg.base_model_path), "unet"))
        overlay(modules.vae, "vae", [find_weights(str(cfg.vae_model_path))])
        overlay(modules.clip, "clip", [find_weights(str(cfg.image_encoder_path))])
        overlay(modules.reference_unet, "reference_unet", [base])
        overlay(modules.denoising_unet, "denoising_unet", [base])

    save_dir, history = run(cfg, settings, modules, args, device, mesh)
    step = history[-1]["step"] + 1 if history else 0
    if mesh.rank == 0:
        for name in ("reference_unet", "denoising_unet", "pose_guider"):
            save_state(getattr(modules, name), save_dir / f"{name}-{step}.pth")
        print(f"done, saved to {save_dir}")
    finish_distributed()


def finish_distributed() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
