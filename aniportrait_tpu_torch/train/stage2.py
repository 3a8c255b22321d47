"""Stage-2 (motion-module) training: the settings of
``configs/train/stage2.yaml`` (port of the loop of ``train_stage_2.py``).
The loop is :func:`train.stage1.train`, which reads the stage from the
settings: only the denoising UNet's motion modules train, on clips of
``sample_n_frames`` frames, with gradient checkpointing on.

    from aniportrait_tpu_torch import factory
    from aniportrait_tpu_torch.train.stage2 import Stage2Settings, train

    settings = Stage2Settings()
    modules = factory.build_training_models(
        "full", "cuda", seed=0, stage=2, gradient_checkpointing=True,
        scheduler_kwargs=settings.scheduler_kwargs())
    history = train(settings, modules, batches, max_steps=4)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

from aniportrait_tpu_torch.train.stage1 import Stage1Settings, train

__all__ = ["Stage2Settings", "train"]


@dataclass
class Stage2Settings(Stage1Settings):
    """``configs/train/stage2.yaml``, flattened as :class:`Stage1Settings`
    flattens stage 1's."""

    stage: ClassVar[int] = 2
    sample_stride: int = 1
    sample_stride_aug: bool = True
    gradient_checkpointing: bool = True
    max_train_steps: int = 40000
    validation_steps: int = 1000
    train_bs: int = 1
