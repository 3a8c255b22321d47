"""Stage-1 trainer (port of the loop of ``train_stage_1.py``, its lines
95-190 and 234-257): the settings of ``configs/train/stage1.yaml`` as a
dataclass, and :func:`train`, which runs the step over any iterator of
batches in the ``train_step`` contract.

Not ported yet: the dataset (it decodes video frames with OpenCV), gradient
accumulation and checkpointing, checkpoints, validation and 8-bit AdamW.

    from aniportrait_tpu_torch import factory
    from aniportrait_tpu_torch.train.stage1 import Stage1Settings, train

    settings = Stage1Settings()
    modules = factory.build_training_models(
        "full", "cuda", seed=0, scheduler_kwargs=settings.scheduler_kwargs())
    history = train(settings, modules, batches, max_steps=4)
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List

import numpy as np
import torch

from aniportrait_tpu_torch.factory import PipelineModules
from aniportrait_tpu_torch.train.train_step import (
    apply_freeze,
    make_optimizer,
    train_step,
)

COMPUTE_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.bfloat16,
                  "no": torch.float32, "fp32": torch.float32}


@dataclass
class Stage1Settings:
    """``configs/train/stage1.yaml``, flattened: the ``solver`` keys, the
    ``noise_scheduler_kwargs`` and the top-level training keys, under the
    YAML's own names.  Left out with the code that would read them: paths,
    checkpointing and validation keys, ``weight_dtype`` (the frozen models'
    dtype is ``factory.build_training_models``'s ``frozen_dtype``), and the
    learning-rate schedule keys (``constant`` with ``scale_lr`` off, which
    the JAX trainer does not read either)."""

    sample_size: tuple = (512, 512)
    gradient_accumulation_steps: int = 1
    mixed_precision: str = "bf16"
    gradient_checkpointing: bool = False
    max_train_steps: int = 300000
    max_grad_norm: float = 1.0
    learning_rate: float = 1.0e-5
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1.0e-2
    adam_epsilon: float = 1.0e-8
    noise_scheduler_kwargs: Dict[str, Any] = field(default_factory=lambda: dict(
        num_train_timesteps=1000, beta_start=0.00085, beta_end=0.012,
        beta_schedule="scaled_linear", steps_offset=1, clip_sample=False))
    train_bs: int = 2
    uncond_ratio: float = 0.1
    noise_offset: float = 0.05
    snr_gamma: float = 5.0
    enable_zero_snr: bool = True
    seed: int = 12580

    def scheduler_kwargs(self) -> Dict[str, Any]:
        """The training scheduler's arguments: the YAML's, switched to
        zero-terminal SNR, trailing spacing and v-prediction when
        ``enable_zero_snr`` (train_stage_1.py:98-106)."""
        kwargs = dict(self.noise_scheduler_kwargs)
        if self.enable_zero_snr:
            kwargs.update(rescale_betas_zero_snr=True, timestep_spacing="trailing",
                          prediction_type="v_prediction")
        else:
            kwargs.setdefault("prediction_type", "epsilon")
            kwargs.setdefault("rescale_betas_zero_snr", False)
        return kwargs

    @property
    def compute_dtype(self) -> torch.dtype:
        return COMPUTE_DTYPES[str(self.mixed_precision).lower()]


def _to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
            .to(device, torch.float32, non_blocking=True) for k, v in batch.items()}


def train(settings: Stage1Settings, modules: PipelineModules,
          batches: Iterable[Dict[str, Any]], max_steps: int | None = None,
          device="cuda") -> List[Dict[str, float]]:
    """Run stage-1 steps over ``batches`` (numpy arrays or tensors in the
    ``train_step`` contract) until ``max_steps`` or the iterator ends.
    ``modules`` come from ``factory.build_training_models`` with
    ``settings.scheduler_kwargs()``.  Returns one ``{'step', 'loss',
    'grad_norm', 'seconds'}`` per step; each step's time ends in a
    device synchronisation."""
    if settings.gradient_accumulation_steps != 1 or settings.gradient_checkpointing:
        raise NotImplementedError(
            "gradient accumulation and gradient checkpointing are not ported yet")
    device = torch.device(device)
    max_steps = settings.max_train_steps if max_steps is None else max_steps
    trainable = apply_freeze(modules)
    optimizer = make_optimizer(
        trainable, settings.learning_rate, settings.adam_weight_decay,
        (settings.adam_beta1, settings.adam_beta2), settings.adam_epsilon)
    generator = torch.Generator(device=device).manual_seed(settings.seed)
    loss_kwargs = dict(
        prediction_type=settings.scheduler_kwargs()["prediction_type"],
        snr_gamma=settings.snr_gamma, noise_offset=settings.noise_offset,
        uncond_ratio=settings.uncond_ratio)
    history = []
    for step, batch in enumerate(itertools.islice(batches, max_steps)):
        t0 = time.perf_counter()
        out = train_step(modules, optimizer, _to_device(batch, device),
                         compute_dtype=settings.compute_dtype,
                         max_grad_norm=settings.max_grad_norm,
                         generator=generator, **loss_kwargs)
        loss, norm = float(out["loss"]), float(out["grad_norm"])
        history.append(dict(step=step, loss=loss, grad_norm=norm,
                            seconds=time.perf_counter() - t0))
    return history
