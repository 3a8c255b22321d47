"""The trainer of both stages (port of the loops of ``train_stage_1.py`` and
``train_stage_2.py``): the settings of ``configs/train/stage1.yaml`` as a
dataclass (``train/stage2.py`` has stage 2's), and :func:`train`, which
runs the step over any iterator of batches in the ``train_step`` contract.

:func:`train` follows the original's YAML contract
(``gradient_accumulation_steps``, ``gradient_checkpointing``,
``use_8bit_adam``, ``checkpointing_steps``, ``resume_from_checkpoint``,
``validation_steps``); its learning-rate schedule is the one the repository's
YAMLs name, ``constant`` without ``scale_lr``, and any other value raises.
``max_steps`` counts optimizer steps; with accumulation over k batches each
step takes k batches, as the reference's ``global_step`` does.

    from aniportrait_tpu_torch import factory
    from aniportrait_tpu_torch.train.stage1 import Stage1Settings, train

    settings = Stage1Settings()
    modules = factory.build_training_models(
        "full", "cuda", seed=0, scheduler_kwargs=settings.scheduler_kwargs())
    history = train(settings, modules, batches, max_steps=4)

Data-parallel (``mesh``, every rank calling :func:`train` with its own
batches of ``train_bs / ranks`` rows): the weights are replicated from rank
0, the PoseGuider's BatchNorm takes the global batch's statistics, the
optimizer state is sharded (ZeRO-1), and only rank 0 writes checkpoints,
logs and validates (see ``train_step`` and ``checkpoint``).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field, fields
from typing import Any, ClassVar, Dict, Iterable, List, Optional

import numpy as np
import torch

from aniportrait_tpu_torch.factory import PipelineModules
from aniportrait_tpu_torch.models.pose_guider import sync_batch_norm
from aniportrait_tpu_torch.parallel.mesh import replicate
from aniportrait_tpu_torch.train.checkpoint import (
    finish_async_save,
    latest_step,
    restore_train_checkpoint,
    save_train_checkpoint,
)
from aniportrait_tpu_torch.train.train_step import (
    apply_freeze,
    make_optimizer,
    train_step,
)
from aniportrait_tpu_torch.utils.profiling import count, span

COMPUTE_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.bfloat16,
                  "no": torch.float32, "fp32": torch.float32}
# the sections of the training YAMLs whose keys are settings, besides the
# top level
SECTIONS = ("data", "solver", "val")


@dataclass
class Stage1Settings:
    """``configs/train/stage1.yaml``, flattened: the ``data``, ``solver`` and
    ``val`` keys that shape training, the ``noise_scheduler_kwargs`` and the
    top-level training keys, under the YAML's own names.  ``use_8bit_adam``
    is the original's solver key, which this repository's YAMLs leave out
    (default off).  Paths are read by the CLIs; ``weight_dtype`` is
    ``factory.build_training_models``'s ``frozen_dtype``."""

    stage: ClassVar[int] = 1
    sample_size: tuple = (512, 512)
    sample_stride: int = 4
    sample_n_frames: int = 16
    gradient_accumulation_steps: int = 1
    mixed_precision: str = "bf16"
    gradient_checkpointing: bool = False
    max_train_steps: int = 300000
    max_grad_norm: float = 1.0
    learning_rate: float = 1.0e-5
    scale_lr: bool = False
    lr_warmup_steps: int = 1
    lr_scheduler: str = "constant"
    use_8bit_adam: bool = False
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1.0e-2
    adam_epsilon: float = 1.0e-8
    validation_steps: int = 500
    noise_scheduler_kwargs: Dict[str, Any] = field(default_factory=lambda: dict(
        num_train_timesteps=1000, beta_start=0.00085, beta_end=0.012,
        beta_schedule="scaled_linear", steps_offset=1, clip_sample=False))
    train_bs: int = 2
    uncond_ratio: float = 0.1
    noise_offset: float = 0.05
    snr_gamma: float = 5.0
    enable_zero_snr: bool = True
    seed: int = 12580
    resume_from_checkpoint: str = ""
    checkpointing_steps: int = 2000

    @classmethod
    def from_config(cls, cfg) -> "Stage1Settings":
        """The settings a training YAML (a ``config.Config``) gives; keys it
        lacks keep their defaults."""
        values = {}
        for f in fields(cls):
            found = [cfg[s] for s in SECTIONS if s in cfg and f.name in cfg[s]]
            if found:
                value = found[0][f.name]
            elif f.name in cfg:
                value = cfg[f.name]
            else:
                continue
            if f.name == "sample_size":
                value = tuple(value)
            elif f.name == "noise_scheduler_kwargs":
                value = dict(value)
            values[f.name] = value
        return cls(**values)

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

    def check_schedule(self) -> None:
        """The learning-rate keys, read as the original reads them; only the
        values the repository's YAMLs carry are implemented."""
        if str(self.lr_scheduler) != "constant":
            raise NotImplementedError(
                f"lr_scheduler {self.lr_scheduler!r}: only 'constant' is implemented")
        if self.scale_lr:
            raise NotImplementedError("scale_lr: True is not implemented")


def _to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
            .to(device, torch.float32, non_blocking=True) for k, v in batch.items()}


def _resume_step(settings: Stage1Settings, ckpt_dir: str) -> Optional[int]:
    """The step ``resume_from_checkpoint`` names: ``'latest'`` or a
    ``checkpoint-<step>`` folder name (None: nothing to resume)."""
    name = str(settings.resume_from_checkpoint)
    if name == "latest":
        return latest_step(ckpt_dir)
    return int(os.path.basename(name.rstrip("/")).split("-")[-1])


def train(settings: Stage1Settings, modules: PipelineModules,
          batches: Iterable[Dict[str, Any]], max_steps: int | None = None,
          device="cuda", *, save_dir: str | None = None, dataset=None,
          tracker=None, optimizer: torch.optim.Optimizer | None = None,
          mesh=None) -> List[Dict[str, float]]:
    """Run ``settings.stage`` optimizer steps over ``batches`` (numpy arrays
    or tensors in the ``train_step`` contract) until ``max_steps`` (default
    ``max_train_steps``) or the iterator ends.  ``modules`` come from
    ``factory.build_training_models`` with ``settings.scheduler_kwargs()``.

    ``save_dir``: where ``checkpointing_steps`` writes trainable-only
    checkpoints (``<save_dir>/checkpoints``, async, joined before the next
    save and before this returns) and ``resume_from_checkpoint`` reads them;
    ``dataset``: the ``FaceDataset`` that ``validation_steps`` samples
    (grids under ``<save_dir>/validation``; skipped without one);
    ``tracker``: a ``train.trackers.Tracker`` that logs every 10th step's
    loss; ``optimizer``: one over the stage's trainables (default
    ``make_optimizer`` from the settings); ``mesh``: a ``parallel.Mesh``
    for data-parallel training (see the module doc).

    Returns one ``{'step', 'loss', 'grad_norm', 'seconds'}`` per optimizer
    step (the loss is the mean over its micro-steps); each step's time ends
    in a device synchronisation.

    Traced as one root span ``step`` an optimizer step (from its first
    batch on, ``index`` its step number), holding ``data`` (the batch to
    the device), ``forward``, ``backward``, ``clip`` and ``optimizer``
    (``train_step``) and ``sync`` (the host reads of the loss and the
    gradient norm); the counter ``host_syncs`` counts the step's blocking
    host reads."""
    settings.check_schedule()
    device = torch.device(device)
    max_steps = settings.max_train_steps if max_steps is None else max_steps
    stage = settings.stage
    trainable = apply_freeze(modules, stage)
    for unet in (modules.reference_unet, modules.denoising_unet):
        unet.gradient_checkpointing = settings.gradient_checkpointing
    lead = mesh is None or mesh.rank == 0
    if mesh is not None and mesh.size > 1:
        replicate(modules.models().values(), mesh)
        sync_batch_norm(modules.pose_guider, mesh.world)
    if optimizer is None:
        optimizer = make_optimizer(
            trainable, settings.learning_rate, settings.adam_weight_decay,
            (settings.adam_beta1, settings.adam_beta2), settings.adam_epsilon,
            adam_8bit=settings.use_8bit_adam, mesh=mesh)
    ckpt_dir = None if save_dir is None else os.path.join(save_dir, "checkpoints")
    start = 0
    if settings.resume_from_checkpoint:
        if ckpt_dir is None:
            raise ValueError("resume_from_checkpoint needs a save_dir")
        step = _resume_step(settings, ckpt_dir)
        if step is not None:
            start = restore_train_checkpoint(ckpt_dir, modules, optimizer, trainable,
                                             stage, step)
    generator = torch.Generator(device=device).manual_seed(settings.seed + start)
    loss_kwargs = dict(
        prediction_type=settings.scheduler_kwargs()["prediction_type"],
        snr_gamma=settings.snr_gamma, noise_offset=settings.noise_offset,
        uncond_ratio=settings.uncond_ratio)
    k = settings.gradient_accumulation_steps
    batches = iter(batches)
    history, save = [], None
    try:
        for step in range(start, max_steps):
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                return history
            with span("step", index=step):
                losses = []
                for micro in range(k):
                    if micro:
                        batch = next(batches, None)
                        if batch is None:
                            return history
                    with span("data"):
                        on_device = _to_device(batch, device)
                    out = train_step(modules, optimizer, on_device,
                                     compute_dtype=settings.compute_dtype,
                                     max_grad_norm=settings.max_grad_norm,
                                     generator=generator, accumulation_steps=k,
                                     micro_step=micro, mesh=mesh, **loss_kwargs)
                    losses.append(out["loss"])
                with span("sync"):
                    loss = float(torch.stack(losses).mean())
                    grad_norm = float(out["grad_norm"])
                    count("host_syncs", 2)
                history.append(dict(step=step, loss=loss, grad_norm=grad_norm,
                                    seconds=time.perf_counter() - t0))
            if tracker is not None and lead and step % 10 == 0:
                print(tracker.log(step, {"loss": loss}), flush=True)
            done = step + 1
            if ckpt_dir is not None and done % settings.checkpointing_steps == 0:
                finish_async_save(save)
                save = save_train_checkpoint(ckpt_dir, modules, optimizer, trainable,
                                             done, stage, keep=1, block=False, write=lead)
            if (lead and dataset is not None and save_dir is not None
                    and settings.validation_steps
                    and done % settings.validation_steps == 0):
                from aniportrait_tpu_torch.train.validation import log_validation

                log_validation(modules, dataset, os.path.join(save_dir, "validation"), done,
                               image_mode=stage == 1, width=settings.sample_size[0],
                               height=settings.sample_size[1],
                               compute_dtype=settings.compute_dtype)
    finally:
        finish_async_save(save)
    return history
