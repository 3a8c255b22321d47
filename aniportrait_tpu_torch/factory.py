"""Model factory (port of ``aniportrait_tpu/factory.py``): the five models
at ``full``, ``tiny`` or ``micro`` size on a given device and dtype, with
seeded random weights, and the pipeline around them."""

from __future__ import annotations

import copy
from dataclasses import dataclass, fields
from typing import Any, Dict

import torch
from torch import nn

from aniportrait_tpu_torch.models.clip_vision import CLIPVisionModelWithProjection
from aniportrait_tpu_torch.models.motion_module import PositionalEncoding
from aniportrait_tpu_torch.models.pose_guider import PoseGuider
from aniportrait_tpu_torch.models.unet import AniUNet
from aniportrait_tpu_torch.models.vae import AutoencoderKL
from aniportrait_tpu_torch.schedulers import DDIMScheduler

# Same sizes as aniportrait_tpu/factory.py:24-56 (full = SD-1.5 UNet,
# sd-vae-ft-mse, CLIP ViT-L/14, PoseGuider at 320 channels).
FULL = dict(
    unet=dict(block_out_channels=(320, 640, 1280, 1280), attention_heads=8,
              cross_attention_dim=768),
    vae=dict(block_out_channels=(128, 256, 512, 512)),
    clip=dict(hidden=1024, layers=24, heads=16, intermediate=4096, patch=14,
              image_size=224, projection_dim=768),
    pose_guider=dict(noise_latent_channels=320),
)
TINY = dict(
    unet=dict(block_out_channels=(32, 64, 128, 128), attention_heads=8,
              cross_attention_dim=16),
    vae=dict(block_out_channels=(32, 32, 64, 64)),
    clip=dict(hidden=32, layers=2, heads=4, intermediate=64, patch=8,
              image_size=224, projection_dim=16),
    pose_guider=dict(noise_latent_channels=32, attn_heads=4, attn_dim_head=8),
)
MICRO = dict(
    unet=dict(block_out_channels=(32, 32), attention_heads=4,
              cross_attention_dim=16, layers_per_block=1),
    vae=dict(block_out_channels=(32, 32, 32, 32)),
    clip=dict(hidden=32, layers=1, heads=4, intermediate=64, patch=8,
              image_size=32, projection_dim=16),
    pose_guider=dict(noise_latent_channels=32, attn_heads=4, attn_dim_head=8,
                     num_stages=2),
)
SIZES = {"full": FULL, "tiny": TINY, "micro": MICRO}

INFERENCE_SCHEDULER = dict(
    beta_start=0.00085, beta_end=0.012, beta_schedule="linear", clip_sample=False,
    steps_offset=1, prediction_type="v_prediction", rescale_betas_zero_snr=True,
    timestep_spacing="trailing",
)

NORMS = (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d)


@dataclass
class PipelineModules:
    vae: AutoencoderKL
    clip: CLIPVisionModelWithProjection
    reference_unet: AniUNet
    denoising_unet: AniUNet
    pose_guider: PoseGuider
    scheduler: DDIMScheduler

    def models(self) -> Dict[str, nn.Module]:
        return {f.name: getattr(self, f.name) for f in fields(self)
                if isinstance(getattr(self, f.name), nn.Module)}

    def to(self, device) -> "PipelineModules":
        """A copy of the models on ``device`` (same weights)."""
        moved = {k: copy.deepcopy(m).to(device) for k, m in self.models().items()}
        return PipelineModules(scheduler=self.scheduler, **moved)


def make_models(size: str = "full", use_motion_module: bool = True) -> Dict[str, nn.Module]:
    """Construct the five models (default torch init) on the current default
    device; ``with torch.device('meta')`` builds them without memory."""
    cfg = SIZES[size]
    return dict(
        vae=AutoencoderKL(**cfg["vae"]),
        clip=CLIPVisionModelWithProjection(**cfg["clip"]),
        reference_unet=AniUNet(**cfg["unet"], use_motion_module=False,
                               has_output_head=False),
        denoising_unet=AniUNet(**cfg["unet"], use_motion_module=use_motion_module),
        pose_guider=PoseGuider(**cfg["pose_guider"]),
    )


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator, std: float = 0.02):
    """Seeded random weights, the rule of the JAX package's numpy fill
    (``aniportrait_tpu/factory.py:_fill_abstract``): norm scales and BatchNorm
    variances 1, biases and means 0, every other weight N(0, std)."""
    for name, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            if pname == "bias":
                p.zero_()
            elif isinstance(mod, NORMS) or pname == "scale":
                p.fill_(1.0)
            else:
                p.normal_(0.0, std, generator=generator)
        if isinstance(mod, nn.BatchNorm2d):
            mod.reset_running_stats()
        if isinstance(mod, PositionalEncoding):
            mod.reset_parameters()
    return model


def cast(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast to ``dtype``, keeping BatchNorm (parameters and running
    statistics) in float32."""
    model.to(dtype)
    for mod in model.modules():
        if isinstance(mod, nn.BatchNorm2d):
            mod.float()
    return model


def build_models(size: str = "full", device="cuda", dtype=torch.float32, seed: int = 0,
                 use_motion_module: bool = True,
                 scheduler_kwargs: Dict[str, Any] | None = None) -> PipelineModules:
    """The five models at ``size`` on ``device`` in ``dtype``, eval mode, no
    gradients, weights drawn on the device from ``seed``."""
    device = torch.device(device)
    with torch.device("meta"):
        models = make_models(size, use_motion_module)
    gen = torch.Generator(device=device).manual_seed(seed)
    for model in models.values():
        model.to_empty(device=device)
        init_weights(model, gen)
        cast(model, dtype).eval().requires_grad_(False)
    return PipelineModules(
        scheduler=DDIMScheduler(**(scheduler_kwargs or INFERENCE_SCHEDULER)), **models
    )


def build_training_models(size: str = "full", device="cuda", seed: int = 0,
                          frozen_dtype=torch.bfloat16,
                          scheduler_kwargs: Dict[str, Any] | None = None
                          ) -> PipelineModules:
    """The five models of stage-1 training on ``device``, weights drawn
    from ``seed``: ReferenceNet, the denoising UNet without motion modules
    and the PoseGuider in float32 (the trainables' master weights), VAE and
    CLIP in ``frozen_dtype``, eval mode and no gradients.  Which parameters
    train is set by ``train.train_step.apply_freeze``."""
    modules = build_models(size, device, torch.float32, seed,
                           use_motion_module=False,
                           scheduler_kwargs=scheduler_kwargs)
    cast(modules.vae, frozen_dtype)
    cast(modules.clip, frozen_dtype)
    return modules


def build_pipeline(size: str = "full", device="cuda", dtype=torch.float32, seed: int = 0,
                   **pipeline_kwargs):
    """``build_models`` and a ``Pose2VideoPipeline`` over them;
    ``pipeline_kwargs`` are the pipeline's options (context windows, window
    batch, ``window_fusion``, ``fusion_motion``, ``encoder_cache_interval``,
    ``context_rotate``)."""
    from aniportrait_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline

    modules = build_models(size, device, dtype, seed)
    return Pose2VideoPipeline(modules, dtype=dtype, **pipeline_kwargs)
