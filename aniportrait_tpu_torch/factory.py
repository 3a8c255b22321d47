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
from aniportrait_tpu_torch.utils.profiling import span

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


def make_models(size: str = "full", use_motion_module: bool = True,
                unet_overrides: Dict[str, Any] | None = None) -> Dict[str, nn.Module]:
    """Construct the five models (default torch init) on the current default
    device; ``with torch.device('meta')`` builds them without memory.
    ``unet_overrides``: extra ``AniUNet`` arguments of the denoising UNet,
    the inference YAMLs' ``unet_additional_kwargs`` (``motion_module_mid_block``,
    ``motion_module_resolutions``, ``motion_pe_max_len``,
    ``use_inflated_groupnorm``), as ``aniportrait_tpu/factory.py:
    build_model_defs`` takes them."""
    cfg = SIZES[size]
    return dict(
        vae=AutoencoderKL(**cfg["vae"]),
        clip=CLIPVisionModelWithProjection(**cfg["clip"]),
        reference_unet=AniUNet(**cfg["unet"], use_motion_module=False,
                               has_output_head=False),
        denoising_unet=AniUNet(**cfg["unet"], use_motion_module=use_motion_module,
                               **(unet_overrides or {})),
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


@torch.no_grad()
def init_flax_defaults(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights by the rule of flax's initializers, as the JAX
    package's ``init_random_params`` draws them (the weights of the stored
    quality-gate table, ``docs/quality_gate*.json``): Linear and Conv
    weights lecun-normal (a normal of variance 1 / fan_in truncated at two
    standard deviations), biases 0, norm scales 1; and the JAX models' own
    initializers: the motion modules' ``proj_out`` and the PoseGuider's
    ``final_proj`` zero (so the motion modules start as the identity), the
    PoseGuider's other convs He-normal, its ``scale`` 2, CLIP's class and
    position embeddings N(0, 0.02)."""
    pose_guider = isinstance(model, PoseGuider)
    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            fan_in = mod.weight[0].numel()
            if name.endswith("temporal_transformer.proj_out") or (
                    pose_guider and name == "final_proj"):
                mod.weight.zero_()
            elif pose_guider and name.startswith("conv_layers"):
                mod.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=generator)
            else:
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, NORMS):
            if mod.weight is not None:
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            if isinstance(mod, nn.BatchNorm2d):
                mod.reset_running_stats()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 0.02, generator=generator)
        elif isinstance(mod, PositionalEncoding):
            mod.reset_parameters()
        for pname, p in mod.named_parameters(recurse=False):
            if pname == "class_embedding":
                p.normal_(0.0, 0.02, generator=generator)
            elif pose_guider and pname == "scale":
                p.fill_(2.0)
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
                 scheduler_kwargs: Dict[str, Any] | None = None,
                 unet_overrides: Dict[str, Any] | None = None,
                 init=init_weights) -> PipelineModules:
    """The five models at ``size`` on ``device`` in ``dtype``, eval mode, no
    gradients, weights drawn on the device from ``seed`` by ``init``
    (:func:`init_weights`, or :func:`init_flax_defaults` for the quality
    gate).  Traced as the span ``build_models``, each model's draw a child
    span ``init``."""
    device = torch.device(device)
    with span("build_models", size=size):
        with torch.device("meta"):
            models = make_models(size, use_motion_module, unet_overrides)
        gen = torch.Generator(device=device).manual_seed(seed)
        for name, model in models.items():
            model.to_empty(device=device)
            with span("init", model=name):
                init(model, gen)
            cast(model, dtype).eval().requires_grad_(False)
        return PipelineModules(
            scheduler=DDIMScheduler(**(scheduler_kwargs or INFERENCE_SCHEDULER)), **models
        )


# ``configs/inference/inference_v2.yaml``'s ``unet_additional_kwargs`` as
# ``AniUNet`` arguments: the denoising UNet of stage-2 training
# (``configs/train/stage2.yaml``'s ``inference_config``); the rest of that
# block is the class's defaults (motion modules at every resolution, 8 heads,
# one transformer block of two temporal self attentions)
INFERENCE_V2_UNET = dict(use_inflated_groupnorm=True, motion_module_mid_block=True,
                         motion_module_resolutions=(1, 2, 4, 8), motion_pe_max_len=32)


def build_training_models(size: str = "full", device="cuda", seed: int = 0,
                          frozen_dtype=torch.bfloat16,
                          scheduler_kwargs: Dict[str, Any] | None = None,
                          stage: int = 1, gradient_checkpointing: bool = False,
                          unet_overrides: Dict[str, Any] | None = None
                          ) -> PipelineModules:
    """The five models of stage-``stage`` training on ``device``, weights
    drawn from ``seed``, eval mode and no gradients (which parameters train
    is set by ``train.train_step.apply_freeze``).  The trainables' master
    weights are float32 and the frozen weights are stored in
    ``frozen_dtype``, as ``cast_frozen_to_bf16`` does
    (``aniportrait_tpu/train/train_step.py:78-93``; BatchNorm stays float32):

    * stage 1: ReferenceNet, the denoising UNet without motion modules and
      the PoseGuider train; VAE and CLIP are frozen.
    * stage 2: the denoising UNet with motion modules (``unet_overrides``,
      default :data:`INFERENCE_V2_UNET`); only its motion modules train, and
      the ReferenceNet, the rest of the denoising UNet, the PoseGuider, VAE
      and CLIP are frozen.

    ``gradient_checkpointing`` is set on both UNets.  Traced as the span
    ``build_training_models``, with ``build_models`` and its ``init`` spans
    inside."""
    if stage not in (1, 2):
        raise ValueError(f"stage={stage}")
    with span("build_training_models", size=size, stage=stage):
        return _training_models(size, device, seed, frozen_dtype, scheduler_kwargs, stage,
                                gradient_checkpointing, unet_overrides)


def _training_models(size, device, seed, frozen_dtype, scheduler_kwargs, stage,
                     gradient_checkpointing, unet_overrides) -> PipelineModules:
    """The body of :func:`build_training_models`."""
    overrides = unet_overrides if unet_overrides is not None else (
        INFERENCE_V2_UNET if stage == 2 else None)
    modules = build_models(size, device, torch.float32, seed,
                           use_motion_module=stage == 2,
                           scheduler_kwargs=scheduler_kwargs,
                           unet_overrides=overrides)
    frozen = [modules.vae, modules.clip]
    if stage == 2:
        frozen += [modules.reference_unet, modules.pose_guider]
        for name, mod in modules.denoising_unet.named_children():
            if name not in ("down_blocks", "mid_block", "up_blocks"):
                cast(mod, frozen_dtype)
        for blk in [*modules.denoising_unet.down_blocks, modules.denoising_unet.mid_block,
                    *modules.denoising_unet.up_blocks]:
            for name, mod in blk.named_children():
                if name != "motion_modules":
                    cast(mod, frozen_dtype)
    for model in frozen:
        cast(model, frozen_dtype)
    for unet in (modules.reference_unet, modules.denoising_unet):
        unet.gradient_checkpointing = gradient_checkpointing
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
