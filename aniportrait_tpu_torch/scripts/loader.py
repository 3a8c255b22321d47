"""Build the pose2vid pipeline from a prompt config and the reference's
checkpoint files (port of ``scripts/loader.py:load_pipeline``).

The prompt config (``configs/prompts/animation*.yaml``) names the weights
and an inference config (``configs/inference/inference_v{1,2}.yaml``), whose
``unet_additional_kwargs`` shape the denoising UNet and whose
``noise_scheduler_kwargs`` set up the DDIM scheduler.  Weights follow the
reference's ``from_pretrained_2d`` order: the SD-1.5 UNet, overlaid by
``reference_unet.pth`` for the ReferenceNet, and by ``motion_module.pth``
and then ``denoising_unet.pth`` for the denoising UNet; plus the VAE, the
CLIP image encoder and the PoseGuider.
"""

from __future__ import annotations

import sys
from collections.abc import Mapping
from typing import Dict, List, Tuple

import torch

from aniportrait_tpu_torch import factory
from aniportrait_tpu_torch.config import Config, load_config
from aniportrait_tpu_torch.models.motion_module import PositionalEncoding
from aniportrait_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline
from aniportrait_tpu_torch.schedulers import DDIMScheduler
from aniportrait_tpu_torch.utils.quality_gate import enforce_approximation_gate
from aniportrait_tpu_torch.weights import convert as cv
from aniportrait_tpu_torch.weights.load import (
    find_weights,
    load_into,
    load_torch_state_dict,
    unet_rules,
)


def inference_settings(config: Config) -> Tuple[Dict, Dict, bool]:
    """(denoising-UNet overrides, scheduler kwargs, use_motion_module) from
    the prompt config's ``inference_config``: a YAML path, or the same
    settings as a mapping."""
    infer = config.inference_config
    infer_cfg = Config(dict(infer)) if isinstance(infer, Mapping) else load_config(str(infer))
    uk = infer_cfg.unet_additional_kwargs
    mk = uk.get("motion_module_kwargs")
    # the reference's unet_additional_kwargs knobs (v1: no mid-block motion
    # module, PE max_len 24, statistics pooled over frames) as AniUNet fields
    overrides = {"use_inflated_groupnorm": bool(uk.get("use_inflated_groupnorm", False))}
    if "motion_module_mid_block" in uk:
        overrides["motion_module_mid_block"] = bool(uk.motion_module_mid_block)
    if "motion_module_resolutions" in uk:
        overrides["motion_module_resolutions"] = tuple(uk.motion_module_resolutions)
    if mk and "temporal_position_encoding_max_len" in mk:
        overrides["motion_pe_max_len"] = int(mk.temporal_position_encoding_max_len)
    return (overrides, infer_cfg.noise_scheduler_kwargs.to_dict(),
            bool(uk.use_motion_module))


def load_weights(config: Config, size: str = "full", device="cuda",
                 dtype=torch.bfloat16, unet_overrides: Dict | None = None,
                 scheduler_kwargs: Dict | None = None, use_motion_module: bool = True
                 ) -> Tuple[factory.PipelineModules, Dict[str, List[str]]]:
    """The five models at ``size`` on ``device`` in ``dtype`` with the
    checkpoint files' weights, and per model the file keys no conversion
    rule takes (the JAX conversion's ``unused``)."""
    device = torch.device(device)
    with torch.device("meta"):
        models = factory.make_models(size, use_motion_module, unet_overrides)
    for model in models.values():
        model.to_empty(device=device)
        for mod in model.modules():  # the values loading leaves to the model
            if isinstance(mod, PositionalEncoding):
                mod.reset_parameters()
            elif isinstance(mod, torch.nn.BatchNorm2d):
                mod.reset_running_stats()

    base = load_torch_state_dict(find_weights(str(config.pretrained_base_model_path),
                                              "unet"))
    reference = dict(base)
    reference.update(load_torch_state_dict(str(config.reference_unet_path)))
    denoising = dict(base)
    if config.get("motion_module_path"):
        denoising.update(load_torch_state_dict(str(config.motion_module_path)))
    denoising.update(load_torch_state_dict(str(config.denoising_unet_path)))
    sources = {
        "vae": (find_weights(str(config.pretrained_vae_path)), cv.vae_rules()),
        "clip": (find_weights(str(config.image_encoder_path)), cv.clip_vision_rules()),
        "reference_unet": (reference, unet_rules(has_output_head=False)),
        "denoising_unet": (denoising, unet_rules()),
        "pose_guider": (str(config.pose_guider_path), cv.pose_guider_rules()),
    }
    unused = {}
    for name, (state, rules) in sources.items():
        source = state if isinstance(state, str) else name
        if isinstance(state, str):
            state = load_torch_state_dict(state)
        unused[name] = load_into(models[name], state, rules, source)
        factory.cast(models[name], dtype).eval().requires_grad_(False)
    modules = factory.PipelineModules(
        scheduler=DDIMScheduler(**(scheduler_kwargs or factory.INFERENCE_SCHEDULER)),
        **models)
    return modules, unused


def load_pipeline(config: Config, dtype=torch.bfloat16, encoder_cache_interval: int = 1,
                  random_init: bool = False, size: str = "full",
                  window_fusion: bool = False, context_rotate: bool = False,
                  force_approx: bool = False, device="cuda") -> Pose2VideoPipeline:
    """A ``Pose2VideoPipeline`` on ``device`` from a prompt config.

    ``random_init=True`` skips the checkpoint files: seeded random weights
    (seed 0) at ``size``, as ``factory.build_models`` draws them.  The
    approximations (encoder cache, window fusion, context rotation) pass the
    measured quality gate first (``utils/quality_gate.py``): beyond the
    gated regime it refuses unless ``force_approx``."""
    enforce_approximation_gate(encoder_cache_interval=encoder_cache_interval,
                               window_fusion=window_fusion,
                               context_rotate=context_rotate, force=force_approx)
    overrides, sched_kw, use_mm = inference_settings(config)
    if random_init:
        modules = factory.build_models(size, device, dtype, seed=0,
                                       use_motion_module=use_mm,
                                       scheduler_kwargs=sched_kw,
                                       unet_overrides=overrides)
    else:
        modules, unused = load_weights(config, size, device, dtype, overrides, sched_kw,
                                       use_mm)
        for name, keys in unused.items():
            if keys:
                print(f"[loader] {name}: {len(keys)} checkpoint keys unused: {keys[:8]}",
                      file=sys.stderr)
    return Pose2VideoPipeline(modules, dtype=dtype,
                              encoder_cache_interval=encoder_cache_interval,
                              window_fusion=window_fusion, context_rotate=context_rotate)
