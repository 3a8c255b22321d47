"""Checkpoint validation: strict key and shape bijection between the
reference's weight files and the port's full-size models (port of
``aniportrait_tpu/weights/validate.py``).

The port's module names are the reference checkpoint names, so bijection
here means: the keys a conversion rule takes from a file, with their
shapes, against the model's ``state_dict()`` keys and shapes (less the keys
the same rules mark ``skip``: tables the model computes, BatchNorm's
``num_batches_tracked``, the ReferenceNet's output head).  The models are
built on the ``meta`` device, so no weight memory is allocated.
``scripts/validate_weights.py`` applies this to a user's files.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch
from torch import nn

from aniportrait_tpu_torch import factory
from aniportrait_tpu_torch.weights import convert as cv
from aniportrait_tpu_torch.weights.load import (
    audio2mesh_rules,
    audio2pose_rules,
    classify,
    unet_rules,
)

Shapes = Dict[str, Tuple[int, ...]]

# the audio encoders' sizes and the audio heads' widths, and FiLM's config,
# by model size: "full" is the published models, "micro" the tests' small ones
AUDIO_SIZES = {
    "full": dict(wav2vec2=None, latent_dim=512, num_layers=8, heads=8),
    "micro": dict(wav2vec2=dict(hidden=32, layers=2, heads=4, intermediate=64,
                                pos_conv_kernel=16, pos_conv_groups=4,
                                conv_layers=((16, 10, 5), (16, 3, 2))),
                  latent_dim=16, num_layers=2, heads=4),
}
FILM_SIZES = {
    "full": {},
    "micro": dict(pyramid_levels=4, fusion_pyramid_levels=3, specialized_levels=2,
                  sub_levels=3, filters=8, flow_convs=(2, 2, 2), flow_filters=(8, 8, 16)),
}

# family -> the conversion rules of its files
RULES = {
    "vae": cv.vae_rules,
    "clip": cv.clip_vision_rules,
    "reference_unet": lambda: unet_rules(has_output_head=False),
    "denoising_unet": unet_rules,
    "pose_guider": cv.pose_guider_rules,
    "audio2mesh": audio2mesh_rules,
    "audio2pose": audio2pose_rules,
    "film": cv.film_rules,
}


def flat(state: Mapping[str, torch.Tensor]) -> Shapes:
    """{key: shape} of a state dict."""
    return {k: tuple(v.shape) for k, v in state.items()}


def check_bijection(got: Shapes, want: Shapes, family: str) -> List[str]:
    """Problems (empty = pass) between a file's converted ``{key: shape}``
    and the model's."""
    problems = []
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing:
        problems.append(
            f"{family}: {len(missing)} model params UNFILLED, e.g. {missing[:5]}"
        )
    if extra:
        problems.append(
            f"{family}: {len(extra)} converted paths not in the model, e.g. {extra[:5]}"
        )
    bad = [(k, got[k], want[k]) for k in want if k in got and got[k] != want[k]]
    if bad:
        problems.append(f"{family}: {len(bad)} shape mismatches, e.g. {bad[:5]}")
    return problems


def model_shapes(model: nn.Module, family: str) -> Shapes:
    """The model's ``{key: shape}`` that a file must fill: its state dict
    less the keys its family's rules skip."""
    shapes = flat(model.state_dict())
    _, skipped, _ = classify(shapes, RULES[family]())
    return {k: s for k, s in shapes.items() if k not in skipped}


def check_file(state: Mapping[str, torch.Tensor], want: Shapes, family: str) -> List[str]:
    """Problems of one checkpoint's state against ``want``: keys no rule
    takes, then the bijection of the keys the rules convert."""
    converted, _, unused = classify(state.keys(), RULES[family]())
    problems = []
    if unused:
        problems.append(f"{family}: {len(unused)} checkpoint keys NOT consumed, "
                        f"e.g. {unused[:5]}")
    got = {k: tuple(state[k].shape) for k in converted}
    return problems + check_bijection(got, want, family)


def fullsize_model_trees(size: str = "full", unet_overrides: Dict | None = None
                         ) -> Dict[str, Shapes]:
    """Each family's ``{key: shape}`` to fill, from the port's models built
    on the ``meta`` device at ``size`` (``micro`` for the tests);
    ``unet_overrides``: the inference config's denoising-UNet settings
    (``scripts/loader.py:inference_settings``)."""
    from aniportrait_tpu_torch.audio.audio2mesh import Audio2MeshModel
    from aniportrait_tpu_torch.audio.audio2pose import Audio2PoseModel
    from aniportrait_tpu_torch.models.film_net import FilmInterpolator

    audio = AUDIO_SIZES[size]
    with torch.device("meta"):
        models = factory.make_models(size, True, unet_overrides)
        models["audio2mesh"] = Audio2MeshModel(latent_dim=audio["latent_dim"],
                                               wav2vec2=audio["wav2vec2"])
        models["audio2pose"] = Audio2PoseModel(
            latent_dim=audio["latent_dim"], num_layers=audio["num_layers"],
            heads=audio["heads"], wav2vec2=audio["wav2vec2"])
        models["film"] = FilmInterpolator(**FILM_SIZES[size])
    return {family: model_shapes(model, family) for family, model in models.items()}
