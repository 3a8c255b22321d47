"""Port weights: parameter names and the JAX <-> torch conversion.

(c1) At full size (built on the meta device, no memory) each port model's
     state_dict keys and shapes equal the reference torch checkpoint's, as
     tests/keygen_torch.py generates them; real .pth files then load with
     load_state_dict.
(c2) A port state_dict -> aniportrait_tpu/weights/convert.py -> flax tree ->
     aniportrait_tpu_torch/weights/from_jax.py round trip returns every
     tensor exactly.
"""

import pytest
import torch

import keygen_torch as kg

from aniportrait_tpu.weights import convert as cv
from aniportrait_tpu_torch import factory
from aniportrait_tpu_torch.weights import from_jax

HEAD = {"conv_norm_out.weight", "conv_norm_out.bias", "conv_out.weight", "conv_out.bias"}

EXPECTED_KEYS = {
    "denoising_unet": kg.denoising_unet_keys,
    # the ReferenceNet has no output head (reference unet_2d_condition.py:645-652)
    "reference_unet": lambda: {k: v for k, v in kg.sd15_unet_keys().items() if k not in HEAD},
    "vae": kg.vae_keys,
    "clip": kg.clip_vision_keys,
    "pose_guider": kg.pose_guider_keys,
}


@pytest.fixture(scope="module")
def full_models():
    with torch.device("meta"):
        return factory.make_models("full")


@pytest.mark.parametrize("name", sorted(EXPECTED_KEYS))
def test_fullsize_state_dict_matches_checkpoint_keys(full_models, name):
    got = {k: tuple(v.shape) for k, v in full_models[name].state_dict().items()}
    want = EXPECTED_KEYS[name]()
    assert sorted(set(want) - set(got)) == [], "missing checkpoint keys"
    assert sorted(set(got) - set(want)) == [], "keys absent from the checkpoint"
    assert {k: s for k, s in got.items() if want[k] != s} == {}, "shape mismatch"


def _to_flax(name, sd):
    """torch state dict -> flax variables through convert.py."""
    if name == "pose_guider":
        variables, unused = cv.convert_pose_guider(sd)
    elif name == "vae":
        variables, unused = cv.convert_vae(sd)
    elif name == "clip":
        variables, unused = cv.convert_clip_vision(sd)
    else:
        variables, unused = cv.convert_unet(sd, has_output_head=name == "denoising_unet")
    skipped = [k for k in unused if k.endswith(("pos_encoder.pe", "num_batches_tracked"))]
    assert unused == skipped
    return variables


FROM_JAX = {
    "denoising_unet": from_jax.unet_from_jax,
    "reference_unet": from_jax.unet_from_jax,
    "vae": from_jax.vae_from_jax,
    "clip": from_jax.clip_from_jax,
    "pose_guider": from_jax.pose_guider_from_jax,
}


@pytest.mark.parametrize("name", sorted(FROM_JAX))
def test_convert_from_jax_round_trip_is_exact(name):
    modules = factory.build_models("tiny", "cpu", torch.float32, seed=3)
    model = modules.models()[name]
    sd = model.state_dict()
    back = FROM_JAX[name](model, _to_flax(name, sd))
    assert back.keys() == sd.keys()
    for key, value in sd.items():
        assert torch.equal(back[key], value), key
