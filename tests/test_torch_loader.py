"""The port's loader (aniportrait_tpu_torch/scripts/loader.py) against the
JAX package's (scripts/loader.py).

(a) For inference_v2.yaml and inference_v1.yaml, both loaders build a
    micro float32 pipeline on the CPU (random init); the port's takes the
    JAX weights through weights/from_jax.py.  A 2-step CFG sampler from the
    same latents, and the decode, must agree within the bounds of
    tests/test_torch_pipeline.py (latents 1e-3 abs + 1e-3 rel, frames one
    uint8 level).  v1 runs the non-inflated GroupNorm (statistics over all
    frames) and the epsilon / "leading" DDIM.
(b) Checkpoint files written from a seeded micro port model (.pth, a
    wrapped .pth, .bin, and .safetensors where the package imports, in
    HF-style folders) load back bit for bit, with the SD-1.5 base overlaid
    in the reference's order; the unused keys are the JAX conversion's; the
    JAX loader reads the same files into the same weights.
(c) At full size (meta device) the loader's models carry the reference
    checkpoints' keys and shapes (tests/keygen_torch.py) for both YAMLs.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import keygen_torch as kg
from aniportrait_tpu import factory as jax_factory
from aniportrait_tpu.config import load_config as jax_load_config
from aniportrait_tpu.models.resnet import GroupNorm5D
from aniportrait_tpu.weights import convert as jcv
from aniportrait_tpu_torch import factory
from aniportrait_tpu_torch.config import Config, load_config
from aniportrait_tpu_torch.models.resnet import GroupNorm
from aniportrait_tpu_torch.scripts import loader
from aniportrait_tpu_torch.weights import from_jax
from scripts.loader import load_pipeline as jax_load_pipeline
from test_torch_pipeline import fill, opencv_portable
from test_torch_modules import one_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
PROMPT = ROOT / "configs" / "prompts" / "animation.yaml"
INFERENCE = {v: ROOT / "configs" / "inference" / f"inference_{v}.yaml" for v in ("v1", "v2")}
RES, STEPS, CFG, LENGTH = 64, 2, 3.5, 6

FROM_JAX = (("vae", "vae_params", from_jax.vae_from_jax),
            ("clip", "clip_params", from_jax.clip_from_jax),
            ("reference_unet", "reference_params", from_jax.unet_from_jax),
            ("denoising_unet", "denoising_params", from_jax.unet_from_jax),
            ("pose_guider", "pose_guider_variables", from_jax.pose_guider_from_jax))


def configs(version, **paths):
    """(JAX Config, port Config) of animation.yaml with ``version``'s
    inference YAML and ``paths`` overriding the weight paths."""
    out = []
    for load in (jax_load_config, load_config):
        cfg = load(str(PROMPT))
        cfg.inference_config = str(INFERENCE[version])
        for k, v in paths.items():
            cfg[k] = v
        out.append(cfg)
    return out


def test_smoke_config_literal_equals_the_yaml_files():
    cfg = load_config(str(PROMPT)).to_dict()
    cfg["inference_config"] = load_config(str(INFERENCE["v2"])).to_dict()
    assert chip_smoke.ENTRY_CONFIG == cfg
    overrides, sched, use_mm = loader.inference_settings(Config(chip_smoke.ENTRY_CONFIG))
    by_path = loader.inference_settings(configs("v2")[1])
    assert (overrides, sched, use_mm) == by_path


@pytest.mark.parametrize("frames", [1, 5])
def test_non_inflated_group_norm_matches_jax(frames):
    """GroupNorm(inflated=False) on folded (b * f, c, h, w) input against
    GroupNorm5D(inflated=False) on (b, f, h, w, c); and the two forms differ
    once a sample has more than one frame."""
    rs = np.random.RandomState(frames)
    x = (rs.randn(2, frames, 6, 5, 64) * 3 + rs.randn(1, frames, 1, 1, 64)).astype(np.float32)
    scale, bias = (1 + 0.1 * rs.randn(64)).astype(np.float32), rs.randn(64).astype(np.float32)
    ref = np.asarray(GroupNorm5D(32, 1e-5, inflated=False).apply(
        {"params": {"scale": scale, "bias": bias}}, x))
    gn = GroupNorm(32, 64, eps=1e-5, inflated=False)
    gn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    xt = torch.from_numpy(x.transpose(0, 1, 4, 2, 3).reshape(2 * frames, 64, 6, 5).copy())
    with torch.no_grad():
        out = gn(xt, frames).numpy().reshape(2, frames, 64, 6, 5).transpose(0, 1, 3, 4, 2)
        per_frame = GroupNorm(32, 64, eps=1e-5).eval()
        per_frame.load_state_dict(gn.state_dict())
        inflated = per_frame(xt, frames).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-5)
    differs = np.abs(inflated.reshape(out.shape[0], frames, 64, 6, 5).transpose(
        0, 1, 3, 4, 2) - out).max() > 1e-2
    assert differs == (frames > 1)


def _sampler_and_decode(jp, pp):
    """The pipelines' seams from the same pixels and latents (as
    tests/test_torch_pipeline.py): returns ((port latents, JAX latents),
    (port frames, JAX frames))."""
    m = jp.m
    rs = np.random.RandomState(11)
    ref = rs.randint(0, 255, (70, 70, 3), np.uint8)
    poses = [rs.randint(0, 255, (70, 70, 3), np.uint8) for _ in range(LENGTH)]
    with opencv_portable():
        ref_u8, clip_u8, pose_u8 = jp.stage_inputs(ref, poses, RES, RES, device=False)
    lat0 = rs.randn(1, LENGTH, RES // 8, RES // 8, 4).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ctx_j, _, banks_j = jp._encode_ref_jit(
            (m.clip_params, m.vae_params, m.reference_params), ref_u8, clip_u8)
        pose_j = jp._pose_features_jit(m.pose_guider_variables, pose_u8)
        sampler = jp._build_sampler(LENGTH, RES // 8, RES // 8, STEPS, CFG, True)
        out_j = np.asarray(sampler(m.denoising_params, jnp.asarray(lat0), ctx_j, banks_j,
                                   pose_j))
        video_j = jp._decode(jnp.asarray(out_j), decode_chunk=4, to_host=True)
    with torch.no_grad():
        ctx_p, _, banks_p = pp._encode_reference(torch.from_numpy(ref_u8),
                                                 torch.from_numpy(clip_u8))
        pose_p = pp._pose_features(torch.from_numpy(pose_u8))
        out_p = pp._build_sampler(LENGTH, RES // 8, RES // 8, STEPS, CFG, True)(
            torch.from_numpy(lat0), ctx_p, banks_p, pose_p).numpy()
        video_p = pp._decode(torch.from_numpy(out_j.copy()), decode_chunk=4).numpy()
    assert np.isfinite(out_j).all() and np.abs(out_j - lat0).max() > 0.1
    return (out_p, out_j), (video_p, video_j)


@pytest.mark.parametrize("version", ["v2", "v1"])
def test_load_pipeline_matches_jax(version, monkeypatch):
    jcfg, pcfg = configs(version)
    # the JAX random init without compiling flax's init (its weights are
    # replaced below): shapes from eval_shape, values from numpy
    monkeypatch.setattr(jax_factory, "init_random_params", jax_factory.init_abstract_params)
    jp = jax_load_pipeline(jcfg, dtype=jnp.float32, random_init=True, size="micro")
    pp = loader.load_pipeline(pcfg, dtype=torch.float32, random_init=True, size="micro",
                              device="cpu")
    den = pp.m.denoising_unet
    if version == "v1":
        assert not hasattr(den.mid_block, "motion_modules")
        assert den.motion_pe_max_len == 24 and not den.conv_norm_out.inflated
    else:
        assert hasattr(den.mid_block, "motion_modules") and den.conv_norm_out.inflated
    sched_j, sched_p = jp.m.scheduler, pp.m.scheduler
    np.testing.assert_array_equal(np.asarray(sched_j.timesteps(STEPS)),
                                  sched_p.timesteps(STEPS))
    np.testing.assert_array_equal(np.asarray(sched_j.alphas_cumprod), sched_p.alphas_cumprod)
    assert sched_p.prediction_type == ("epsilon" if version == "v1" else "v_prediction")

    # well-conditioned weights (norm scales off 1) on both sides
    m = jp.m
    for name, attr, _ in FROM_JAX:
        setattr(m, attr, fill(getattr(m, attr), seed=len(name)))
    for name, attr, convert in FROM_JAX:
        model = getattr(pp.m, name)
        model.load_state_dict(convert(model, getattr(m, attr)))
    (out_p, out_j), (video_p, video_j) = _sampler_and_decode(jp, pp)
    np.testing.assert_allclose(out_p, out_j, atol=1e-3, rtol=1e-3)
    assert video_p.shape == video_j.shape == (LENGTH, RES, RES, 3)
    assert np.abs(video_p.astype(int) - video_j.astype(int)).max() <= 1


def _merged(*files):
    """The state dicts of ``files``, each overlaid on the ones before."""
    state = {}
    for path in files:
        state.update(jcv.load_torch_state_dict(path))
    return state


def test_loader_reads_checkpoint_files_bit_for_bit(tmp_path):
    src = factory.build_models("micro", "cpu", torch.float32, seed=1)
    base = factory.build_models("micro", "cpu", torch.float32, seed=2)
    with torch.no_grad():  # running statistics off their initial values
        for mod in src.pose_guider.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_()
                mod.running_var.uniform_(0.5, 2.0)
    has_st = importlib.util.find_spec("safetensors") is not None
    paths = chip_smoke.write_checkpoints(src, str(tmp_path), base=base, safetensors=has_st)
    # a key no rule converts, and the SD-1.5 head the ReferenceNet skips
    unet_file = loader.find_weights(paths["pretrained_base_model_path"], "unet")
    state = loader.load_torch_state_dict(unet_file)
    state["extra_head.weight"] = torch.zeros(3)
    if has_st:
        from safetensors.torch import save_file

        save_file(state, unet_file)
    else:
        torch.save(state, unet_file)
    assert unet_file.endswith(".safetensors" if has_st else ".bin")

    jcfg, pcfg = configs("v2", **paths)
    overrides, sched, use_mm = loader.inference_settings(pcfg)
    modules, unused = loader.load_weights(pcfg, "micro", "cpu", torch.float32, overrides,
                                          sched, use_mm)
    for name, model in src.models().items():
        got = modules.models()[name].state_dict()
        assert got.keys() == model.state_dict().keys()
        for k, v in model.state_dict().items():
            assert torch.equal(got[k], v), f"{name}.{k}"
        assert not modules.models()[name].training

    # unused keys: the JAX conversion's, in its order
    ref_sd = _merged(unet_file, paths["reference_unet_path"])
    den_sd = _merged(unet_file, paths["motion_module_path"], paths["denoising_unet_path"])
    assert unused["reference_unet"] == jcv.convert_unet(ref_sd, has_output_head=False)[1]
    assert unused["denoising_unet"] == jcv.convert_unet(den_sd)[1]
    assert "extra_head.weight" in unused["denoising_unet"]
    assert unused["pose_guider"] == jcv.convert_pose_guider(
        jcv.load_torch_state_dict(paths["pose_guider_path"]))[1]

    # the JAX loader reads the same files into the same weights
    jp = jax_load_pipeline(jcfg, dtype=jnp.float32, size="micro")
    for name, attr, convert in FROM_JAX:
        model = modules.models()[name]
        for k, v in convert(model, getattr(jp.m, attr)).items():
            assert torch.equal(v, model.state_dict()[k]), f"JAX {name}.{k}"


def test_loader_refuses_what_it_cannot_place(tmp_path):
    """A converted key the model lacks, or a model key the files do not
    give, raises: nothing is dropped silently."""
    src = factory.build_models("micro", "cpu", torch.float32, seed=1)
    paths = chip_smoke.write_checkpoints(src, str(tmp_path))
    _, pcfg = configs("v2", **paths)
    overrides, sched, use_mm = loader.inference_settings(pcfg)
    pg = torch.load(paths["pose_guider_path"])
    # a stage the micro PoseGuider (2 stages) does not have
    torch.save({**pg, "conv_layers_3.0.weight": torch.zeros(1)}, paths["pose_guider_path"])
    with pytest.raises(ValueError, match="no place"):
        loader.load_weights(pcfg, "micro", "cpu", torch.float32, overrides, sched, use_mm)
    torch.save({k: v for k, v in pg.items() if k != "final_proj.weight"},
               paths["pose_guider_path"])
    with pytest.raises(KeyError, match="final_proj.weight"):
        loader.load_weights(pcfg, "micro", "cpu", torch.float32, overrides, sched, use_mm)


HEAD = ("conv_norm_out.", "conv_out.")
FULL_KEYS = {
    ("v2", "denoising_unet"): kg.denoising_unet_keys,
    ("v2", "reference_unet"): lambda: {k: s for k, s in kg.sd15_unet_keys().items()
                                       if not k.startswith(HEAD)},
    ("v2", "vae"): kg.vae_keys,
    ("v2", "clip"): kg.clip_vision_keys,
    ("v2", "pose_guider"): kg.pose_guider_keys,
    # v1: no motion module in the mid block, PE tables of 24
    ("v1", "denoising_unet"): lambda: {
        **kg.sd15_unet_keys(),
        **{k: s for k, s in kg.mm_sd_v15_v2_keys(max_len=24).items()
           if not k.startswith("mid_block.")}},
}


@pytest.mark.parametrize("version,name", sorted(FULL_KEYS),
                         ids=[f"{v}-{n}" for v, n in sorted(FULL_KEYS)])
def test_fullsize_loader_models_carry_the_checkpoint_keys(version, name):
    overrides, _, use_mm = loader.inference_settings(configs(version)[1])
    with torch.device("meta"):
        model = factory.make_models("full", use_mm, overrides)[name]
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == FULL_KEYS[(version, name)]()


def test_safetensors_without_the_package_raises_with_the_file(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_safetensors(name, *args, **kw):
        if name.split(".")[0] == "safetensors":
            raise ImportError(name)
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_safetensors)
    path = str(tmp_path / "model.safetensors")
    with pytest.raises(ImportError, match="model.safetensors"):
        loader.load_torch_state_dict(path)
