"""Stage-1 training in the port against the JAX package, on the CPU, float32.

(a) The traced bank-drop mode of the spatial transformer (the masked
    attention of the training path) equals the JAX block's.
(b) The PoseGuider in train mode: output and updated BatchNorm statistics
    equal flax's (biased variance, momentum 0.9 on the old value).
(c) One micro stage-1 train step equals JAX ``make_train_step`` from the
    same weights, batch and random draws (the JAX draws are reproduced from
    the step's key, as its loss_fn draws them), at CFG-dropout ratio 0 and 1
    so that both bank paths run: the loss, every trainable gradient (after
    clipping, read from Adam's first moment on the JAX side), the updated
    parameters and the BatchNorm statistics.
(d) ``Stage1Settings`` defaults are ``configs/train/stage1.yaml``.
"""

from pathlib import Path

import numpy as np
import optax
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from aniportrait_tpu.factory import MICRO, _abstract_shapes, build_model_defs
from aniportrait_tpu_torch import factory
from aniportrait_tpu_torch.train import train_step as port_train
from aniportrait_tpu_torch.train.stage1 import Stage1Settings
from aniportrait_tpu_torch.weights import convert as cv
from aniportrait_tpu_torch.weights import from_jax
from test_torch_modules import fill, one_thread, t  # noqa: F401 (one_thread: autouse)

ROOT = Path(__file__).resolve().parents[1]


def nchw(x):  # numpy (..., H, W, C) -> torch (..., C, H, W)
    return t(np.moveaxis(np.asarray(x), -1, -3))


# ------------------------------------------------------------ (a) traced drop
@pytest.mark.parametrize("drop", [[True, False], [False, False]])
def test_spatial_transformer_traced_drop_parity(drop):
    """Denoising role with drop_mode='traced': batch entry 0 of 2 (3 frames
    each) ignores the bank through the masked attention."""
    from aniportrait_tpu.models.transformer_spatial import SpatialTransformer as Jax
    from aniportrait_tpu_torch.models.transformer_spatial import SpatialTransformer

    rs = np.random.RandomState(2)
    b, f, c, heads = 2, 3, 64, 4
    x = rs.randn(b, f, 8, 8, c).astype(np.float32)
    ctx = rs.randn(b, 1, 16).astype(np.float32)
    bank = rs.randn(b, 64, c).astype(np.float32)
    drop_ref = np.asarray(drop)
    jm = Jax(channels=c, heads=heads, cross_attention_dim=16)
    params = fill(jax.eval_shape(lambda k: jm.init(k, x, ctx, ref_bank=bank),
                                 jax.random.PRNGKey(0)))
    with jax.default_matmul_precision("highest"):
        ref, _ = jm.apply(params, x, ctx, ref_bank=bank, drop_ref=drop_ref,
                          drop_mode="traced")
    holder = torch.nn.Module()
    holder.st = SpatialTransformer(c, heads, 16)
    holder.load_state_dict(from_jax.state_dict_from_jax(
        holder, cv._attention_block_rules("st", "st"), {"st": params["params"]}))
    with torch.no_grad():
        out, _ = holder.st(nchw(x.reshape(b * f, 8, 8, c)), f, t(ctx), ref_bank=t(bank),
                           drop_mode="traced", drop_ref=t(drop_ref))
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1).reshape(x.shape),
                               np.asarray(ref), atol=2e-4, rtol=1e-3)


# ------------------------------------------------------- (b) BatchNorm train
def test_pose_guider_train_mode_matches_flax():
    """Micro PoseGuider, train mode: features and new batch_stats.  Bound
    1e-3 on the features as for the eval-mode test (11 conv + BN layers);
    the statistics (means of O(1) activations) to 1e-4."""
    from aniportrait_tpu.models.pose_guider import PoseGuider as Jax
    from aniportrait_tpu_torch.models.pose_guider import PoseGuider

    rs = np.random.RandomState(5)
    pose = rs.uniform(-1, 1, (2, 1, 64, 64, 3)).astype(np.float32)
    jm = Jax(**MICRO["pose_guider"])
    variables = fill(jax.eval_shape(jm.init, jax.random.PRNGKey(0), pose))
    with jax.default_matmul_precision("highest"):
        ref, new = jm.apply(variables, pose, train=True, mutable=["batch_stats"])
    port = PoseGuider(**MICRO["pose_guider"]).train()
    port.load_state_dict(from_jax.pose_guider_from_jax(port, variables))
    with torch.no_grad():
        outs = port(nchw(pose))
    for o, r in zip(outs, ref):
        np.testing.assert_allclose(o.numpy().transpose(0, 1, 3, 4, 2), np.asarray(r),
                                   atol=1e-3, rtol=1e-3)
    want = from_jax.pose_guider_from_jax(
        port, {"params": variables["params"], "batch_stats": new["batch_stats"]})
    got = port.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * sum(isinstance(mod, torch.nn.BatchNorm2d)
                                 for mod in port.modules())
    for key in stats:
        assert not torch.equal(want[key], from_jax.pose_guider_from_jax(port, variables)[key])
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=key)


# ----------------------------------------------------------- (c) train step
B, F, H = 2, 1, 32
LR = 1e-5
# float32 on both sides, summed in different orders through ~40 layers and
# their backward.  The loss to 1e-5 relative (measured: 6e-7 and 1.3e-6).
# Every gradient entry to 3e-4 of the step's largest gradient (measured:
# 1.2e-4): a gradient is a sum over every position of the batch, and some
# are zero but for rounding (a conv bias ahead of a GroupNorm), so they are
# held to the step's gradient scale, not their own.  Adam's first step moves
# a weight by lr * g / (|g| + eps) ~ lr * sign(g): where |g| is above the
# gradient tolerance the updated weights agree to 2e-7 (measured: 3e-8);
# below it rounding may flip the sign, so there the bound is 2 lr + 2e-7.
LOSS_RTOL, GRAD_TOL, PARAM_ATOL = 1e-5, 3e-4, 2e-7


def _batch():
    rs = np.random.RandomState(0)
    img = MICRO["clip"]["image_size"]
    return {
        "pixel_values": rs.uniform(-1, 1, (B, F, H, H, 3)).astype(np.float32),
        "pixel_values_pose": rs.uniform(-1, 1, (B, F, H, H, 3)).astype(np.float32),
        "pixel_values_ref_img": rs.uniform(-1, 1, (B, H, H, 3)).astype(np.float32),
        "clip_ref_image": rs.randn(B, img, img, 3).astype(np.float32),
    }


def _jax_draws(rng, uncond_ratio):
    """The draws of the JAX loss_fn (train_step.py:189-219) from its key."""
    keys = jax.random.split(rng, 6)
    hl = H // 8
    f32 = jnp.float32
    return port_train.Draws(
        eps_target=nchw(jax.random.normal(keys[0], (B * F, hl, hl, 4), f32)),
        eps_ref=nchw(jax.random.normal(keys[1], (B, hl, hl, 4), f32)),
        uncond=torch.tensor(bool(jax.random.uniform(keys[2], ()) < uncond_ratio)),
        noise=nchw(jax.random.normal(keys[3], (B, F, hl, hl, 4), f32)),
        offset=nchw(jax.random.normal(keys[4], (B, 1, 1, 1, 4), f32)),
        t=t(jax.random.randint(keys[5], (B,), 0, 1000)).long(),
    )


def _adam_first_moment(opt_state):
    states = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(states) == 1
    return states[0].mu


def _as_port(modules, tree, stats):
    """A JAX params-shaped tree as the port's qualified state-dict keys."""
    out = {}
    for name, fn in (("reference_unet", from_jax.unet_from_jax),
                     ("denoising_unet", from_jax.unet_from_jax)):
        sub = tree["reference" if name == "reference_unet" else "denoising"]
        out.update({f"{name}.{k}": v for k, v in fn(getattr(modules, name), sub).items()})
    pg = from_jax.pose_guider_from_jax(
        modules.pose_guider, {"params": tree["pose_guider"], "batch_stats": stats})
    out.update({f"pose_guider.{k}": v for k, v in pg.items()})
    return out


@pytest.mark.parametrize("uncond_ratio", [0.0, 1.0])
def test_train_step_matches_jax(uncond_ratio):
    from aniportrait_tpu.train.train_step import (
        init_train_state, make_optimizer, make_train_step)

    settings = Stage1Settings()
    defs = build_model_defs("micro", use_motion_module=False, dtype=jnp.float32,
                            scheduler_kwargs=settings.scheduler_kwargs())
    vals = fill(_abstract_shapes(defs), seed=1)
    params = {"reference": vals["ref"]["params"], "denoising": vals["den"]["params"],
              "pose_guider": vals["pg"]["params"]}
    stats = vals["pg"]["batch_stats"]
    frozen = (vals["vae"]["params"], vals["clip"]["params"])
    tx = make_optimizer(params, stage=1)
    step = make_train_step(defs, tx, defs["scheduler"], uncond_ratio=uncond_ratio,
                           donate=False)
    rng = jax.random.PRNGKey(11)
    batch = _batch()
    with jax.default_matmul_precision("highest"):
        new_state, metrics = step(init_train_state(params, stats, tx), frozen, batch, rng)
    grads = jax.tree.map(lambda m: m / 0.1, _adam_first_moment(new_state.opt_state))

    m = factory.build_training_models("micro", "cpu", frozen_dtype=torch.float32,
                                      scheduler_kwargs=settings.scheduler_kwargs())
    m.reference_unet.load_state_dict(from_jax.unet_from_jax(m.reference_unet,
                                                            params["reference"]))
    m.denoising_unet.load_state_dict(from_jax.unet_from_jax(m.denoising_unet,
                                                            params["denoising"]))
    m.pose_guider.load_state_dict(from_jax.pose_guider_from_jax(
        m.pose_guider, {"params": params["pose_guider"], "batch_stats": stats}))
    m.vae.load_state_dict(from_jax.vae_from_jax(m.vae, frozen[0]))
    m.clip.load_state_dict(from_jax.clip_from_jax(m.clip, frozen[1]))
    trainable = port_train.apply_freeze(m)
    opt = port_train.make_optimizer(trainable)
    draws = _jax_draws(rng, uncond_ratio)
    assert bool(draws.uncond) == (uncond_ratio == 1.0)
    out = port_train.train_step(m, opt, {k: t(v) for k, v in batch.items()},
                                draws=draws, uncond_ratio=uncond_ratio)

    np.testing.assert_allclose(float(out["loss"]), float(metrics["loss"]), rtol=LOSS_RTOL)
    want_grads = _as_port(m, grads, stats)
    want_params = _as_port(m, new_state.params, new_state.batch_stats)
    assert len(trainable) > 100
    grad_atol = GRAD_TOL * max(float(want_grads[k].abs().max()) for k in trainable)
    for key, p in trainable.items():
        w = want_grads[key].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, atol=grad_atol, rtol=0, err_msg=key)
        atol = np.where(np.abs(w) > grad_atol, PARAM_ATOL, 2 * LR + PARAM_ATOL)
        err = np.abs(p.detach().numpy() - want_params[key].numpy())
        assert (err <= atol).all(), (key, float((err - atol).max()))
    buffers = {f"pose_guider.{k}": v for k, v in m.pose_guider.state_dict().items()
               if k.endswith(("running_mean", "running_var"))}
    assert buffers
    for key, v in buffers.items():
        np.testing.assert_allclose(v.numpy(), want_params[key].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=key)


def test_freeze_mask_stage1_full_size():
    """At full size: ReferenceNet up_blocks.3, VAE and CLIP frozen, all
    else trained (shapes only, on the meta device)."""
    with torch.device("meta"):
        models = factory.make_models("full", use_motion_module=False)
    modules = factory.PipelineModules(scheduler=None, **models)
    mask = port_train.freeze_mask_stage1(modules)
    frozen = {k for k, v in mask.items() if v}
    assert any(k.startswith("reference_unet.up_blocks.3.") for k in frozen)
    assert all(k.startswith(("reference_unet.up_blocks.3.", "vae.", "clip."))
               for k in frozen)
    assert not any(k.startswith(("denoising_unet.", "pose_guider.")) for k in frozen)
    trained = sum(p.numel() for model, module in models.items()
                  for name, p in module.named_parameters()
                  if not mask[f"{model}.{name}"])
    assert 1.5e9 < trained < 1.9e9, trained


# ----------------------------------------------------------- (d) settings
# settings the original's solver reads that this repository's YAMLs leave
# out, with the original's default
NOT_IN_YAML = {"use_8bit_adam": False}


def settings_equal_the_yaml(settings, path):
    """Every field of ``settings`` equals its key in the YAML at ``path``
    (the ``data``, ``solver`` and ``val`` sections and the top level), or is
    one of ``NOT_IN_YAML`` at its default; ``from_config`` of the YAML gives
    the same settings.  Returns the number of keys checked."""
    from aniportrait_tpu_torch.config import load_config

    cfg = yaml.safe_load((ROOT / path).read_text())
    flat = {**cfg["data"], **cfg["solver"], **cfg["val"],
            **{k: v for k, v in cfg.items() if not isinstance(v, dict)}}
    assert settings.sample_size == tuple(cfg["data"]["sample_size"])
    assert settings.noise_scheduler_kwargs == cfg["noise_scheduler_kwargs"]
    checked = 0
    for name, value in vars(settings).items():
        if name in ("sample_size", "noise_scheduler_kwargs"):
            continue
        if name in NOT_IN_YAML:
            assert name not in flat and value == NOT_IN_YAML[name], name
            continue
        assert name in flat, name
        assert value == flat[name], (name, value, flat[name])
        checked += 1
    assert type(settings).from_config(load_config(str(ROOT / path))) == settings
    return checked


def test_stage1_settings_defaults_equal_the_yaml():
    settings = Stage1Settings()
    assert settings_equal_the_yaml(settings, "configs/train/stage1.yaml") >= 15
    kw = settings.scheduler_kwargs()
    assert kw["prediction_type"] == "v_prediction" and kw["rescale_betas_zero_snr"]
    assert settings.compute_dtype == torch.bfloat16
