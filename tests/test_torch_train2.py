"""Stage-2 training and the trainer's optimizer features in the port
against the JAX package, on the CPU, float32, at micro size
(tests/test_torch_train_loop.py has the loop's features: checkpointing,
checkpoints, the CLIs).

(a) One micro stage-2 step equals JAX ``make_train_step(stage=2)`` from the
    same weights, batch and random draws: the loss, every motion-module
    gradient and updated weight, the frozen weights unchanged, the
    PoseGuider's BatchNorm statistics; the temporal attention goes through
    the K3 route (``NatTemporal``).
(b) The stage-2 freeze mask at full size counts JAX ``_freeze_mask_stage2``'s
    trainable elements.
(c) ``AdamW8bit(v_code="linear")`` equals JAX ``adamw8bit`` over three
    steps; the default log2 code of Adam's ``v`` keeps every step within a
    few ``lr`` of float32 AdamW where gradient scales spread over four
    decades, where the linear code takes steps thousands of times ``lr``
    (ROADMAP F10).
(d) Accumulation over two batches equals ``optax.MultiSteps``.
(e) ``Stage2Settings`` defaults are ``configs/train/stage2.yaml``; the
    stage-2 denoising UNet's arguments are ``inference_v2.yaml``'s.
"""

import copy
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from aniportrait_tpu.factory import _abstract_shapes, build_model_defs
from aniportrait_tpu_torch import factory
from aniportrait_tpu_torch.ops.kernels import autograd as kernel_autograd
from aniportrait_tpu_torch.train import train_step as port_train
from aniportrait_tpu_torch.train.optim8bit import AdamW8bit
from aniportrait_tpu_torch.train.stage2 import Stage2Settings
from aniportrait_tpu_torch.weights import from_jax
from test_torch_modules import fill, one_thread, t  # noqa: F401 (one_thread: autouse)
from test_torch_train import settings_equal_the_yaml

ROOT = Path(__file__).resolve().parents[1]
B, F, H = 1, 8, 64  # 8x8 and 4x4 latents over 8 frames: every level packs for K3
LR = 1e-5
# float32 on both sides in different summation orders through the UNet and
# its backward, over 8 frames.  The loss to 2e-4 relative; the gradients and
# updated weights by the rule of tests/test_torch_train.py (every gradient
# entry to GRAD_TOL of the step's largest; a weight whose gradient is above
# that moves by lr * sign(g) on Adam's first step and agrees to PARAM_ATOL,
# below it rounding may flip the sign: 2 lr + PARAM_ATOL).
LOSS_RTOL, GRAD_TOL, PARAM_ATOL = 2e-4, 3e-4, 2e-7


def nchw(x):  # numpy (..., H, W, C) -> torch (..., C, H, W)
    return t(np.moveaxis(np.asarray(x), -1, -3))


def _batch(b=B, f=F, h=H, seed=0):
    rs = np.random.RandomState(seed)
    img = factory.MICRO["clip"]["image_size"]
    return {
        "pixel_values": rs.uniform(-1, 1, (b, f, h, h, 3)).astype(np.float32),
        "pixel_values_pose": rs.uniform(-1, 1, (b, f, h, h, 3)).astype(np.float32),
        "pixel_values_ref_img": rs.uniform(-1, 1, (b, h, h, 3)).astype(np.float32),
        "clip_ref_image": rs.randn(b, img, img, 3).astype(np.float32),
    }


def _torch_batch(batch):
    return {k: t(v) for k, v in batch.items()}


def _jax_draws(rng, uncond_ratio, b=B, f=F, h=H):
    """The draws of the JAX loss_fn (train_step.py:189-219) from its key."""
    keys = jax.random.split(rng, 6)
    hl = h // 8
    f32 = jnp.float32
    return port_train.Draws(
        eps_target=nchw(jax.random.normal(keys[0], (b * f, hl, hl, 4), f32)),
        eps_ref=nchw(jax.random.normal(keys[1], (b, hl, hl, 4), f32)),
        uncond=torch.tensor(bool(jax.random.uniform(keys[2], ()) < uncond_ratio)),
        noise=nchw(jax.random.normal(keys[3], (b, f, hl, hl, 4), f32)),
        offset=nchw(jax.random.normal(keys[4], (b, 1, 1, 1, 4), f32)),
        t=t(jax.random.randint(keys[5], (b,), 0, 1000)).long(),
    )


def _seeded_draws(seed, b=B, f=F, h=H):
    gen = torch.Generator().manual_seed(seed)
    return port_train.Draws.sample(b, f, h // 8, h // 8, 0.0, 1000, gen)


def _micro(seed=0, **kw):
    """Micro stage-2 training models, float32, on the CPU."""
    return factory.build_training_models(
        "micro", "cpu", seed=seed, frozen_dtype=torch.float32, stage=2,
        scheduler_kwargs=Stage2Settings().scheduler_kwargs(), **kw)


class TemporalSpy:
    """Counts ``NatTemporal`` forwards (the K3 route; on the CPU its
    wrapper runs the plain version, which no launch counter sees)."""

    def __init__(self, monkeypatch):
        self.calls = 0
        forward = kernel_autograd.NatTemporal.forward

        def spy(ctx, *args):
            self.calls += 1
            return forward(ctx, *args)

        monkeypatch.setattr(kernel_autograd.NatTemporal, "forward", staticmethod(spy))


# --------------------------------------------------------- (a) stage-2 step
@pytest.fixture(scope="module")
def jax_stage2():
    """The JAX stage-2 step on the micro model with motion modules (the
    setup of tests/test_train_features.py), weights filled from a seed."""
    from aniportrait_tpu.train.train_step import (
        init_train_state, make_optimizer, make_train_step)

    defs = build_model_defs("micro", use_motion_module=True, dtype=jnp.float32,
                            scheduler_kwargs=Stage2Settings().scheduler_kwargs())
    vals = fill(_abstract_shapes(defs), seed=1)
    params = {"reference": vals["ref"]["params"], "denoising": vals["den"]["params"],
              "pose_guider": vals["pg"]["params"]}
    stats = vals["pg"]["batch_stats"]
    frozen = (vals["vae"]["params"], vals["clip"]["params"])
    tx = make_optimizer(params, stage=2)
    step = make_train_step(defs, tx, defs["scheduler"], uncond_ratio=0.0, donate=False,
                           stage=2)
    rng = jax.random.PRNGKey(11)
    with jax.default_matmul_precision("highest"):
        new_state, metrics = step(init_train_state(params, stats, tx), frozen, _batch(), rng)
    return dict(params=params, stats=stats, frozen=frozen, rng=rng, new_state=new_state,
                loss=float(metrics["loss"]))


def _load_jax_weights(m, ref):
    params, stats, frozen = ref["params"], ref["stats"], ref["frozen"]
    m.reference_unet.load_state_dict(from_jax.unet_from_jax(m.reference_unet,
                                                            params["reference"]))
    m.denoising_unet.load_state_dict(from_jax.unet_from_jax(m.denoising_unet,
                                                            params["denoising"]))
    m.pose_guider.load_state_dict(from_jax.pose_guider_from_jax(
        m.pose_guider, {"params": params["pose_guider"], "batch_stats": stats}))
    m.vae.load_state_dict(from_jax.vae_from_jax(m.vae, frozen[0]))
    m.clip.load_state_dict(from_jax.clip_from_jax(m.clip, frozen[1]))


def _denoising_as_port(m, tree, fallback):
    """The port's ``denoising_unet.*`` keys of a JAX denoising tree whose
    frozen leaves may be ``optax.MaskedNode`` (taken from ``fallback``)."""
    full = jax.tree.map(lambda x, p: p if isinstance(x, optax.MaskedNode) else x,
                        tree, fallback, is_leaf=lambda x: isinstance(x, optax.MaskedNode))
    return {f"denoising_unet.{k}": v
            for k, v in from_jax.unet_from_jax(m.denoising_unet, full).items()}


def test_stage2_step_matches_jax(jax_stage2, monkeypatch):
    ref = jax_stage2
    m = _micro()
    _load_jax_weights(m, ref)
    trainable = port_train.apply_freeze(m, stage=2)
    assert trainable and all(".motion_modules." in k and k.startswith("denoising_unet.")
                             for k in trainable)
    frozen_before = {f"{name}.{k}": p.detach().clone()
                     for name, model in m.models().items()
                     for k, p in model.named_parameters()
                     if f"{name}.{k}" not in trainable}
    init = {k: p.detach().clone() for k, p in trainable.items()}
    opt = port_train.make_optimizer(trainable)
    spy = TemporalSpy(monkeypatch)
    out = port_train.train_step(m, opt, _torch_batch(_batch()),
                                draws=_jax_draws(ref["rng"], 0.0), uncond_ratio=0.0)
    # 7 motion modules at micro size (down 0, 1; mid; up 0, 1 with 2 each),
    # two temporal attentions each
    assert spy.calls == 14

    np.testing.assert_allclose(float(out["loss"]), ref["loss"], rtol=LOSS_RTOL)
    new = ref["new_state"]
    mu = [s for s in jax.tree_util.tree_leaves(
        new.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(mu) == 1
    grads = jax.tree.map(lambda g: g if isinstance(g, optax.MaskedNode) else g / 0.1,
                         mu[0].mu["denoising"],
                         is_leaf=lambda x: isinstance(x, optax.MaskedNode))
    want_grads = _denoising_as_port(m, grads, ref["params"]["denoising"])
    want_params = _denoising_as_port(m, new.params["denoising"], ref["params"]["denoising"])
    grad_atol = GRAD_TOL * max(float(want_grads[k].abs().max()) for k in trainable)
    assert grad_atol > 0
    for key, p in trainable.items():
        w = want_grads[key].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, atol=grad_atol, rtol=0, err_msg=key)
        atol = np.where(np.abs(w) > grad_atol, PARAM_ATOL, 2 * LR + PARAM_ATOL)
        err = np.abs(p.detach().numpy() - want_params[key].numpy())
        assert (err <= atol).all(), (key, float((err - atol).max()))
        assert not torch.equal(p.detach(), init[key]), key
    named = {f"{name}.{k}": p for name, model in m.models().items()
             for k, p in model.named_parameters()}
    for key, before in frozen_before.items():
        assert torch.equal(named[key].detach(), before), key
    want_stats = from_jax.pose_guider_from_jax(
        m.pose_guider, {"params": ref["params"]["pose_guider"], "batch_stats": new.batch_stats})
    got = m.pose_guider.state_dict()
    stats = [k for k in want_stats if k.endswith(("running_mean", "running_var"))]
    assert stats
    for key in stats:
        np.testing.assert_allclose(got[key].numpy(), want_stats[key].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=key)


def _loss_and_grads(m, draws, batch):
    trainable = port_train.apply_freeze(m, stage=2)
    m.pose_guider.train()
    loss = port_train.loss_fn(m, batch, draws=draws, uncond_ratio=0.0)
    loss.backward()
    return float(loss), {k: p.grad.clone() for k, p in trainable.items()}


# ------------------------------------------------------- (b) freeze mask
def test_freeze_mask_stage2_full_size():
    """At full size, on the meta device: only the denoising UNet's motion
    modules train, as many elements as JAX ``_freeze_mask_stage2`` leaves
    trainable over the abstract parameters of ``build_model_defs``."""
    from aniportrait_tpu.train.train_step import _freeze_mask_stage2

    with torch.device("meta"):
        models = factory.make_models("full", True, factory.INFERENCE_V2_UNET)
    modules = factory.PipelineModules(scheduler=None, **models)
    mask = port_train.freeze_mask_stage2(modules)
    trained = {k for k, frozen in mask.items() if not frozen}
    assert trained and all(k.startswith("denoising_unet.") and ".motion_modules." in k
                           for k in trained)
    count = sum(p.numel() for model, module in models.items()
                for name, p in module.named_parameters() if f"{model}.{name}" in trained)

    from aniportrait_tpu.factory import SIZES, pose_feature_shapes

    defs = build_model_defs("full", use_motion_module=True)
    pose = [jnp.zeros(s) for s in pose_feature_shapes(SIZES["full"], 1, 1, 8)]
    den = jax.eval_shape(lambda k: defs["denoising_unet"].init(
        k, jnp.zeros((1, 1, 8, 8, 4)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 1, 768)),
        pose_cond_fea=pose), jax.random.PRNGKey(0))["params"]
    labels = _freeze_mask_stage2({"reference": {}, "denoising": den, "pose_guider": {}})
    want = sum(int(np.prod(leaf.shape)) for leaf, lbl in zip(
        jax.tree.leaves(den), jax.tree.leaves(labels["denoising"])) if lbl == "train")
    assert count == want, (count, want)
    assert 4e8 < count < 5e8, count


# ---------------------------------------------------------- (c) 8-bit AdamW
def test_adamw8bit_matches_jax():
    """Three steps on the same weights and gradients (one tensor not a
    whole number of 256-blocks): the int8 moments within one code, scales
    and weights to float32 rounding."""
    from aniportrait_tpu.train.optim8bit import adamw8bit

    rs = np.random.RandomState(4)
    shapes = {"a": (3, 200), "b": (256,), "c": (5, 7, 3)}
    params = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tx = adamw8bit(1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2)
    state = tx.init(params)
    update = jax.jit(lambda g, s, p: (lambda u, s: (optax.apply_updates(p, u), s))(
        *tx.update(g, s, p)))
    jp = dict(params)
    tp = {k: torch.nn.Parameter(t(v.copy())) for k, v in params.items()}
    opt = AdamW8bit(list(tp.values()), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                    weight_decay=1e-2, v_code="linear")
    for _ in range(3):
        grads = {k: (rs.randn(*s) * rs.choice([1e-3, 1.0])).astype(np.float32)
                 for k, s in shapes.items()}
        jp, state = update(grads, state, jp)
        for k, p in tp.items():
            p.grad = t(grads[k])
        opt.step()
        for k, p in tp.items():
            st = opt.state[p]
            for mom in ("m", "v"):
                qm = getattr(state, mom)[k]
                dq = np.abs(st[mom].numpy().astype(int) - np.asarray(qm.q).astype(int))
                assert dq.max() <= 1, (k, mom, dq.max())
                np.testing.assert_allclose(st[f"{mom}_scale"].numpy(), np.asarray(qm.scale),
                                           rtol=1e-6, atol=0)
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7)
    from aniportrait_tpu_torch.train.optim8bit import padded_len, state_bytes

    assert opt.state[tp["b"]]["m"].dtype == torch.int8
    padded = [padded_len(int(np.prod(s)), 256) for s in shapes.values()]
    # int8 m and v, a float32 scale each per block, a float32 step count
    assert state_bytes(opt) == sum(2 * n + 2 * 4 * (n // 256) + 4 for n in padded)


def _spread_probe(decades: int, v_code: str, steps: int = 200, n: int = 16384):
    """Largest single-element step, in lr, of ``AdamW8bit`` over ``steps``
    Gaussian gradients whose per-element scales are ``10 ** U(0, decades)``
    (lr 1e-5, no weight decay, seed 0)."""
    lr = 1e-5
    rs = np.random.RandomState(0)
    scales = 10.0 ** rs.uniform(0, decades, n)
    p = torch.nn.Parameter(torch.zeros(n))
    opt = AdamW8bit([p], lr=lr, weight_decay=0.0, v_code=v_code)
    largest = 0.0
    for _ in range(steps):
        p.grad = torch.from_numpy((rs.randn(n) * scales).astype(np.float32))
        before = p.detach().clone()
        opt.step()
        largest = max(largest, float((p.detach() - before).abs().max()) / lr)
    return largest, opt


@pytest.mark.parametrize("decades", [1, 2, 3, 4])
def test_adamw8bit_second_moment_keeps_small_v(decades):
    """F10: on the default log2 code no step exceeds 5 lr (float32 AdamW's
    largest is ~1 lr), and the state stays at ~2.03 B/parameter; on the
    linear code, at two decades, zeroed ``v`` codes give steps over 1000 lr."""
    from aniportrait_tpu_torch.train.optim8bit import state_bytes

    largest, opt = _spread_probe(decades, "log2")
    assert largest <= 5.0, largest
    assert opt.state[opt.param_groups[0]["params"][0]]["v"].dtype == torch.uint8
    assert state_bytes(opt) / 16384 <= 2.05
    if decades == 2:
        assert _spread_probe(decades, "linear")[0] > 1000.0


# ----------------------------------------------------- (d) accumulation
def test_gradient_accumulation_matches_multisteps():
    """k = 2: the weights do not move on the first micro-step; after the
    second they equal ``optax.MultiSteps`` over the JAX trainer's inner
    transformation (clip by global norm 1, AdamW 1e-5) given the two
    batches' gradients."""
    m = _micro(seed=5)
    f, h = 4, 32
    batches = [_torch_batch(_batch(f=f, h=h, seed=s)) for s in (5, 6)]
    draws = [_seeded_draws(s, f=f, h=h) for s in (5, 6)]
    grads = [_loss_and_grads(copy.deepcopy(m), d, b)[1] for d, b in zip(draws, batches)]

    trainable = port_train.apply_freeze(m, stage=2)
    before = {k: p.detach().clone() for k, p in trainable.items()}
    opt = port_train.make_optimizer(trainable)
    for micro in range(2):
        out = port_train.train_step(m, opt, batches[micro], draws=draws[micro],
                                    accumulation_steps=2, micro_step=micro,
                                    uncond_ratio=0.0)
        assert bool(out["stepped"]) == (micro == 1)
        if micro == 0:
            assert all(torch.equal(p.detach(), before[k]) for k, p in trainable.items())

    # the trainables as one flat vector: the same global norm and
    # elementwise AdamW, one leaf to compile
    tx = optax.MultiSteps(optax.chain(optax.clip_by_global_norm(1.0),
                                      optax.adamw(LR, b1=0.9, b2=0.999, eps=1e-8,
                                                  weight_decay=1e-2)),
                          every_k_schedule=2)
    flat = lambda d: np.concatenate([d[k].numpy().ravel() for k in trainable])
    params = flat(before)
    state = tx.init(params)
    update = jax.jit(lambda g, s, p: (lambda u, s: (optax.apply_updates(p, u), s))(
        *tx.update(g, s, p)))
    for g in grads:
        params, state = update(flat(g), state, params)
    mean = (flat(grads[0]) + flat(grads[1])) / 2
    tol = GRAD_TOL * np.abs(mean).max()
    atol = np.where(np.abs(mean) > tol, PARAM_ATOL, 2 * LR + PARAM_ATOL)
    err = np.abs(flat({k: p.detach() for k, p in trainable.items()}) - np.asarray(params))
    assert (err <= atol).all(), float((err - atol).max())
    moved = sum(not torch.equal(p.detach(), before[k]) for k, p in trainable.items())
    assert moved == len(trainable)


# -------------------------------------------------------------- (e) settings
def test_stage2_settings_defaults_equal_the_yaml():
    settings = Stage2Settings()
    assert settings.stage == 2 and settings.gradient_checkpointing
    assert settings_equal_the_yaml(settings, "configs/train/stage2.yaml") >= 15
    from aniportrait_tpu_torch.config import Config
    from aniportrait_tpu_torch.scripts.loader import inference_settings

    overrides, _, use_mm = inference_settings(Config(
        {"inference_config": str(ROOT / "configs/inference/inference_v2.yaml")}))
    assert use_mm and overrides == factory.INFERENCE_V2_UNET


