"""Port modules (aniportrait_tpu_torch/models, schedulers) against their JAX
counterparts.

Each test fills the JAX module's parameters from a numpy seed, converts them
with aniportrait_tpu_torch/weights/from_jax.py, and runs both on the same
numpy inputs: JAX at highest matmul precision, the port in float32 on the
CPU.  Blocks are held to 2e-4 abs (as tests/test_parity_diffusion.py holds
the JAX package to its torch oracles); whole models state their bound.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aniportrait_tpu.factory import MICRO, pose_feature_shapes
from aniportrait_tpu.weights import convert as cv
from aniportrait_tpu_torch.weights import from_jax

BLOCK_ATOL, BLOCK_RTOL = 2e-4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's tests run many small torch ops on the CPU.  With one
    intra-op thread an op does not wait at the thread pool's barriers, which
    a CPU shared with other test processes stretches many times over (a
    micro stage-2 step ran 20-40x slower with 8 threads in a six-process
    pytest run of the whole suite than alone).  Each module that imports
    this fixture runs under it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fill(tree, seed=0):
    """numpy parameters for an eval_shape tree: weights ~ N(0, 1/fan_in) so
    activations stay O(1) (attention logits are then not flat), norm scales
    and BatchNorm variances near 1, biases and means small."""
    rs = np.random.RandomState(seed)

    def leaf(path, x):
        name = str(path[-1].key)
        shape = x.shape
        if name.endswith("scale") or name == "var":
            return (1.0 + 0.1 * np.abs(rs.randn(*shape))).astype(np.float32)
        if name.endswith("bias") or name == "mean":
            return (0.1 * rs.randn(*shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        std = fan_in ** -0.5 if len(shape) > 1 and name == "kernel" else 0.5
        return (std * rs.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def init_jax(module, *args, seed=0, **kw):
    shapes = jax.eval_shape(lambda k: module.init(k, *args, **kw), jax.random.PRNGKey(0))
    return fill(shapes, seed)


def run_jax(module, variables, *args, **kw):
    with jax.default_matmul_precision("highest"):
        return jax.jit(lambda v, *a: module.apply(v, *a, **kw))(variables, *args)


def holder(name, module):
    h = torch.nn.Module()
    setattr(h, name, module)
    return h.eval()


def t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def fold_nchw(x):  # numpy (b, f, h, w, c) -> torch (b * f, c, h, w)
    b, f, h, w, c = x.shape
    return t(x.reshape(b * f, h, w, c).transpose(0, 3, 1, 2))


def unfold_nhwc(x, b):  # torch (b * f, c, h, w) -> numpy (b, f, h, w, c)
    bf, c, h, w = x.shape
    return x.numpy().transpose(0, 2, 3, 1).reshape(b, bf // b, h, w, c)


def bfchw(x):  # numpy (b, f, h, w, c) -> torch (b, f, c, h, w)
    return t(np.asarray(x).transpose(0, 1, 4, 2, 3))


def close(port, ref, atol=BLOCK_ATOL, rtol=BLOCK_RTOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol, rtol=rtol)


@torch.no_grad()
def test_resnet_block_parity():
    from aniportrait_tpu.models.resnet import ResnetBlock3D as JaxResnet
    from aniportrait_tpu_torch.models.resnet import ResnetBlock3D

    rs = np.random.RandomState(0)
    x = rs.randn(1, 2, 8, 8, 32).astype(np.float32)
    temb = rs.randn(1, 128).astype(np.float32)
    jm = JaxResnet(out_channels=64)
    params = init_jax(jm, x, temb)
    ref = run_jax(jm, params, x, temb)
    port = holder("r", ResnetBlock3D(32, 64, 128))
    port.load_state_dict(from_jax.state_dict_from_jax(
        port, cv._resnet_rules("r", "r"), {"r": params["params"]}))
    out = port.r(fold_nchw(x), t(temb), video_length=2)
    close(unfold_nhwc(out, 1), ref)


def _spatial_pair(c=64, heads=4, ctx_dim=16):
    from aniportrait_tpu.models.transformer_spatial import SpatialTransformer as Jax
    from aniportrait_tpu_torch.models.transformer_spatial import SpatialTransformer

    jm = Jax(channels=c, heads=heads, cross_attention_dim=ctx_dim)
    return jm, holder("st", SpatialTransformer(c, heads, ctx_dim))


def _load_spatial(port, params):
    port.load_state_dict(from_jax.state_dict_from_jax(
        port, cv._attention_block_rules("st", "st"), {"st": params["params"]}))


@torch.no_grad()
def test_spatial_transformer_write_parity():
    """ReferenceNet role: output and the captured bank (post-norm1)."""
    rs = np.random.RandomState(1)
    x = rs.randn(2, 1, 8, 8, 64).astype(np.float32)
    ctx = rs.randn(2, 1, 16).astype(np.float32)
    jm, port = _spatial_pair()
    params = init_jax(jm, x, ctx, capture_bank=True)
    ref, ref_banks = run_jax(jm, params, x, ctx, capture_bank=True)
    _load_spatial(port, params)
    out, banks = port.st(fold_nchw(x), 1, t(ctx), capture_bank=True)
    close(unfold_nhwc(out, 2), ref)
    close(banks[0], ref_banks[0])


@torch.no_grad()
@pytest.mark.parametrize("drop_mode", ["none", "first_half"])
def test_spatial_transformer_read_parity(drop_mode):
    """Denoising role: frames attend to themselves plus the reference bank;
    with first_half the first half of the rows (CFG uncond) skip the bank."""
    rs = np.random.RandomState(2)
    b, f = 2, 3
    x = rs.randn(b, f, 8, 8, 64).astype(np.float32)
    ctx = rs.randn(b, 1, 16).astype(np.float32)
    bank = rs.randn(b, 64, 64).astype(np.float32)
    jm, port = _spatial_pair()
    params = init_jax(jm, x, ctx, ref_bank=bank, drop_mode=drop_mode)
    ref, _ = run_jax(jm, params, x, ctx, ref_bank=bank, drop_mode=drop_mode)
    _load_spatial(port, params)
    out, _ = port.st(fold_nchw(x), f, t(ctx), ref_bank=t(bank), drop_mode=drop_mode)
    close(unfold_nhwc(out, b), ref)


@torch.no_grad()
def test_motion_module_parity():
    from aniportrait_tpu.models.motion_module import MotionModule as Jax
    from aniportrait_tpu_torch.models.motion_module import MotionModule

    rs = np.random.RandomState(3)
    x = rs.randn(2, 6, 4, 4, 64).astype(np.float32)
    jm = Jax(channels=64, heads=8)
    params = init_jax(jm, x)
    ref = run_jax(jm, params, x)
    port = holder("mm", MotionModule(64, heads=8))
    port.load_state_dict(from_jax.state_dict_from_jax(
        port, cv._motion_rules("mm", "mm"), {"mm": params["params"]}))
    close(unfold_nhwc(port.mm(fold_nchw(x), 6), 2), ref)


@torch.no_grad()
def test_pose_guider_transformer_parity():
    """16-head x 88 PoseGuider transformer (the K4 path at full size)."""
    from aniportrait_tpu.models.pose_guider import PoseGuiderTransformer as Jax
    from aniportrait_tpu_torch.models.pose_guider import PoseGuiderTransformer

    rs = np.random.RandomState(4)
    x = rs.randn(2, 4, 4, 64).astype(np.float32)
    jm = Jax(channels=64, heads=16, dim_head=88)
    params = init_jax(jm, x)
    ref = run_jax(jm, params, x)
    port = holder("cross_attn1", PoseGuiderTransformer(64, 16, 88))
    rules = [r for r in cv.pose_guider_rules() if "cross_attn1" in r[0]]
    port.load_state_dict(from_jax.state_dict_from_jax(
        port, rules, {"cross_attn_1": params["params"]}))
    out = port.cross_attn1(t(x.transpose(0, 3, 1, 2)))
    close(out.numpy().transpose(0, 2, 3, 1), ref)


# ------------------------------------------------------------ whole models
@torch.no_grad()
def test_pose_guider_parity():
    """Whole micro PoseGuider (stem, BatchNorm in eval, pyramid,
    transformers): 1e-3, since the stem's 11 conv+BN layers compound
    float32 rounding differences between XLA and ATen convolutions."""
    from aniportrait_tpu.models.pose_guider import PoseGuider as Jax
    from aniportrait_tpu_torch.models.pose_guider import PoseGuider

    rs = np.random.RandomState(5)
    pose = rs.uniform(-1, 1, (1, 2, 64, 64, 3)).astype(np.float32)
    jm = Jax(**MICRO["pose_guider"])
    variables = init_jax(jm, pose)
    ref = run_jax(jm, variables, pose)
    port = PoseGuider(**MICRO["pose_guider"]).eval()
    port.load_state_dict(from_jax.pose_guider_from_jax(port, variables))
    outs = port(bfchw(pose))
    assert len(outs) == len(ref)
    for o, r in zip(outs, ref):
        close(o.numpy().transpose(0, 1, 3, 4, 2), r, atol=1e-3, rtol=1e-3)


def _micro_unet_inputs(rs, b, f, hl=8):
    x = rs.randn(b, f, hl, hl, 4).astype(np.float32)
    ts = np.full((b,), 500, np.int32)
    ctx = rs.randn(b, 1, MICRO["unet"]["cross_attention_dim"]).astype(np.float32)
    return x, ts, ctx


@torch.no_grad()
def test_reference_unet_banks_parity():
    """Micro ReferenceNet: every captured bank, (B, L, C) tokens.  Bound
    1e-3: banks deep in the UNet follow ~10 conv/attention layers."""
    from aniportrait_tpu.models.unet import AniUNet as Jax
    from aniportrait_tpu_torch.models.unet import AniUNet

    rs = np.random.RandomState(6)
    x, ts, ctx = _micro_unet_inputs(rs, 2, 1)
    kw = dict(**MICRO["unet"], use_motion_module=False, has_output_head=False)
    jm = Jax(**kw)
    params = init_jax(jm, x, ts, ctx, capture_banks=True)
    _, ref = run_jax(jm, params, x, ts, ctx, capture_banks=True)
    port = AniUNet(**kw).eval()
    port.load_state_dict(from_jax.unet_from_jax(port, params["params"]))
    _, banks = port(bfchw(x), t(ts).long(), t(ctx), capture_banks=True)
    assert sorted(banks) == sorted(ref)
    for key in ref:
        close(banks[key], ref[key], atol=1e-3, rtol=1e-3)


@torch.no_grad()
def test_denoising_unet_first_half_parity():
    """Micro denoising UNet with pose features, banks, motion modules and
    the CFG first_half layout.  Bound 1e-3 (whole network, see above)."""
    from aniportrait_tpu.models.unet import AniUNet as Jax
    from aniportrait_tpu_torch.models.unet import AniUNet

    rs = np.random.RandomState(7)
    b, f, hl = 2, 3, 8
    x, ts, ctx = _micro_unet_inputs(rs, b, f, hl)
    pose = [rs.randn(*s).astype(np.float32) for s in pose_feature_shapes(MICRO, b, f, hl)]
    ch = MICRO["unet"]["block_out_channels"]
    banks = {"down_0_0": rs.randn(b, 64, ch[0]).astype(np.float32),
             "mid_0": rs.randn(b, 16, ch[1]).astype(np.float32),
             "up_1_0": rs.randn(b, 64, ch[0]).astype(np.float32),
             "up_1_1": rs.randn(b, 64, ch[0]).astype(np.float32)}
    kw = dict(**MICRO["unet"], use_motion_module=True)
    jm = Jax(**kw)
    params = init_jax(jm, x, ts, ctx, pose_cond_fea=pose)
    ref, _ = run_jax(jm, params, x, ts, ctx, pose_cond_fea=pose, ref_banks=banks,
                     drop_mode="first_half")
    port = AniUNet(**kw).eval()
    port.load_state_dict(from_jax.unet_from_jax(port, params["params"]))
    out, _ = port(bfchw(x), t(ts).long(), t(ctx), pose_cond_fea=[bfchw(p) for p in pose],
                  ref_banks={k: t(v) for k, v in banks.items()}, drop_mode="first_half")
    close(out.numpy().transpose(0, 1, 3, 4, 2), ref, atol=1e-3, rtol=1e-3)


@torch.no_grad()
def test_vae_encode_decode_parity():
    """Micro VAE encode (mean) and decode.  Bound 1e-3: 20+ conv layers."""
    from aniportrait_tpu.models.vae import AutoencoderKL as Jax
    from aniportrait_tpu_torch.models.vae import AutoencoderKL

    rs = np.random.RandomState(8)
    img = rs.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    z = rs.randn(2, 4, 4, 4).astype(np.float32)
    jm = Jax(**MICRO["vae"])
    params = init_jax(jm, img)
    mean, _ = run_jax(jm, params, img, method=jm.encode)
    dec = run_jax(jm, params, z, method=jm.decode)
    port = AutoencoderKL(**MICRO["vae"]).eval()
    port.load_state_dict(from_jax.vae_from_jax(port, params["params"]))
    close(port.encode(t(img.transpose(0, 3, 1, 2)))[0].numpy().transpose(0, 2, 3, 1),
          mean, atol=1e-3, rtol=1e-3)
    close(port.decode(t(z.transpose(0, 3, 1, 2))).numpy().transpose(0, 2, 3, 1),
          dec, atol=1e-3, rtol=1e-3)


@torch.no_grad()
def test_clip_parity():
    """Tiny CLIP (2 layers, 224 px, 785 tokens): image embeddings, 2e-4."""
    from aniportrait_tpu.factory import TINY
    from aniportrait_tpu.models.clip_vision import CLIPVisionModelWithProjection as Jax
    from aniportrait_tpu_torch.models.clip_vision import CLIPVisionModelWithProjection

    rs = np.random.RandomState(9)
    img = rs.randn(2, 224, 224, 3).astype(np.float32)
    jm = Jax(**TINY["clip"])
    params = init_jax(jm, img)
    ref = run_jax(jm, params, img)
    port = CLIPVisionModelWithProjection(**TINY["clip"]).eval()
    port.load_state_dict(from_jax.clip_from_jax(port, params["params"]))
    close(port(t(img.transpose(0, 3, 1, 2))), ref)


def test_ddim_step_parity_every_timestep():
    """One DDIM step from every timestep of the 25-step trailing schedule
    (v-prediction, zero-terminal-SNR): 1e-5 on O(1) latents."""
    from aniportrait_tpu.factory import INFERENCE_SCHEDULER
    from aniportrait_tpu.schedulers import DDIMScheduler as Jax
    from aniportrait_tpu_torch.schedulers import DDIMScheduler

    js, ps = Jax(**INFERENCE_SCHEDULER), DDIMScheduler(**INFERENCE_SCHEDULER)
    np.testing.assert_array_equal(js.timesteps(25), ps.timesteps(25))
    np.testing.assert_allclose(np.asarray(js.alphas_cumprod), ps.alphas_cumprod, atol=1e-7)
    rs = np.random.RandomState(10)
    for step in ps.timesteps(25):
        out = rs.randn(1, 3, 4, 8, 8).astype(np.float32)
        x = rs.randn(1, 3, 4, 8, 8).astype(np.float32)
        ref = js.step(jnp.asarray(out), jnp.int32(step), jnp.asarray(x), 25)
        got = ps.step(t(out), int(step), t(x), 25)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
