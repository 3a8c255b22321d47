"""(d) The port's pose2vid slice against the JAX pipeline at micro size.

Both pipelines hold the same numpy-filled weights (the port's through
weights/from_jax.py) and meet at each seam of the JAX method split:
stage_inputs, _encode_reference, _pose_features, the sampler of
_build_sampler (2 DDIM steps, CFG 3.5, from the same numpy latents) and
_decode.  Covered: the whole-clip single window and overlapping windows
(L=6, context 4, overlap 2, window batch 2: three windows, one wrapping
around, padded to four).

Bounds: host resizes equal (the port's numpy INTER_CUBIC against OpenCV's
portable code, IPP off); encoder outputs 1e-3; final latents 1e-3 abs +
1e-3 rel (two float32 UNet passes with CFG 3.5 amplifying the difference);
uint8 frames decoded from the same latents differ by at most 1 level (a
rounding flip).
"""

import contextlib

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aniportrait_tpu.factory import _abstract_shapes, build_model_defs
from aniportrait_tpu.pipelines.pose2vid import PipelineModules as JaxModules
from aniportrait_tpu.pipelines.pose2vid import Pose2VideoPipeline as JaxPipeline
from aniportrait_tpu_torch import factory
from aniportrait_tpu_torch.pipelines import Pose2ImagePipeline, Pose2VideoPipeline
from aniportrait_tpu_torch.utils.image import resize
from aniportrait_tpu_torch.weights import from_jax

KW = dict(context_frames=4, context_overlap=2, window_batch=2)
RES, STEPS, CFG = 64, 2, 3.5


def fill(tree, seed=0):
    """numpy weights ~ N(0, 1/fan_in) for kernels; norms near 1."""
    rs = np.random.RandomState(seed)

    def leaf(path, x):
        name, shape = str(path[-1].key), x.shape
        if name.endswith("scale") or name == "var":
            return (1.0 + 0.1 * np.abs(rs.randn(*shape))).astype(np.float32)
        if name.endswith("bias") or name == "mean":
            return (0.1 * rs.randn(*shape)).astype(np.float32)
        if name == "kernel":
            return (rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        return (0.5 * rs.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def build_modules():
    """The micro JAX modules with numpy-filled weights and the port's
    modules holding the same weights."""
    defs = build_model_defs("micro", use_motion_module=True)
    vals = fill(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), _abstract_shapes(defs)))
    jm = JaxModules(
        vae=defs["vae"], vae_params=vals["vae"]["params"],
        clip=defs["clip"], clip_params=vals["clip"]["params"],
        reference_unet=defs["reference_unet"], reference_params=vals["ref"]["params"],
        denoising_unet=defs["denoising_unet"], denoising_params=vals["den"]["params"],
        pose_guider=defs["pose_guider"], pose_guider_variables=vals["pg"],
        scheduler=defs["scheduler"],
    )
    pm = factory.build_models("micro", "cpu", torch.float32)
    for model, state in (
        (pm.vae, from_jax.vae_from_jax(pm.vae, jm.vae_params)),
        (pm.clip, from_jax.clip_from_jax(pm.clip, jm.clip_params)),
        (pm.reference_unet, from_jax.unet_from_jax(pm.reference_unet, jm.reference_params)),
        (pm.denoising_unet, from_jax.unet_from_jax(pm.denoising_unet, jm.denoising_params)),
        (pm.pose_guider, from_jax.pose_guider_from_jax(pm.pose_guider,
                                                       jm.pose_guider_variables)),
    ):
        model.load_state_dict(state)
    return jm, pm


@pytest.fixture(scope="module")
def pipes():
    jm, pm = build_modules()
    return JaxPipeline(jm, **KW), Pose2VideoPipeline(pm, **KW)


@contextlib.contextmanager
def opencv_portable():
    """OpenCV with its IPP acceleration off: IPP's INTER_CUBIC bytes depend
    on the CPU code path it dispatches to; the portable code's do not."""
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        yield
    finally:
        cv2.ipp.setUseIPP(was)


# (source H, W) -> (width, height): the pipeline's ratios (test inputs,
# portrait requests from square and 720p sources, the CLIP image)
RESIZES = [((70, 70), (64, 64)), ((512, 512), (576, 768)), ((720, 1280), (576, 768)),
           ((1280, 720), (576, 768)), ((512, 512), (224, 224)), ((64, 64), (224, 224))]


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_matches_opencv_bytes(src, dst):
    """utils.image.resize gives the bytes of OpenCV's INTER_CUBIC on noise,
    on a smooth image and on a black-and-white one (the extremes saturate)."""
    rs = np.random.RandomState(src[0] + dst[1])
    yy, xx = np.mgrid[0:src[0], 0:src[1]]
    images = [rs.randint(0, 256, (*src, 3)).astype(np.uint8),
              np.stack([127 + 120 * np.sin(xx / 7.0 + c) * np.cos(yy / 5.0)
                        for c in range(3)], -1).astype(np.uint8),
              (255 * rs.randint(0, 2, (*src, 3))).astype(np.uint8)]
    for img in images:
        with opencv_portable():
            ref = cv2.resize(img, dst, interpolation=cv2.INTER_CUBIC)
        np.testing.assert_array_equal(resize(img, *dst), ref)


def _close(port, ref, atol=1e-3, rtol=1e-3):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol, rtol=rtol)


@pytest.mark.parametrize("length", [4, 6], ids=["single_window", "three_windows"])
def test_pose2vid_slice_matches_jax(pipes, length):
    jp, pp = pipes
    m = jp.m
    rs = np.random.RandomState(length)
    ref = rs.randint(0, 255, (70, 70, 3), np.uint8)
    poses = [rs.randint(0, 255, (70, 70, 3), np.uint8) for _ in range(length)]

    with opencv_portable():
        staged_j = jp.stage_inputs(ref, poses, RES, RES, device=False)
    staged_p = pp.stage_inputs(ref, poses, RES, RES, device=False)
    for a, b in zip(staged_p, staged_j):
        np.testing.assert_array_equal(a, b)
    ref_u8, clip_u8, pose_u8 = staged_j  # both sides go on from the same pixels

    with jax.default_matmul_precision("highest"):
        ctx_j, lat_j, banks_j = jp._encode_ref_jit(
            (m.clip_params, m.vae_params, m.reference_params), ref_u8, clip_u8)
        pose_j = jp._pose_features_jit(m.pose_guider_variables, pose_u8)
    with torch.no_grad():
        ctx_p, lat_p, banks_p = pp._encode_reference(torch.from_numpy(ref_u8),
                                                     torch.from_numpy(clip_u8))
        pose_p = pp._pose_features(torch.from_numpy(pose_u8))
    _close(ctx_p, ctx_j)
    _close(lat_p, lat_j)
    assert sorted(banks_p) == sorted(banks_j)
    for key in banks_j:
        _close(banks_p[key], banks_j[key])
    for a, b in zip(pose_p, pose_j):
        _close(a.numpy().transpose(0, 1, 3, 4, 2), b)

    lat0 = rs.randn(1, length, RES // 8, RES // 8, 4).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        sampler = jp._build_sampler(length, RES // 8, RES // 8, STEPS, CFG, True)
        out_j = np.asarray(sampler(m.denoising_params, jnp.asarray(lat0), ctx_j,
                                   banks_j, pose_j))
    out_p = pp._build_sampler(length, RES // 8, RES // 8, STEPS, CFG, True)(
        torch.from_numpy(lat0), ctx_p, banks_p, pose_p)
    assert np.isfinite(out_j).all() and np.abs(out_j - lat0).max() > 0.1
    _close(out_p, out_j)

    with jax.default_matmul_precision("highest"):
        video_j = jp._decode(jnp.asarray(out_j), decode_chunk=4, to_host=True)
    with torch.no_grad():
        video_p = pp._decode(torch.from_numpy(out_j.copy()), decode_chunk=4).numpy()
    assert video_p.shape == video_j.shape == (length, RES, RES, 3)
    assert np.abs(video_p.astype(int) - video_j.astype(int)).max() <= 1


def test_port_call_seeded_and_pose2img(pipes):
    """__call__ end to end: the seed fixes the video, another seed changes
    it; Pose2ImagePipeline returns one frame."""
    _, pp = pipes
    rs = np.random.RandomState(9)
    ref = rs.randint(0, 255, (64, 64, 3), np.uint8)
    poses = [rs.randint(0, 255, (64, 64, 3), np.uint8) for _ in range(3)]
    kw = dict(width=RES, height=RES, video_length=3, num_inference_steps=STEPS, seed=7)
    v1, v2 = pp(ref, poses, None, **kw), pp(ref, poses, None, **kw)
    assert v1.shape == (3, RES, RES, 3) and v1.dtype == np.float32
    assert 0.0 <= v1.min() and v1.max() <= 1.0
    np.testing.assert_array_equal(v1, v2)
    assert not np.array_equal(v1, pp(ref, poses, None, **{**kw, "seed": 8}))
    img = Pose2ImagePipeline(pp.m)(ref, poses[0], RES, RES, num_inference_steps=STEPS)
    assert img.shape == (RES, RES, 3)
