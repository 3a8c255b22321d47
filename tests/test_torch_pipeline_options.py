"""The port's long-clip pipeline options against the JAX pipeline at micro
size (the counterpart of tests/test_pipeline.py:97-247).

Both samplers start from the same numpy latents and the JAX encoder's
context, banks and pose features, 2 DDIM steps, CFG 3.5, context 4 with
overlap 2 and window batch 2 unless a test says otherwise.  Options whose
result is the exact path (encoder cache 1, non-overlapping fusion, fusion
over a clip within the motion PE, rotation at one step) are held to the
port's exact sampler; the approximations (encoder cache 2, fusion with
overlapping or wrapping windows, rotated tables) to the JAX sampler with
the same option.  Bounds as tests/test_torch_pipeline.py: final latents
1e-3 abs + 1e-3 rel; equal paths 1e-5.
"""

import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aniportrait_tpu.pipelines.interpolation import interpolate_latents as jax_interpolate
from aniportrait_tpu.pipelines.pose2vid import Pose2VideoPipeline as JaxPipeline
from aniportrait_tpu_torch.models.motion_module import split_windows
from aniportrait_tpu_torch.pipelines import Pose2VideoPipeline
from aniportrait_tpu_torch.pipelines.interpolation import interpolate_latents
from test_torch_pipeline import CFG, KW, RES, STEPS, build_modules
from test_torch_modules import one_thread  # noqa: F401 (autouse)

H = RES // 8


@pytest.fixture(scope="module")
def setup():
    """(JAX modules, port modules, inputs(length) -> (JAX args, port args))."""
    jm, pm = build_modules()
    jp = JaxPipeline(jm, **KW)
    cache = {}

    def inputs(length):
        if length not in cache:
            rs = np.random.RandomState(length)
            ref = rs.randint(0, 255, (RES, RES, 3), np.uint8)
            poses = [rs.randint(0, 255, (RES, RES, 3), np.uint8) for _ in range(length)]
            ref_u8, clip_u8, pose_u8 = jp.stage_inputs(ref, poses, RES, RES, device=False)
            with jax.default_matmul_precision("highest"):
                ctx, _, banks = jp._encode_ref_jit(
                    (jm.clip_params, jm.vae_params, jm.reference_params), ref_u8, clip_u8)
                pose = jp._pose_features_jit(jm.pose_guider_variables, pose_u8)
            lat0 = rs.randn(1, length, H, H, 4).astype(np.float32)
            port = (torch.from_numpy(lat0), torch.from_numpy(np.array(ctx)),
                    {k: torch.from_numpy(np.array(v)) for k, v in banks.items()},
                    [torch.from_numpy(np.asarray(p).transpose(0, 1, 4, 2, 3).copy())
                     for p in pose])
            cache[length] = ((jnp.asarray(lat0), ctx, banks, pose), port)
        return cache[length]

    return jm, pm, inputs


def run_port(pm, inputs, length, steps=STEPS, windowed=True, **opts):
    sampler = Pose2VideoPipeline(pm, **{**KW, **opts})._build_sampler(
        length, H, H, steps, CFG, windowed)
    return sampler(*inputs(length)[1]).numpy()


def run_jax(jm, inputs, length, steps=STEPS, **opts):
    with jax.default_matmul_precision("highest"):
        sampler = JaxPipeline(jm, **{**KW, **opts})._build_sampler(
            length, H, H, steps, CFG, True)
        return np.asarray(sampler(jm.denoising_params, *inputs(length)[0]))


def _close(port, ref, atol=1e-3, rtol=1e-3):
    np.testing.assert_allclose(port, ref, atol=atol, rtol=rtol)


def test_encoder_cache(setup):
    """Interval 1 is the exact sampler; interval 2 (down + mid refreshed at
    step 0, reused at step 1, one cache per window batch) meets JAX."""
    jm, pm, inputs = setup
    exact = run_port(pm, inputs, 6)
    _close(run_port(pm, inputs, 6, encoder_cache_interval=1), exact, 1e-5, 1e-5)
    cached = run_port(pm, inputs, 6, encoder_cache_interval=2)
    assert np.abs(cached - exact).max() > 1e-4  # step 1 reused stale features
    _close(cached, run_jax(jm, inputs, 6, encoder_cache_interval=2))


def test_window_fusion_exact_cases(setup):
    """Fusion over non-overlapping windows is the windowed computation; auto
    fusion of a clip within the motion PE is the whole-clip pass."""
    _, pm, inputs = setup
    exact = run_port(pm, inputs, 6, context_frames=3, context_overlap=0)
    fused = run_port(pm, inputs, 6, context_frames=3, context_overlap=0,
                     window_fusion=True, fusion_motion="context")
    _close(fused, exact, 1e-5, 1e-5)
    whole = run_port(pm, inputs, 6, windowed=False)
    _close(run_port(pm, inputs, 6, window_fusion=True), whole, 1e-5, 1e-5)


@pytest.mark.parametrize("motion", ["context", "wide"])
def test_window_fusion_matches_jax(setup, motion):
    """'context': the 16/4-style table with a window wrapping around the clip
    (the gather / scatter-add branch); 'wide': auto fusion past a motion PE
    of 4 frames, two contiguous windows overlapping by 2 (the slice branch)
    with the encoder cache on as well."""
    jm, pm, inputs = setup
    if motion == "context":
        opts = dict(window_fusion=True, fusion_motion="context")
        _close(run_port(pm, inputs, 6, **opts), run_jax(jm, inputs, 6, **opts))
        return
    opts = dict(window_fusion=True, encoder_cache_interval=2)
    pm.denoising_unet.motion_pe_max_len = 4
    object.__setattr__(jm.denoising_unet, "motion_pe_max_len", 4)
    try:
        _close(run_port(pm, inputs, 6, **opts), run_jax(jm, inputs, 6, **opts))
    finally:
        pm.denoising_unet.motion_pe_max_len = 32
        object.__setattr__(jm.denoising_unet, "motion_pe_max_len", 32)


def test_context_rotate(setup):
    """One step uses the step-0 table (the exact sampler); at two steps the
    rotated table of step 1 meets JAX."""
    jm, pm, inputs = setup
    _close(run_port(pm, inputs, 6, steps=1, context_rotate=True),
           run_port(pm, inputs, 6, steps=1), 1e-5, 1e-5)
    _close(run_port(pm, inputs, 6, context_rotate=True),
           run_jax(jm, inputs, 6, context_rotate=True))


@pytest.mark.parametrize("opts", [{}, dict(encoder_cache_interval=2),
                                  dict(context_rotate=True)],
                         ids=["exact", "encoder-cache", "rotate"])
def test_pose_features_gathered_per_window_batch(setup, monkeypatch, opts):
    """The windowed sampler (2 window batches of 2, 2 steps) gathers each
    batch's CFG-doubled pose features for the UNet calls of its step and
    keeps none past them, as the original streams them per window: when a
    UNet call starts, every pose tensor an earlier call was given is freed
    unless this call was given it too (the encoder cache's encode and decode
    of one batch), and each call's features are the clip's at the batch's
    frames, doubled for CFG."""
    _, pm, inputs = setup
    unet = pm.denoising_unet
    forward = unet.forward
    pose = inputs(6)[1][3]
    seen, calls = [], []

    def spy(*args, pose_cond_fea, **kw):
        alive = [r() for r in seen if r() is not None]
        assert all(any(a is p for p in pose_cond_fea) for a in alive)
        seen.extend(weakref.ref(p) for p in pose_cond_fea)
        for p, full in zip(pose_cond_fea, pose):
            rows = p.shape[0] // 2  # CFG halves, each the batch's frames
            assert torch.equal(p[:rows], p[rows:])
            hits = [(full[0].unsqueeze(0) == f.unsqueeze(1)).flatten(2).all(-1).any(-1)
                    for f in p[:rows]]
            assert all(bool(h.all()) for h in hits)
        calls.append(args[1][0].item())
        return forward(*args, pose_cond_fea=pose_cond_fea, **kw)

    monkeypatch.setattr(unet, "forward", spy)
    latents = run_port(pm, inputs, 6, **opts)
    assert len(set(calls)) == STEPS and len(calls) >= 2 * STEPS
    assert np.isfinite(latents).all()


@pytest.mark.parametrize("method", ["linear", "slerp"])
def test_interpolation_matches_jax(method):
    lat = np.random.RandomState(1).randn(1, 4, 3, 5, 4).astype(np.float32)
    lat[:, 2] = lat[:, 1] * 1.0001  # a near-parallel pair: slerp falls back to linear
    ref = np.asarray(jax_interpolate(jnp.asarray(lat), 3, method))
    got = interpolate_latents(torch.from_numpy(lat), 3, method).numpy()
    assert got.shape == ref.shape == (1, 10, 3, 5, 4)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-5)


def test_run_cases_and_staged_calls_equal_serial_calls(setup):
    """run_cases yields what serial __call__s return, in order, with per-case
    overrides; a staged call with return_device and an interpolated call
    agree with the plain call."""
    _, pm, _ = setup
    pipe = Pose2VideoPipeline(pm, **KW)
    rs = np.random.RandomState(3)
    kw = dict(num_inference_steps=STEPS, guidance_scale=CFG, seed=1, decode_chunk=2)
    cases = [dict(ref_image=rs.randint(0, 255, (70, 70, 3), np.uint8),
                  pose_images=[rs.randint(0, 255, (70, 70, 3), np.uint8)
                               for _ in range(n)],
                  key=f"case{i}", kw=dict(video_length=n))
             for i, n in enumerate((5, 3))]
    got = list(pipe.run_cases(cases, RES, RES, **kw))
    assert [k for k, _ in got] == ["case0", "case1"]
    for (_, video), c in zip(got, cases):
        serial = pipe(c["ref_image"], c["pose_images"], None, RES, RES, **c["kw"], **kw)
        np.testing.assert_array_equal(video, serial)

    c = cases[1]
    staged = pipe.stage_inputs(c["ref_image"], c["pose_images"], RES, RES)
    on_device = pipe(staged, None, None, RES, RES, return_device=True, **c["kw"], **kw)
    np.testing.assert_array_equal(on_device.numpy().astype(np.float32) / 255.0, got[1][1])
    interp = pipe(c["ref_image"], c["pose_images"], None, RES, RES,
                  interpolation_factor=2, **c["kw"], **kw)
    assert interp.shape == (5, RES, RES, 3)
    assert np.abs(interp[::2] - got[1][1]).max() <= 1 / 255  # decoded in other chunks


def test_motion_windows_must_cover_every_frame():
    with pytest.raises(ValueError, match="uncovered"):
        split_windows(torch.zeros(1, 5, 2, 3), np.array([[0, 1], [3, 4]]))


def test_build_pipeline_passes_the_options():
    from aniportrait_tpu_torch import factory

    opts = dict(window_fusion=True, fusion_motion="context", encoder_cache_interval=2,
                context_rotate=True)
    pipe = factory.build_pipeline("micro", "cpu", **opts)
    assert {k: getattr(pipe, k) for k in opts} == opts
    # a mesh no longer raises: a one-rank mesh (no process group) keeps the
    # window batch, which the JAX rounding leaves as it is on one device
    from aniportrait_tpu_torch.parallel import make_mesh

    meshed = Pose2VideoPipeline(pipe.m, mesh=make_mesh(), window_batch=3)
    assert meshed.mesh.size == 1 and meshed.window_batch == 3
