"""The port's multi-process sampler against the JAX pipeline's mesh paths.

The cases are tests/test_parallel.py's own (64x64, one DDIM step, CFG 3.5,
decode chunks of 2): the exact windowed path (6 frames, context 4 / overlap
2, window batch 4), window fusion (8 frames, the same table) and the
whole-clip single window (8 frames), at micro size with numpy-filled
weights.  JAX runs each with its 8-device mesh (tests/conftest.py's virtual
CPU devices); the port runs it in one process and at 2 ranks (the windowed
path: a share of each step's windows with both CFG halves; fused and single:
CFG split) and 4 ranks (CFG x 2 frame blocks, the motion modules exchanging
frames for positions), spawned over gloo without JAX
(``parallel.launch.spawn``).  Both sides start from JAX's initial noise.
Every rank's video equals the JAX mesh output and the port's single process
within 1.5/255 (tests/test_parallel.py's bound: a uint8 rounding flip), and
the ranks return the same video.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_ranks as ranks
from aniportrait_tpu.parallel.mesh import make_mesh as jax_mesh
from aniportrait_tpu.pipelines.pose2vid import Pose2VideoPipeline as JaxPipeline
from aniportrait_tpu_torch.parallel.launch import spawn
from test_torch_modules import one_thread  # noqa: F401 (autouse)
from test_torch_pipeline import build_modules, opencv_portable

VIDEO_ATOL = 1.5 / 255
CTX = dict(context_frames=4, context_overlap=2)
# name: (pipeline options, frames, input seed, noise seed, worlds)
CASES = {
    "windowed": (dict(CTX, window_batch=4), 6, 0, 3, (2, 4)),
    "fused": (dict(CTX, window_fusion=True), 8, 0, 3, (2, 4)),
    "single": ({}, 8, 2, 5, (2, 4)),
}


def _case(name):
    kw, length, input_seed, seed, _ = CASES[name]
    rs = np.random.RandomState(input_seed)
    ref = rs.randint(0, 255, (70, 70, 3), np.uint8)
    poses = [rs.randint(0, 255, (70, 70, 3), np.uint8) for _ in range(length)]
    return dict(name=name, kw=kw, ref=ref, poses=poses, seed=seed)


@pytest.fixture(scope="module")
def modules():
    return build_modules()


@pytest.fixture(scope="module")
def runs(modules, tmp_path_factory):
    jm, pm = modules
    mesh = jax_mesh(8)
    cases, jax_videos = [], {}
    for name in CASES:
        c = _case(name)
        h = ranks.RES // 8
        with opencv_portable(), mesh:
            jax_videos[name] = JaxPipeline(jm, mesh=mesh, **c["kw"])(
                c["ref"], c["poses"], None, width=ranks.RES, height=ranks.RES,
                video_length=len(c["poses"]), num_inference_steps=1,
                guidance_scale=3.5, seed=c["seed"], decode_chunk=2)
        noise = jax.random.normal(jax.random.PRNGKey(c["seed"]),
                                  (1, len(c["poses"]), h, h, 4), jnp.float32)
        c["latents"] = np.asarray(noise * jm.scheduler.init_noise_sigma)
        cases.append(c)
    path = tmp_path_factory.mktemp("weights") / "micro.pt"
    torch.save({k: m.state_dict() for k, m in pm.models().items()}, path)
    single = ranks.pipeline_cases(None, str(path), cases)
    multi = {w: spawn(ranks.pipeline_cases, w, args=(str(path), cases), timeout=600)
             for w in (2, 4)}
    return jax_videos, single, multi


def test_port_single_process_equals_jax_mesh(runs):
    jax_videos, single, _ = runs
    for name in CASES:
        np.testing.assert_allclose(single[name], jax_videos[name], atol=VIDEO_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_sampler_equals_jax_mesh_and_one_process(runs, name, world):
    jax_videos, single, multi = runs
    assert world in CASES[name][4]
    videos = [r[name] for r in multi[world]]
    assert videos[0].shape == jax_videos[name].shape
    for rank, v in enumerate(videos):
        np.testing.assert_array_equal(v, videos[0], err_msg=f"rank {rank}")
    np.testing.assert_allclose(videos[0], jax_videos[name], atol=VIDEO_ATOL)
    np.testing.assert_allclose(videos[0], single[name], atol=VIDEO_ATOL)


@pytest.mark.parametrize("devices,window_batch", [(2, 3), (3, 2), (4, 3), (4, 4),
                                                  (8, 3), (8, 5)])
def test_mesh_window_batch_rounds_as_jax(modules, devices, window_batch):
    """``2 * window_batch`` divides the ranks after the JAX pipeline's
    rounding (``aniportrait_tpu/pipelines/pose2vid.py:164-167``)."""
    from aniportrait_tpu_torch.pipelines.pose2vid import mesh_window_batch

    jm, _ = modules
    want = JaxPipeline(jm, mesh=jax_mesh(devices), window_batch=window_batch).window_batch
    assert mesh_window_batch(window_batch, devices) == want
