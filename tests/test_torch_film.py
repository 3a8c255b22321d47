"""The port's FiLM frame interpolation (``-acc``) against the JAX package's,
on the CPU.

FiLM: ``models/film_net.py`` against JAX ``FilmInterpolator`` at
tests/test_film.py's ``SMALL`` config, the JAX parameters (flax init plus
seeded noise) carried into the port by ``weights/from_jax.py:film_from_jax``;
float32, JAX at the highest matmul precision, within test_film.py's 5e-4 /
1e-3, at dt 0.5 and asymmetric dt.  ``warp`` on a bf16 image samples at
float32 coordinates as the JAX gather and lerp does (one bf16 step).  The
loader (``utils/frame_interpolation.py:_load_film``) reads a traced and saved
TorchScript blob and an ``.npz`` of flax paths.  Subdivision: batched rounds
equal the sequential order and the JAX tool's output; a uint8 clip as a
tensor (the pipeline's device output) equals the host path to uint8
quantisation.  ``-acc`` through ``pose2vid.main`` meets the JAX CLI's frame
count and grids with a small float32 FiLM patched into both loaders (the
JAX CLIs' no-weights fallback fails, ROADMAP F11), ``pose2vid.generate``
runs FiLM and the cross-fade on the pipeline's uint8 tensor, and vid2vid's
``-acc`` (whose JAX CLI raises) strides the source's landmarks.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aniportrait_tpu.models import film_net as jax_film
from aniportrait_tpu.utils import frame_interpolation as jax_fi
from aniportrait_tpu.weights.convert import convert_film
from aniportrait_tpu_torch.models import film_net as port_film
from aniportrait_tpu_torch.pipelines import Pose2VideoPipeline
from aniportrait_tpu_torch.scripts import pose2vid as port_pose2vid
from aniportrait_tpu_torch.scripts import vid2vid as port_vid2vid
from aniportrait_tpu_torch.utils import frame_interpolation as port_fi
from aniportrait_tpu_torch.weights import from_jax
from scripts import pose2vid as jax_pose2vid
from test_torch_cli import RES, _compare, faces, inputs, modules, run_main  # noqa: F401
from test_torch_modules import one_thread  # noqa: F401 (autouse)

SMALL = dict(pyramid_levels=4, fusion_pyramid_levels=3, specialized_levels=2,
             sub_levels=3, filters=8, flow_convs=(2, 2, 2), flow_filters=(8, 8, 16))
ATOL, RTOL = 5e-4, 1e-3  # tests/test_film.py


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


def jax_params(seed, x0, x1):
    """JAX FiLM parameters: flax init, plus seeded N(0, 0.1) noise so that
    no bias is zero."""
    model = jax_film.FilmInterpolator(**SMALL)
    params = model.init(jax.random.PRNGKey(seed), jnp.asarray(x0), jnp.asarray(x1),
                        jnp.full((x0.shape[0],), 0.5))["params"]
    rs = np.random.RandomState(seed)
    return model, jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rs.randn(*a.shape).astype(np.float32), params)


@pytest.mark.parametrize("dts", [(0.5, 0.5), (0.25, 0.75)], ids=["half", "asymmetric"])
def test_film_matches_jax(dts):
    rs = np.random.RandomState(0)
    x0 = rs.rand(2, 32, 32, 3).astype(np.float32)
    x1 = rs.rand(2, 32, 32, 3).astype(np.float32)
    dt = np.asarray(dts, np.float32)
    jm, params = jax_params(0, x0, x1)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm.apply({"params": params}, jnp.asarray(x0), jnp.asarray(x1), dt))
    pm = port_film.FilmInterpolator(**SMALL).eval()
    pm.load_state_dict(from_jax.film_from_jax(pm, params), strict=True)
    with torch.no_grad():
        got = nhwc(pm(nchw(x0), nchw(x1), torch.from_numpy(dt)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # the two time steps of one batch differ (t against 1 - t)
    assert dts[0] == dts[1] or np.abs(got[0] - got[1]).max() > 1e-3


def test_film_rejects_sizes_the_pyramid_cannot_halve():
    pm = port_film.FilmInterpolator(**SMALL)
    with pytest.raises(ValueError, match="divisible by 8"):
        pm(torch.zeros(1, 3, 36, 32), torch.zeros(1, 3, 36, 32), 0.5)


def test_bf16_warp_samples_at_float32_coordinates():
    """A 512-wide bf16 image warped by flows of a few pixels: the port's
    ``warp`` equals the JAX one (float32 coordinates, float32 lerp of the
    bf16 neighbours) to one bf16 step, where a bf16 grid would be pixels
    off."""
    rs = np.random.RandomState(3)
    img = rs.rand(1, 8, 512, 3).astype(np.float32)
    flow = (rs.randn(1, 8, 512, 2) * 4).astype(np.float32)
    want = np.asarray(jax_film.warp(jnp.asarray(img, jnp.bfloat16), jnp.asarray(flow)),
                      np.float32)
    got = port_film.warp(nchw(img).to(torch.bfloat16), nchw(flow))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(nhwc(got.float()), want, atol=2 ** -8, rtol=0)
    # the float32 warp of the same image is within bf16 rounding of it
    ref = port_film.warp(nchw(img).to(torch.bfloat16).float(), nchw(flow))
    np.testing.assert_allclose(nhwc(got.float()), nhwc(ref), atol=2 ** -8, rtol=0)


# ------------------------------------------------------------------ loader
@pytest.fixture(scope="module")
def film():
    """A full-size port FiLM with seeded weights, and a 64x64 pair."""
    rs = np.random.RandomState(4)
    pair = [rs.rand(2, 64, 64, 3).astype(np.float32) for _ in range(2)]
    return port_fi.random_film(1).eval(), pair


# the loader feeds the convs NHWC-strided inputs, which take another float32
# summation order than the contiguous NCHW reference
LOADED_ATOL = 1e-4


def _midpoints(model, pair):
    with torch.no_grad():
        out = model(nchw(pair[0]), nchw(pair[1]), torch.full((2,), 0.5))
    return np.clip(nhwc(out), 0.0, 1.0)


def test_torchscript_blob_loads_through_the_port_loader(film, tmp_path):
    model, pair = film
    pt = tmp_path / "film_net_test.pt"
    with torch.no_grad(), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # tracer warnings on shape arithmetic
        traced = torch.jit.trace(model, (nchw(pair[0]), nchw(pair[1]), torch.full((2,), 0.5)))
    torch.jit.save(traced, str(pt))
    fn = port_fi.init_frame_interpolation_model(weights_path=str(pt), device="cpu")
    assert fn.batched and fn.device_io and fn.model.dtype == torch.float32
    got = fn(*pair)  # numpy in, numpy out, in MAX_BATCH chunks
    np.testing.assert_allclose(got, _midpoints(model, pair), atol=LOADED_ATOL, rtol=0)
    assert np.abs(got - 0.5 * (pair[0] + pair[1])).max() > 0.1  # not a cross-fade
    # the CLIs' path: a given path loads, a missing one raises
    assert port_fi.init_for_cli(str(pt), device="cpu").batched
    with pytest.raises(FileNotFoundError):
        port_fi.init_for_cli(str(tmp_path / "missing.pt"), device="cpu")


def test_npz_of_flax_paths_loads_through_the_port_loader(film, tmp_path):
    model, pair = film
    params, unused = convert_film(model.state_dict())
    assert not unused

    def flatten(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            out.update(flatten(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
        return out

    flat = flatten(params)
    npz = tmp_path / "film.npz"
    np.savez(npz, **flat)
    fn = port_fi._load_film(str(npz), device="cpu")
    np.testing.assert_allclose(fn(*pair), _midpoints(model, pair), atol=LOADED_ATOL, rtol=0)


def test_cli_fallback_without_weights_is_loud(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.warns(UserWarning, match="falling back to linear"):
        fn = port_fi.init_for_cli(None, device="cpu")
    assert fn is port_fi.linear_midpoint
    with pytest.raises(FileNotFoundError):
        port_fi.init_frame_interpolation_model(device="cpu")


# ------------------------------------------------------------- subdivision
def test_batched_subdivision_matches_sequential_and_jax():
    rs = np.random.RandomState(0)
    video = rs.rand(1, 5, 8, 8, 3).astype(np.float32)

    def batched(left, right):
        return 0.5 * left + 0.5 * right

    batched.batched = True
    for k in (1, 2, 3):
        seq = port_fi.batch_images_interpolation_tool(video, port_fi.linear_midpoint, k)
        bat = port_fi.batch_images_interpolation_tool(video, batched, k)
        want = jax_fi.batch_images_interpolation_tool(video, jax_fi.linear_midpoint, k)
        assert seq.shape == bat.shape == (1, (5 - 1) * (k + 1) + 1, 8, 8, 3)
        np.testing.assert_allclose(seq, bat, atol=1e-7)
        np.testing.assert_array_equal(seq, want)


def test_uint8_tensor_path_matches_host_path():
    """A uint8 tensor in (the pipeline's ``return_device`` output): the
    rounds run on the tensors' device and come back once as uint8; equal to
    the host float path up to the uint8 quantisation of inserted frames."""
    rs = np.random.RandomState(1)
    video_u8 = rs.randint(0, 256, (4, 8, 8, 3), np.uint8)
    video_f = video_u8.astype(np.float32)[None] / 255.0
    calls = []

    def batched(left, right):
        calls.append(type(left))
        return torch.clamp(0.5 * torch.as_tensor(left) + 0.5 * torch.as_tensor(right), 0, 1)

    batched.batched = True
    batched.device_io = True
    batched.device = torch.device("cpu")
    for k in (1, 2):
        host = port_fi.batch_images_interpolation_tool(video_f, batched, k)
        dev = port_fi.batch_images_interpolation_tool(torch.from_numpy(video_u8), batched, k)
        assert isinstance(host, np.ndarray) and dev.shape == host.shape
        np.testing.assert_allclose(dev, host, atol=0.5 / 255 + 1e-6)
        np.testing.assert_array_equal(dev[:, ::k + 1], host[:, ::k + 1])
        u8 = port_fi.batch_images_interpolation_tool(torch.from_numpy(video_u8), batched, k,
                                                     return_device=True)
        assert u8.dtype == torch.uint8
        np.testing.assert_allclose(u8[0].numpy().astype(np.float32) / 255.0, dev[0], atol=1e-7)
    assert set(calls) == {torch.Tensor}
    # a host model takes the uint8 tensor as float frames in [0, 1]
    lin = port_fi.batch_images_interpolation_tool(torch.from_numpy(video_u8),
                                                  port_fi.linear_midpoint, 1)
    np.testing.assert_allclose(lin, port_fi.batch_images_interpolation_tool(
        video_f, port_fi.linear_midpoint, 1), atol=1e-7)


# --------------------------------------------------------------------- -acc
def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


@pytest.fixture
def small_film(tmp_path, monkeypatch):
    """Both packages' FiLM loaders build the ``SMALL`` net in float32 (the
    JAX loader's is full-size bf16), and an ``.npz`` of its flax paths
    (seeded) that both read: returns the npz path."""
    x = np.zeros((1, 32, 32, 3), np.float32)
    _, params = jax_params(5, x, x)
    npz = tmp_path / "film_small.npz"
    np.savez(npz, **_flatten(params))
    real_jax, real_port = jax_film.FilmInterpolator, port_film.FilmInterpolator
    monkeypatch.setattr(jax_film, "FilmInterpolator",
                        lambda **kw: real_jax(**SMALL, dtype=jnp.float32))
    monkeypatch.setattr(port_film, "FilmInterpolator", lambda **kw: real_port(**SMALL))
    return str(npz)


def test_pose2vid_acc_cli_matches_jax(monkeypatch, tmp_path, inputs, modules, faces,
                                      small_film):
    """``-acc --fi_step 2 -L 5 --fi_weights`` (the small FiLM on both sides):
    frames 0, 2, 4 diffused, 5 out, FiLM on the pipeline's uint8 output;
    the reference and pose rows equal, the result row within one uint8
    level."""
    monkeypatch.chdir(tmp_path)
    cfg = inputs(6, 30, (RES, RES))
    argv = ["--config", cfg, "-W", str(RES), "-H", str(RES), "-L", "5", "--steps", "2",
            "--seed", "3", "-acc", "--fi_step", "2", "--fi_weights", small_film]
    ref = run_main(monkeypatch, "jax", jax_pose2vid.main, argv, modules, faces)
    port = run_main(monkeypatch, "port", port_pose2vid.main, argv, modules, faces)
    grid = _compare(port, ref, exact_rows=(0, 1))
    assert grid.shape == (3, 5, RES, RES, 3)
    video = grid[2]
    assert np.abs(video[1] - 0.5 * (video[0] + video[2])).max() > 0.05  # not a cross-fade


def test_pose2vid_generate_runs_film_on_the_pipeline_tensor(modules):
    """``generate`` under ``-acc`` hands the pipeline's uint8 tensor to a
    device FiLM: (L - 1) * fi_step + 1 frames, the diffused ones unchanged;
    without FiLM weights the CLIs' cross-fade fills the same frames."""
    _, pm = modules
    rs = np.random.RandomState(2)
    img = rs.randint(0, 255, (RES, RES, 3), np.uint8)
    poses = [rs.randint(0, 255, (RES, RES, 3), np.uint8) for _ in range(7)]
    args = port_pose2vid.parse_args(["-W", str(RES), "-H", str(RES), "--steps", "1",
                                     "--seed", "0", "-acc", "--fi_step", "3"])
    case = dict(ref_image=img, pose_images=poses[::3], pose_row=poses,
                kw=dict(video_length=3))
    pipe = Pose2VideoPipeline(pm)
    plain = pipe(img, poses[::3], None, RES, RES, 3, 1, 3.5, seed=0)
    film = port_fi._load_film(None, random_init=True, device="cpu")
    for interpolator in (film, port_fi.linear_midpoint):
        (key, grid), = port_pose2vid.generate(pipe, [case], args, interpolator=interpolator)
        assert key == 0 and grid.shape == (3, 7, RES, RES, 3)
        np.testing.assert_array_equal(grid[2][::3], plain)
        np.testing.assert_array_equal(grid[1], np.stack(poses) / np.float32(255))
        assert np.isfinite(grid).all() and grid.min() >= 0 and grid.max() <= 1
    # two rounds of midpoints: a, (a + m) / 2, m = (a + b) / 2, b
    np.testing.assert_allclose(grid[2][1], 0.75 * plain[0] + 0.25 * plain[1], atol=1e-6)
    np.testing.assert_allclose(grid[2][2], 0.5 * plain[0] + 0.5 * plain[1], atol=1e-6)


def test_vid2vid_acc_takes_every_fi_step_th_source_frame(monkeypatch, tmp_path, inputs,
                                                         modules, faces, small_film):
    """The port's vid2vid ``-acc`` (the JAX CLI's raises without FiLM weights,
    ROADMAP F11): a 60 fps source of 8 frames is halved to 4, landmarks come
    from every 2nd of those, 2 frames are diffused and FiLM fills 1, against
    the source row at the halved rate."""
    monkeypatch.chdir(tmp_path)
    cfg = inputs(8, 60, (96, 80))
    argv = ["--config", cfg, "-W", str(RES), "-H", str(RES), "--steps", "2", "--seed", "3",
            "-acc", "--fi_step", "2", "--fi_weights", small_film]
    (grid, _, fps), = run_main(monkeypatch, "port", port_vid2vid.main, argv, modules, faces)
    assert grid.shape == (3, 3, RES, RES, 3) and fps == 30
    plain = run_main(monkeypatch, "port", port_vid2vid.main, argv[:-5], modules, faces)
    # rows: reference, result, source; the source row at the halved rate
    (plain_grid, _, _), = plain
    assert plain_grid.shape == (3, 4, RES, RES, 3)
    np.testing.assert_array_equal(grid[0], plain_grid[0][:3])
    np.testing.assert_array_equal(grid[2], plain_grid[2][:3])
    assert np.isfinite(grid[1]).all() and 0 <= grid[1].min() and grid[1].max() <= 1
