"""The port's entry points against the JAX package's.

pose2vid and vid2vid: each side's ``main()`` runs on the same prompt YAML,
reference PNG and mp4 (written with OpenCV), with ``load_pipeline``
replaced by a micro float32 pipeline over the same weights, the landmark
extractor by ``mp_utils``'s callable backend fed from
tests/fixtures/landmark_golden.npz, and the initial noise by one numpy
draw.  The grids each side hands to ``save_videos_grid`` must match: the
reference and pose/source rows exactly, the result row within the bounds
of tests/test_torch_pipeline.py (latents 1e-3, frames one uint8 level).  ``-acc`` with FiLM
weights that are not there raises before any model is built
(tests/test_torch_film.py holds ``-acc`` to the JAX CLI).

The bench entry: ``--tiny`` prints exactly one JSON line with the four
keys; without a card and without ``--tiny``/``--device cpu`` it fails and
prints nothing, also at the audio configurations; ``--quality`` goes to the
quality gate CLI.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import scripts.loader as jax_loader
from aniportrait_tpu.landmark.geometry import GeometrySolver, load_geometry_metadata
from aniportrait_tpu.landmark.pipeline import DEFAULT_TASK
from aniportrait_tpu.pipelines.pose2vid import Pose2VideoPipeline as JaxPipeline
from aniportrait_tpu.utils import image as jax_image
from aniportrait_tpu.utils import mp_utils as jax_mp
from aniportrait_tpu.utils import util as jax_util
from aniportrait_tpu_torch.pipelines import Pose2VideoPipeline
from aniportrait_tpu_torch.scripts import bench as port_bench
from aniportrait_tpu_torch.scripts import pose2vid as port_pose2vid
from aniportrait_tpu_torch.scripts import vid2vid as port_vid2vid
from aniportrait_tpu_torch.utils import mp_utils as port_mp
from scripts import pose2vid as jax_pose2vid
from scripts import vid2vid as jax_vid2vid
from test_torch_pipeline import build_modules, opencv_portable
from test_torch_modules import one_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
FACES = ("lyl", "solo", "Aragaki")
RES = 64


@pytest.fixture(scope="module")
def modules():
    return build_modules()


@pytest.fixture(scope="module")
def faces():
    """The fixture's three faces as landmark-extractor results, with the
    canonical mesh the geometry solver gives their landmarks."""
    golden = np.load(ROOT / "tests" / "fixtures" / "landmark_golden.npz")
    solver = GeometrySolver(load_geometry_metadata(DEFAULT_TASK))
    return [dict(lmks=golden[f"{n}_lmks"], trans_mat=golden[f"{n}_trans_mat"],
                 bs=golden[f"{n}_bs"], faces=None,
                 lmks3d=solver.solve(golden[f"{n}_lmks"], (512, 512))["mesh"])
            for n in FACES]


def write_video(path, frames, fps):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (frames[0].shape[1], frames[0].shape[0]))
    for f in frames:
        writer.write(f)
    writer.release()


@pytest.fixture
def inputs(tmp_path):
    """A prompt YAML whose test case maps a seeded PNG to a seeded mp4."""
    rs = np.random.RandomState(5)
    ref = tmp_path / "ref.png"
    cv2.imwrite(str(ref), rs.randint(0, 255, (90, 70, 3), np.uint8))

    def config(video_frames, fps, size):
        video = tmp_path / "drive.mp4"
        yy, xx = np.mgrid[0:size[0], 0:size[1]]
        write_video(video, [np.stack([120 + 100 * np.sin(xx / 5.0 + i + c) * np.cos(yy / 4.0)
                                      for c in range(3)], -1).astype(np.uint8)
                            for i in range(video_frames)], fps)
        cfg = tmp_path / "prompt.yaml"
        cfg.write_text(f"inference_config: {ROOT}/configs/inference/inference_v2.yaml\n"
                       f"test_cases:\n  \"{ref}\":\n    - \"{video}\"\n")
        return str(cfg)

    return config


def run_main(monkeypatch, side, main_fn, argv, modules, faces):
    """One side's ``main(argv)`` with the micro pipeline, the fixture's
    landmarks and numpy noise; returns the grids it would write."""
    jm, pm = modules
    grids = []
    noise = lambda shape: np.random.RandomState(0).randn(*shape).astype(np.float32)
    calls = iter(range(10 ** 6))

    mp = jax_mp if side == "jax" else port_mp
    extractor_cls = mp.LMKExtractor

    def extractor():
        ext = extractor_cls(backend="unavailable")
        ext.backend = mp._CallableBackend(lambda img: faces[next(calls) % len(faces)])
        return ext

    save = lambda grid, path, fps=30.0: grids.append((np.asarray(grid), Path(path).name, fps))
    if side == "jax":
        monkeypatch.setattr(jax_loader, "load_pipeline", lambda config, **kw: JaxPipeline(jm))
        monkeypatch.setattr(jax_mp, "LMKExtractor", extractor)
        monkeypatch.setattr(jax_util, "save_videos_grid", save)
        monkeypatch.setattr(jax.random, "normal",
                            lambda key, shape, dtype=jnp.float32: jnp.asarray(noise(shape)))
        # the pipeline's resize without IPP in every thread (IPP's setting is
        # per thread, and run_cases resizes on a worker)
        resize = jax_image._resize

        def portable_resize(*args, **kw):
            with opencv_portable():
                return resize(*args, **kw)

        monkeypatch.setattr(jax_image, "_resize", portable_resize)
        monkeypatch.setattr(sys, "argv", ["main", *argv])
        with jax.default_matmul_precision("highest"):
            main_fn()
    else:
        monkeypatch.setattr(port_pose2vid, "load_pipeline",
                            lambda config, **kw: Pose2VideoPipeline(pm))
        for mod in (port_pose2vid, port_vid2vid):
            monkeypatch.setattr(mod, "LMKExtractor", extractor)
            monkeypatch.setattr(mod, "save_videos_grid", save)
        monkeypatch.setattr(torch, "randn",
                            lambda shape, **kw: torch.from_numpy(noise(shape)))
        main_fn([*argv, "--device", "cpu"])
    return grids


def _compare(port, ref, exact_rows):
    assert len(port) == len(ref) == 1
    (gp, name_p, fps_p), (gj, name_j, fps_j) = port[0], ref[0]
    untimed = lambda name: re.sub(r"_\d{4}(?=(_noaudio)?\.mp4$)", "", name)
    assert (untimed(name_p), fps_p) == (untimed(name_j), fps_j)
    assert gp.shape == gj.shape
    for row in exact_rows:
        np.testing.assert_array_equal(gp[row], gj[row])
    result = ({0, 1, 2} - set(exact_rows)).pop()
    assert np.abs(gp[result] - gj[result]).max() <= 1.0 / 255 + 1e-6
    return gp


def test_pose2vid_cli_matches_jax(monkeypatch, tmp_path, inputs, modules, faces):
    monkeypatch.chdir(tmp_path)
    cfg = inputs(5, 30, (RES, RES))
    argv = ["--config", cfg, "-W", str(RES), "-H", str(RES), "-L", "4", "--steps", "2",
            "--seed", "3"]
    ref = run_main(monkeypatch, "jax", jax_pose2vid.main, argv, modules, faces)
    port = run_main(monkeypatch, "port", port_pose2vid.main, argv, modules, faces)
    grid = _compare(port, ref, exact_rows=(0, 1))
    assert grid.shape == (3, 4, RES, RES, 3)


def test_vid2vid_cli_matches_jax(monkeypatch, tmp_path, inputs, modules, faces):
    """A 60 fps source of 8 frames at 96x80: halved to 30 fps, 4 frames of
    retargeted, projected and drawn landmarks, resized to the output."""
    monkeypatch.chdir(tmp_path)
    cfg = inputs(8, 60, (96, 80))
    argv = ["--config", cfg, "-W", str(RES), "-H", str(RES), "--steps", "2", "--seed", "3"]
    ref = run_main(monkeypatch, "jax", jax_vid2vid.main, argv, modules, faces)
    port = run_main(monkeypatch, "port", port_vid2vid.main, argv, modules, faces)
    grid = _compare(port, ref, exact_rows=(0, 2))
    assert grid.shape == (3, 4, RES, RES, 3) and port[0][2] == 30


@pytest.mark.parametrize("cli", [port_pose2vid, port_vid2vid], ids=["pose2vid", "vid2vid"])
def test_acc_raises_before_any_model_is_built(cli, monkeypatch):
    def no_models(*a, **k):
        raise AssertionError("a model was built")

    monkeypatch.setattr(port_pose2vid, "load_pipeline", no_models)
    argv = ["-acc", "--fi_weights", "missing_film_net.pt"]
    with pytest.raises(FileNotFoundError, match="missing_film_net.pt"):
        cli.main([*argv, "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="missing_film_net.pt"):
        next(port_pose2vid.generate(None, [dict()], cli.parse_args([*argv, "--device", "cpu"])))


def test_bench_tiny_prints_one_json_line():
    # one intra-op thread, as the in-process port tests run (test_torch_modules.one_thread)
    res = subprocess.run([sys.executable, "-m", "aniportrait_tpu_torch.scripts.bench",
                          "--tiny"], cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert sorted(row) == ["metric", "unit", "value", "vs_baseline"]
    assert row["metric"] == "frames_per_sec_tiny_smoke" and row["unit"] == "frames/s"
    assert row["value"] > 0
    assert "device: CPU" in res.stderr and "pipelined e2e over 3 cases" in res.stderr


def test_bench_without_a_card_fails_and_prints_nothing():
    res = subprocess.run([sys.executable, "-m", "aniportrait_tpu_torch.scripts.bench"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0 and res.stdout == ""
    assert "no CUDA device" in res.stderr
    for argv in (["--config", "audio2mesh"], ["--config", "audio2vid", "--pose-maps", "fixture"]):
        with pytest.raises(SystemExit, match="no CUDA device"):
            port_bench.main(argv)
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_bench.main(["--config", "audio2vid_acc", "--pose-maps", "fixture"])
    with pytest.raises(SystemExit, match="no frames read"):
        port_bench.main(["--quality", "missing_a", "missing_b"])
