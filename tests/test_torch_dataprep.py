"""The port's data-preparation entry points (``aniportrait_tpu_torch/
scripts/{vid2pose,generate_ref_pose,prepare_video,preprocess_dataset}.py``)
against the JAX package's scripts of the same names, on a synthetic video
written with OpenCV and on folders of PNG frames.

Both sides' ``LMKExtractor`` is the ``precomputed`` backend over sidecar
files made from tests/fixtures/landmark_golden.npz (the three faces in turn,
each frame's ``trans_mat`` turned and moved a little, so that the head-pose
template varies; one frame has no face, so vid2pose takes its last-good-
frame fallback).  The ``.npy`` and JSON outputs must be bit-equal and the
decoded video frames equal.  Every input is made here.
"""

import json
from pathlib import Path

import cv2
import numpy as np

from aniportrait_tpu.utils import mp_utils as jax_mp
from aniportrait_tpu.utils import util as jax_util
from aniportrait_tpu_torch.utils import mp_utils as port_mp
from aniportrait_tpu_torch.utils import util as port_util

FIXTURE = Path(__file__).parent / "fixtures" / "landmark_golden.npz"
FACES = ("lyl", "solo", "Aragaki")
FRAMES, FPS = 8, 25.0


def _rotation(i: int) -> np.ndarray:
    """A small turn about y and a shift, different for every frame."""
    a = 0.03 * i
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = np.cos(a), np.sin(a), -np.sin(a), np.cos(a)
    m[:3, 3] = (0.2 * i, -0.1 * i, 0.05 * i)
    return m


def write_sidecars(root: Path, n: int, missing=()) -> Path:
    """``<i>.npz`` for i < n (skipping ``missing``): the fixture's faces in
    turn, with lmks3d, trans_mat and bs."""
    data = np.load(FIXTURE)
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        if i in missing:
            continue
        face = FACES[i % len(FACES)]
        lmks = data[f"{face}_lmks"]
        np.savez(root / f"{i}.npz", lmks=lmks, lmks3d=(lmks - 0.5) * 10.0,
                 trans_mat=(data[f"{face}_trans_mat"] @ _rotation(i)).astype(np.float32),
                 bs=data[f"{face}_bs"])
    return root


def write_video(path: Path, frames: int = FRAMES, size=(96, 80)) -> Path:
    """A smooth moving pattern, mp4v at FPS."""
    w, h = size
    yy, xx = np.mgrid[0:h, 0:w]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), FPS, (w, h))
    for i in range(frames):
        img = np.stack([127 + 100 * np.sin(xx / 9.0 + i + c) * np.cos(yy / 7.0 - i)
                        for c in range(3)], -1).astype(np.uint8)
        writer.write(img)
    writer.release()
    return path


def read_video(path: Path) -> np.ndarray:
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame)
    cap.release()
    return np.stack(out)


def run_both(monkeypatch, name, sidecars: Path, argv_for) -> dict:
    """Run the JAX script ``scripts/<name>.py`` and the port's with
    ``argv_for(side)`` and the precomputed landmarks at ``sidecars``;
    returns ``{side: {video file name: the frames written to it}}``."""
    import importlib
    import sys

    written = {"jax": {}, "port": {}}
    for side, mp, util in (("jax", jax_mp, jax_util), ("port", port_mp, port_util)):
        cls, write = mp.LMKExtractor, util.write_video
        monkeypatch.setattr(mp, "LMKExtractor",
                            lambda cls=cls: cls(backend="precomputed", root=str(sidecars)))

        def record(frames, path, fps=30.0, side=side, write=write):
            written[side][Path(path).name] = np.stack(frames)
            write(frames, path, fps)

        monkeypatch.setattr(util, "write_video", record)
    jax_main = importlib.import_module(f"scripts.{name}").main
    port_main = importlib.import_module(f"aniportrait_tpu_torch.scripts.{name}").main
    monkeypatch.setattr(sys, "argv", [name, *argv_for("jax")])
    jax_main()
    port_main(argv_for("port"))
    return written


def _sides(tmp_path, make):
    """A copy of the input for each side: {side: path}."""
    return {side: make(tmp_path / side) for side in ("jax", "port")}


def test_vid2pose_equals_jax(monkeypatch, tmp_path):
    def make(d):
        d.mkdir()
        return write_video(d / "clip.mp4")

    videos = _sides(tmp_path, make)
    sidecars = write_sidecars(tmp_path / "lmk", FRAMES, missing=(2,))
    written = run_both(monkeypatch, "vid2pose", sidecars,
                       lambda side: ["--video_path", str(videos[side])])
    outs = {}
    for side, v in videos.items():
        found = sorted(v.parent.glob("clip_kps*.mp4"))
        assert len(found) == 1, found
        outs[side] = found[0]
    assert outs["jax"].name == outs["port"].name
    got, want = read_video(outs["port"]), read_video(outs["jax"])
    assert got.shape == (FRAMES, 512, 512, 3)
    np.testing.assert_array_equal(got, want)
    (poses,) = written["port"].values()
    np.testing.assert_array_equal(poses, written["jax"]["clip_kps_noaudio.mp4"])
    assert np.array_equal(poses[2], poses[1])  # no face in frame 2: frame 1's pose
    assert not np.array_equal(poses[1], poses[0])


def test_generate_ref_pose_equals_jax(monkeypatch, tmp_path):
    video = write_video(tmp_path / "ref.mp4")
    sidecars = write_sidecars(tmp_path / "lmk", FRAMES)
    out = {side: tmp_path / f"{side}_pose.npy" for side in ("jax", "port")}
    run_both(monkeypatch, "generate_ref_pose", sidecars,
             lambda side: ["--ref_video_path", str(video), "--save_path", str(out[side])])
    got, want = np.load(out["port"]), np.load(out["jax"])
    assert got.shape == (int(FRAMES * 30 / FPS), 6) and np.abs(got).max() > 0
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_prepare_video_equals_jax(monkeypatch, tmp_path):
    video = write_video(tmp_path / "clip.mp4", size=(120, 96))
    # two extractor calls a frame: the crop, then the cropped frame
    sidecars = write_sidecars(tmp_path / "lmk", 2 * FRAMES)
    outs = {side: tmp_path / side for side in ("jax", "port")}
    written = run_both(monkeypatch, "prepare_video", sidecars,
                       lambda side: ["--video_path", str(video), "--out_dir",
                                     str(outs[side]), "--size", "64"])
    for kind in ("crop", "pose"):
        name = f"clip_{kind}.mp4"
        np.testing.assert_array_equal(written["port"][name], written["jax"][name])
        got, want = read_video(outs["port"] / name), read_video(outs["jax"] / name)
        assert got.shape == (FRAMES, 64, 64, 3)
        np.testing.assert_array_equal(got, want)


def test_preprocess_dataset_equals_jax(monkeypatch, tmp_path):
    rs = np.random.RandomState(0)
    frames = tmp_path / "frames"
    sizes = {"clip_a": 30, "clip_b": 5}  # clip_b is under the 30-frame minimum
    for clip, n in sizes.items():
        (frames / clip).mkdir(parents=True)
        for i in range(n):
            cv2.imwrite(str(frames / clip / f"{i:04d}.png"),
                        rs.randint(0, 255, (16, 16, 3), np.uint8))
    sidecars = write_sidecars(tmp_path / "lmk", sum(sizes.values()))
    out = {side: tmp_path / f"{side}_info" for side in ("jax", "port")}
    manifest = {side: tmp_path / f"{side}.json" for side in ("jax", "port")}
    run_both(monkeypatch, "preprocess_dataset", sidecars,
             lambda side: ["--input_dir", str(frames), "--output_dir", str(out[side]),
                           "--training_json", str(manifest[side])])
    files = sorted(p.relative_to(out["jax"]) for p in out["jax"].rglob("*.npy"))
    assert len(files) == 4 * sum(sizes.values())
    assert files == sorted(p.relative_to(out["port"]) for p in out["port"].rglob("*.npy"))
    for rel in files:
        a, b = np.load(out["port"] / rel), np.load(out["jax"] / rel)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=str(rel))
    got = json.loads(manifest["port"].read_text().replace(str(out["port"]), str(out["jax"])))
    want = json.loads(manifest["jax"].read_text())
    assert got == want and list(want) == ["clip_a"]
    assert len(want["clip_a"]["clip_data_list"][0]["lmks_list"]) == 30
