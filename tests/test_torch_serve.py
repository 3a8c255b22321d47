"""The port's serving layer: the stdlib HTTP server
(aniportrait_tpu_torch/scripts/serve.py), the serving core and the Gradio
app's re-exports, on the CPU.

The HTTP tests are tests/test_serve.py's, against the port's server with
fake handlers (no models): health and index, a round trip, a failed job, a
bad request, serialised concurrency and the 503 over capacity.  The end to
end test runs ``serving_core.run_audio2video`` at micro size: tiny audio
models, the micro pipeline, landmarks from .npz sidecars made from
tests/fixtures/landmark_golden.npz, a seeded WAV, and the mp4 it writes.
"""

import io
import json
import sys
import threading
import time
import urllib.error
import urllib.request
import uuid
from pathlib import Path

import cv2
import numpy as np
import pytest
from scipy.io import wavfile

import chip_smoke
from aniportrait_tpu_torch import factory
from aniportrait_tpu_torch.config import Config, load_config
from aniportrait_tpu_torch.landmark.geometry import GeometrySolver, load_geometry_metadata
from aniportrait_tpu_torch.landmark.pipeline import DEFAULT_TASK
from aniportrait_tpu_torch.scripts import loader, serving_core
from aniportrait_tpu_torch.scripts.serve import build_server, model_handlers
from aniportrait_tpu_torch.utils import mp_utils
from aniportrait_tpu_torch.utils.util import get_fps, read_frames

ROOT = Path(__file__).resolve().parents[1]


def _png_bytes():
    ok, buf = cv2.imencode(".png", np.zeros((32, 32, 3), np.uint8))
    assert ok
    return bytes(buf)


def _multipart(fields):
    boundary = uuid.uuid4().hex
    out = b""
    for name, value in fields.items():
        out += f"--{boundary}\r\n".encode()
        if isinstance(value, tuple):
            fname, data = value
            out += (f'Content-Disposition: form-data; name="{name}"; filename="{fname}"\r\n'
                    "Content-Type: application/octet-stream\r\n\r\n").encode() + data + b"\r\n"
        else:
            out += (f'Content-Disposition: form-data; name="{name}"\r\n\r\n'
                    f"{value}\r\n").encode()
    out += f"--{boundary}--\r\n".encode()
    return out, f"multipart/form-data; boundary={boundary}"


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read()


def _post(url, body, ctype):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _wait_job(base, jid, want, timeout=10):
    deadline = time.time() + timeout
    job = None
    while time.time() < deadline:
        job = json.loads(_get(f"{base}/api/jobs/{jid}")[1])
        if job["status"] == want:
            return job
        time.sleep(0.05)
    raise AssertionError(f"job never reached {want}: {job}")


def _serve(handlers, tmp_path, **kw):
    httpd = build_server(handlers, host="127.0.0.1", port=0, out_dir=str(tmp_path), **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture()
def server(tmp_path):
    calls = {}

    def a2v(ref_img_rgb, input_audio, out_dir, headpose_video=None, **kw):
        calls["a2v"] = dict(kw, ref_shape=ref_img_rgb.shape, audio=input_audio,
                            headpose=headpose_video)
        path = f"{out_dir}/result.mp4"
        with open(path, "wb") as f:
            f.write(b"FAKEMP4")
        return path

    def v2v_fail(ref_img_rgb, source_video, out_dir, **kw):
        raise RuntimeError("boom")

    httpd, base = _serve({"audio2video": a2v, "video2video": v2v_fail}, tmp_path)
    yield base, calls
    httpd.shutdown()


def test_health_and_index(server):
    base, _ = server
    code, data = _get(f"{base}/healthz")
    assert code == 200 and json.loads(data)["ok"]
    code, data = _get(base + "/")
    assert code == 200 and b"AniPortrait-TPU" in data


def test_audio2video_roundtrip(server):
    base, calls = server
    body, ctype = _multipart({
        "ref_image": ("ref.png", _png_bytes()), "audio": ("a.wav", b"RIFFxxxxWAVE"),
        "size": "64", "steps": "2", "length": "4", "seed": "7",
    })
    code, data = _post(f"{base}/api/audio2video", body, ctype)
    assert code == 202
    job = _wait_job(base, json.loads(data)["id"], "done")
    assert job["result"].startswith("/results/")
    code, data = _get(base + job["result"])
    assert code == 200 and data == b"FAKEMP4"
    assert calls["a2v"]["size"] == 64 and calls["a2v"]["steps"] == 2
    assert calls["a2v"]["seed"] == 7 and calls["a2v"]["ref_shape"] == (32, 32, 3)
    assert calls["a2v"]["audio"].endswith(".wav") and calls["a2v"]["headpose"] is None


def test_failed_job_surfaces_error(server):
    base, _ = server
    body, ctype = _multipart({"ref_image": ("ref.png", _png_bytes()),
                              "source_video": ("v.mp4", b"\x00\x01")})
    code, data = _post(f"{base}/api/video2video", body, ctype)
    assert code == 202
    job = _wait_job(base, json.loads(data)["id"], "failed")
    assert "boom" in job["error"]


def test_bad_request(server):
    base, _ = server
    body, ctype = _multipart({"size": "64"})  # no files
    code, _ = _post(f"{base}/api/audio2video", body, ctype)
    assert code == 400
    code, _ = _get(f"{base}/api/jobs")  # still serving
    assert code == 200


def test_concurrent_requests_serialized(tmp_path):
    """Simultaneous requests never interleave on the device: the single
    worker runs the handlers strictly one after another."""
    active, overlaps = [], []
    lock = threading.Lock()

    def a2v(ref_img_rgb, input_audio, out_dir, headpose_video=None, **kw):
        with lock:
            if active:
                overlaps.append(tuple(active))
            active.append(kw["seed"])
        time.sleep(0.2)
        with lock:
            active.remove(kw["seed"])
        path = f"{out_dir}/r{kw['seed']}.mp4"
        with open(path, "wb") as f:
            f.write(b"FAKE")
        return path

    httpd, base = _serve({"audio2video": a2v, "video2video": a2v}, tmp_path)
    try:
        jids = []

        def post(seed):
            body, ctype = _multipart({"ref_image": ("ref.png", _png_bytes()),
                                      "audio": ("a.wav", b"RIFFxxxxWAVE"),
                                      "seed": str(seed)})
            code, data = _post(f"{base}/api/audio2video", body, ctype)
            assert code == 202
            jids.append(json.loads(data)["id"])

        threads = [threading.Thread(target=post, args=(s,)) for s in (1, 2, 3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=10)
            assert not th.is_alive()
        assert len(jids) == 3
        for jid in jids:
            _wait_job(base, jid, "done")
        assert not overlaps, f"handlers interleaved on the device: {overlaps}"
    finally:
        httpd.shutdown()


def test_503_over_capacity(tmp_path):
    """POSTs beyond ``max_queue`` get 503 with Retry-After; reads are still
    served."""
    release = threading.Event()

    def slow(ref_img_rgb, input_audio, out_dir, headpose_video=None, **kw):
        release.wait(10)
        path = f"{out_dir}/r.mp4"
        with open(path, "wb") as f:
            f.write(b"FAKE")
        return path

    httpd, base = _serve({"audio2video": slow, "video2video": slow}, tmp_path, max_queue=1)
    try:
        body, ctype = _multipart({"ref_image": ("ref.png", _png_bytes()),
                                  "audio": ("a.wav", b"RIFFxxxxWAVE")})
        codes, last = [], None
        for _ in range(4):
            code, last = _post(f"{base}/api/audio2video", body, ctype)
            codes.append(code)
        assert codes[0] == 202 and 503 in codes, codes
        if codes[-1] == 503:
            assert "capacity" in json.loads(last)["error"]
        assert _get(f"{base}/healthz")[0] == 200
    finally:
        release.set()
        httpd.shutdown()


# ------------------------------------------------------------ serving core
def test_audio_config_literal_equals_the_yaml_files():
    cfg = load_config(str(ROOT / "configs/prompts/animation_audio.yaml")).to_dict()
    cfg["inference_config"] = load_config(
        str(ROOT / cfg["inference_config"])).to_dict()
    cfg["audio_inference_config"] = load_config(
        str(ROOT / cfg["audio_inference_config"])).to_dict()
    assert chip_smoke.AUDIO_CONFIG == cfg
    audio = loader.sub_config(chip_smoke.AUDIO_CONFIG["audio_inference_config"])
    assert audio.a2m_model.out_dim == 1404 and audio.pretrained_model.a2p_ckpt.endswith(".pt")


def test_app_reexports_the_serving_core_without_gradio():
    from aniportrait_tpu_torch.scripts import app

    assert app.run_audio2video is serving_core.run_audio2video
    assert app.run_video2video is serving_core.run_video2video
    assert app.load_serving_models is serving_core.load_serving_models
    assert app.get_headpose_temp is serving_core.get_headpose_temp
    assert "gradio" not in sys.modules


@pytest.fixture(scope="module")
def micro_models():
    tiny = {**chip_smoke.AUDIO_CONFIG["audio_inference_config"]}
    tiny["a2m_model"] = {**tiny["a2m_model"], "latent_dim": 16}
    tiny["a2p_model"] = {**tiny["a2p_model"], "latent_dim": 16}
    a2m, a2p = loader.load_audio_models(Config(tiny), random_init=True, device="cpu",
                                        wav2vec2=chip_smoke.TINY_WAV2VEC2)
    pipe = factory.build_pipeline("micro", device="cpu", seed=0)
    return serving_core.ServingModels(pipe=pipe, a2m=a2m, a2p=a2p)


def test_run_audio2video_end_to_end_micro(micro_models, tmp_path, monkeypatch):
    """Through the HTTP server: a PNG and a seeded 0.5-s WAV uploaded, the
    face found by the precomputed landmark backend (the fixture's solo face
    for the crop and for the cropped reference), tiny audio models, the micro
    pipeline at 64 px, 2 steps, 4 frames; the mp4 comes back with 4 frames."""
    golden = np.load(ROOT / "tests" / "fixtures" / "landmark_golden.npz")
    solver = GeometrySolver(load_geometry_metadata(DEFAULT_TASK))
    sidecars = tmp_path / "lmks"
    sidecars.mkdir()
    for i in range(2):
        np.savez(sidecars / f"{i}.npz", lmks=golden["solo_lmks"],
                 trans_mat=golden["solo_trans_mat"], bs=golden["solo_bs"],
                 lmks3d=solver.solve(golden["solo_lmks"], (512, 512))["mesh"])
    cls = mp_utils.LMKExtractor
    monkeypatch.setattr(mp_utils, "LMKExtractor",
                        lambda: cls(backend="precomputed", root=str(sidecars)))

    rs = np.random.RandomState(9)
    ok, png = cv2.imencode(".png", rs.randint(0, 255, (96, 80, 3), np.uint8))
    buf = io.BytesIO()
    wavfile.write(buf, 16000, (0.2 * rs.randn(8000) * 32767).astype(np.int16))
    out_dir = tmp_path / "out"
    httpd, base = _serve(model_handlers(micro_models), out_dir)
    try:
        body, ctype = _multipart({
            "ref_image": ("ref.png", bytes(png)), "audio": ("speech.wav", buf.getvalue()),
            "size": "64", "steps": "2", "length": "4", "seed": "1",
        })
        code, data = _post(f"{base}/api/audio2video", body, ctype)
        assert code == 202
        job = _wait_job(base, json.loads(data)["id"], "done", timeout=300)
        code, mp4 = _get(base + job["result"])
        assert code == 200 and len(mp4) > 200
    finally:
        httpd.shutdown()
    path = out_dir / Path(job["result"]).name
    frames = read_frames(str(path))
    assert len(frames) == 4 and frames[0].shape == (64, 64, 3)
    assert get_fps(str(path)) == 30
    phases = micro_models.pipe.timer.summary()
    assert phases["audio2mesh"]["count"] == phases["audio2pose"]["count"] == 1


def test_animate_takes_pose_maps_in_place_of_drawing(micro_models, monkeypatch):
    """The request's device part on arrays, as the card runs it: no
    drawing, the given maps cycled to the clip."""
    golden = np.load(ROOT / "tests" / "fixtures" / "landmark_golden.npz")
    solver = GeometrySolver(load_geometry_metadata(DEFAULT_TASK))
    face = dict(lmks=golden["lyl_lmks"], trans_mat=golden["lyl_trans_mat"],
                lmks3d=solver.solve(golden["lyl_lmks"], (512, 512))["mesh"])
    maps = [cv2.resize(golden[f"{n}_pose"], (64, 64)) for n in ("lyl", "solo")]
    rs = np.random.RandomState(10)
    sample = dict(audio_feature=rs.randn(6400).astype(np.float32), seq_len=12)
    seen = []
    pipe = micro_models.pipe
    orig = type(pipe).__call__

    def spy(self, ref, poses, *a, **kw):
        seen.append([p for p in poses])
        return orig(self, ref, poses, *a, **kw)

    monkeypatch.setattr(type(pipe), "__call__", spy)
    video = serving_core.animate(micro_models, sample, face,
                                 rs.randint(0, 255, (64, 64, 3), np.uint8), None,
                                 size=64, steps=1, length=5, seed=0, pose_maps=maps)
    assert video.shape == (5, 64, 64, 3) and np.isfinite(video).all()
    assert len(seen[0]) == 5
    for i, p in enumerate(seen[0]):
        np.testing.assert_array_equal(p, maps[i % 2])
