#!/usr/bin/env python
"""Benchmark of the port on the card (port of the root ``bench.py``).

Default: pose2vid at 512x512, 16 frames, 25 DDIM steps, CFG 3.5, bf16,
full-size models with random weights from seed 0 (weights do not change
the time; shapes and dtypes are the real model's).

    python -m aniportrait_tpu_torch.scripts.bench                          # 512 px pose2vid
    python -m aniportrait_tpu_torch.scripts.bench --encoder-cache 2       # with the encoder cache
    python -m aniportrait_tpu_torch.scripts.bench --config pose2vid256    # 256 px, 16 frames, 10 steps
    python -m aniportrait_tpu_torch.scripts.bench --config vid2vid24 [--window-fusion] [--window-batch k]
    python -m aniportrait_tpu_torch.scripts.bench --config long [--frames n] [--window-fusion]
    python -m aniportrait_tpu_torch.scripts.bench --config audio2mesh     # wav2vec2 + mesh head, 5 s
    python -m aniportrait_tpu_torch.scripts.bench --config audio2vid [--pose-maps fixture]
    python -m aniportrait_tpu_torch.scripts.bench --config audio2vid_acc [--pose-maps fixture]
    python -m aniportrait_tpu_torch.scripts.bench --tiny                  # tiny smoke, on the CPU
    python -m aniportrait_tpu_torch.scripts.bench --quality OURS REF [gate flags]  # quality_gate

Protocol (``bench.py:79-151``): inputs staged on the device before the
timed region; one warm-up call, then the median of 3 calls of
``pipe(staged, None, None, return_device=True, windowed=True,
decode_chunk=8)``, each ending in ``torch.cuda.synchronize()``.  The time
with host transfers, the 3-case ``run_cases`` throughput and the phase
breakdown go to stderr; stdout gets exactly one JSON line
``{"metric", "value", "unit", "vs_baseline"}``.  ``vs_baseline`` divides
by the JAX bench's cost model of the PyTorch reference on an A100
(``A100_FPS_512_25``, 1.0 frames/s at 512 px and 25 steps, scaled by
latent area and steps): a model, not a measurement.

The audio configurations (``bench.py:154-345``): ``audio2mesh`` times
Audio2Mesh (wav2vec2-base and the mesh head, random weights from seed 0) on
5 s of seeded audio, float32 with TF32 off, 150 frames, median of 5 after a
warm-up, upload and download included; ``vs_baseline`` divides by the same
model on the host CPU in the same process (median of 3 after a warm-up), the
torch fp32 CPU run the JAX bench measures.  ``audio2vid``: the audio stack
(Audio2Mesh, Audio2Pose on the whole clip, smoothing, projection, and the
pose maps drawn) on 48 frames of seeded audio, timed warm, plus the median
of 3 staged pipeline calls at 512x512, 25 steps, window batch 1, windowed;
``vs_baseline`` divides by ``A100_FPS_512_25``.  With ``--pose-maps
fixture`` the maps are those of tests/fixtures/landmark_golden.npz cycled
to the clip (drawing needs OpenCV, which the card's machine lacks), and the
drawing is left out of the time, as stderr says.  ``audio2vid_acc``
(``bench.py:270-345``): the same, but every 3rd of the 48 frames is
diffused (16) and FiLM (random weights, bf16 on the card) inserts 2 frames
between each pair on the device, 46 frames out; ``vs_baseline`` divides by
3 x ``A100_FPS_512_25``, the reference's ``-acc`` getting the same 3x.

``--quality OURS REF ...`` forwards the rest of the command line to
``scripts/quality_gate.py`` (PSNR / SSIM / LPIPS of two clips).

The models run on the card; ``--device cpu`` (or ``--tiny``, which implies
it) asks for the CPU.  Without a card and without either, the bench fails.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

A100_FPS_512_25 = 1.0  # bench.py:34, cost-modeled reference throughput

ROOT = Path(__file__).resolve().parents[2]
FIXTURE = ROOT / "tests" / "fixtures" / "landmark_golden.npz"


def _one_line(metric: str, fps: float, baseline: float, unit: str = "frames/s") -> None:
    print(json.dumps({"metric": metric, "value": round(fps, 3), "unit": unit,
                      "vs_baseline": round(fps / baseline, 3)}), flush=True)


def _median_time(fn, runs: int) -> float:
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _set_tf32(on: bool) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def _audio_models(device: str):
    """Audio2Mesh (seed 0) and Audio2Pose (seed 1) at full size, random
    weights, float32, on ``device``."""
    import torch

    from aniportrait_tpu_torch import factory
    from aniportrait_tpu_torch.audio.audio2mesh import Audio2MeshModel
    from aniportrait_tpu_torch.audio.audio2pose import Audio2PoseModel

    models = []
    for seed, cls in enumerate((Audio2MeshModel, Audio2PoseModel)):
        with torch.device("meta"):
            model = cls()
        model.to_empty(device=device)
        factory.init_weights(model, torch.Generator(device=device).manual_seed(seed))
        models.append(model.float().eval().requires_grad_(False))
    return models


def bench_audio2mesh(device: str = "cuda") -> None:
    """wav2vec2-base + the mesh head on 5 s of audio, float32 (the JAX
    bench's ``bench_audio2mesh``)."""
    import copy

    import torch

    sr, secs, fps_video = 16000, 5, 30
    frames = secs * fps_video
    wav = np.random.RandomState(0).randn(1, sr * secs).astype(np.float32)
    if device == "cuda":
        _set_tf32(False)
    model, _ = _audio_models(device)

    @torch.no_grad()
    def run(m, dev):
        return m(torch.from_numpy(wav).to(dev), frames).cpu().numpy()

    out = run(model, device)  # warm-up
    if out.shape != (1, frames, 1404) or not np.isfinite(out).all():
        raise SystemExit(f"bench: audio2mesh gave {out.shape}, finite "
                         f"{bool(np.isfinite(out).all())}")
    dt = _median_time(lambda: run(model, device), 5)
    cpu_model = copy.deepcopy(model).cpu() if device == "cuda" else model
    run(cpu_model, "cpu")
    cpu_dt = _median_time(lambda: run(cpu_model, "cpu"), 3)
    where = torch.cuda.get_device_name(0) if device == "cuda" else "CPU"
    print(f"device: {where}\n"
          f"ours ({device}, float32): {dt * 1e3:.1f} ms / {secs} s clip, median of 5\n"
          f"torch CPU baseline ({torch.get_num_threads()} threads, float32): "
          f"{cpu_dt * 1e3:.1f} ms / {secs} s clip, median of 3", file=sys.stderr)
    _one_line("audio2mesh_frames_per_sec", frames / dt, frames / cpu_dt)


def _audio_pose_frames(frames: int, res: int, device: str, pose_maps: str):
    """The audio stack of the audio2vid bench (``bench.py:214-262``):
    Audio2Mesh offsets on the canonical mesh and Audio2Pose's poses
    (smoothed over 7) from ``frames / 30`` s of seeded audio, projected, and
    the pose maps drawn (``pose_maps="draw"``) or taken from the fixture
    (``"fixture"``, drawing left out).  Timed warm: (maps, seconds)."""
    import torch

    from aniportrait_tpu_torch.landmark.geometry import GeometrySolver, load_geometry_metadata
    from aniportrait_tpu_torch.landmark.pipeline import DEFAULT_TASK
    from aniportrait_tpu_torch.utils.pose_util import project_points, smooth_pose_seq

    wav = np.random.RandomState(0).randn(1, int(16000 * frames / 30)).astype(np.float32)
    a2m, a2p = _audio_models(device)
    neutral = GeometrySolver(load_geometry_metadata(DEFAULT_TASK)).canonical
    trans_mat = np.eye(4)
    trans_mat[2, 3] = -50.0
    if pose_maps == "fixture":
        golden = np.load(FIXTURE)
        names = ("lyl", "solo", "Aragaki")
        fixture = [golden[f"{names[i % 3]}_pose"] for i in range(frames)]
        if fixture[0].shape != (res, res, 3):
            raise SystemExit(f"bench: the fixture's pose maps are {fixture[0].shape[:2]}, "
                             f"not {res}x{res}")
    else:
        from aniportrait_tpu_torch.utils.draw_util import FaceMeshVisualizer

        vis = FaceMeshVisualizer(forehead_edge=False)

    @torch.no_grad()
    def stack():
        w = torch.from_numpy(wav).to(device)
        offsets = a2m(w, frames)[0].cpu().numpy().reshape(frames, -1, 3)
        ids = torch.zeros(1, dtype=torch.long, device=device)
        pose6 = smooth_pose_seq(a2p(w, frames, ids)[0].cpu().numpy(), 7)
        projected = project_points(neutral[None] + offsets, trans_mat, pose6, [res, res])
        if pose_maps == "fixture":
            return fixture
        return [vis.draw_landmarks((res, res), pts, normed=False) for pts in projected]

    stack()  # warm-up
    t0 = time.perf_counter()
    maps = stack()
    return maps, time.perf_counter() - t0


def bench_audio2vid(frames: int = 48, res: int = 512, steps: int = 25,
                    pose_maps: str = "draw", device: str = "cuda", acc: bool = False) -> None:
    """The whole audio -> video path (the JAX bench's ``bench_audio2vid``);
    ``acc``: diffuse every 3rd frame and FiLM-interpolate 2 between."""
    import torch

    from aniportrait_tpu_torch import factory
    from aniportrait_tpu_torch.pipelines import Pose2VideoPipeline
    from aniportrait_tpu_torch.utils.frame_interpolation import (
        batch_images_interpolation_tool,
        init_frame_interpolation_model,
    )

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    if on_card:
        _set_tf32(True)
    maps, t_audio = _audio_pose_frames(frames, res, device, pose_maps)
    if pose_maps == "fixture":
        print("pose maps: the fixture's (tests/fixtures/landmark_golden.npz) cycled to the "
              "clip; drawing is left out of the time", file=sys.stderr)
    ref = np.random.RandomState(0).randint(0, 255, (res, res, 3), np.uint8)
    fi_step = 3 if acc else 1
    maps = maps[::fi_step]
    diff_frames = len(maps)
    out_frames = (diff_frames - 1) * fi_step + 1
    modules = factory.build_models("full", device, torch.bfloat16, seed=0)
    pipe = Pose2VideoPipeline(modules, dtype=torch.bfloat16, window_batch=1)
    # random-weight FiLM net (the real architecture; weights do not change the time)
    film = (init_frame_interpolation_model(random_init=True, device=device)
            if acc else None)
    kw = dict(width=res, height=res, video_length=diff_frames, num_inference_steps=steps,
              guidance_scale=3.5, seed=0, windowed=True, decode_chunk=8)
    staged = pipe.stage_inputs(ref, maps, res, res, device=True)
    sync()

    def run():
        video = pipe(staged, None, None, return_device=True, **kw)
        if acc:  # on the device: uint8 in, uint8 out
            video = batch_images_interpolation_tool(video, film, inter_frames=fi_step - 1,
                                                    return_device=True)[0]
        sync()
        return video

    warm = run()
    if warm.shape != (out_frames, res, res, 3):
        raise SystemExit(f"bench: audio2vid gave {tuple(warm.shape)}")
    pipe.timer.totals.clear()
    pipe.timer.counts.clear()
    diffusion = _median_time(run, 3)
    phases = pipe.timer.report()
    dt = diffusion + t_audio
    t0 = time.perf_counter()
    video = pipe(ref, maps, None, return_device=acc, **kw)
    if acc:
        video = batch_images_interpolation_tool(video, film, inter_frames=fi_step - 1)[0]
    e2e = time.perf_counter() - t0 + t_audio
    if video.shape != (out_frames, res, res, 3):
        raise SystemExit(f"bench: audio2vid gave {video.shape}")
    where = torch.cuda.get_device_name(0) if on_card else "CPU"
    print(f"device: {where}\n"
          f"audio stack (warm) {t_audio:.3f} s; diffusion {diff_frames} frames"
          f"{' + FiLM' if acc else ''}, median of 3 staged calls {diffusion:.3f} s; "
          f"output {out_frames} frames in {dt:.3f} s\n"
          f"phase breakdown (3 staged calls): {phases}\n"
          f"e2e incl. host transfers: {e2e:.2f} s ({out_frames / e2e:.3f} f/s)",
          file=sys.stderr)
    if acc:
        _one_line("audio2vid_acc_frames_per_sec", out_frames / dt, A100_FPS_512_25 * fi_step)
    else:
        _one_line("audio2vid_frames_per_sec", out_frames / dt, A100_FPS_512_25)


def bench_pose2vid(size: str = "full", steps: int = 25, frames: int = 16, res: int = 512,
                   window_batch: int = 1, metric: str | None = None,
                   baseline: float | None = None, runs: int = 3,
                   encoder_cache_interval: int = 1, window_fusion: bool = False,
                   device: str = "cuda") -> None:
    import torch

    from aniportrait_tpu_torch import factory
    from aniportrait_tpu_torch.pipelines import Pose2VideoPipeline

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    modules = factory.build_models(size, device, torch.bfloat16, seed=0)
    pipe = Pose2VideoPipeline(modules, dtype=torch.bfloat16, window_batch=window_batch,
                              encoder_cache_interval=encoder_cache_interval,
                              window_fusion=window_fusion)

    rs = np.random.RandomState(0)
    ref = rs.randint(0, 255, (res, res, 3), np.uint8)
    poses = [rs.randint(0, 255, (res, res, 3), np.uint8) for _ in range(frames)]
    kw = dict(width=res, height=res, video_length=frames, num_inference_steps=steps,
              guidance_scale=3.5, seed=0, windowed=True, decode_chunk=8)

    # inputs staged on the device outside the timed region: the metric is
    # the compute path, as the A100 cost model's is
    staged = pipe.stage_inputs(ref, poses, res, res, device=True)
    sync()

    def run():
        pipe(staged, None, None, return_device=True, **kw)
        sync()

    run()  # warm-up
    pipe.timer.totals.clear()
    pipe.timer.counts.clear()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    phases = pipe.timer.report()  # summed over the timed calls
    fps = frames / dt

    t0 = time.perf_counter()
    full = pipe(ref, poses, None, **kw)  # host -> device -> host
    if full.shape[0] != frames:
        raise SystemExit(f"bench: {full.shape[0]} frames out of {frames}")
    e2e = time.perf_counter() - t0
    # 3 cases through run_cases: case i+1's upload and case i-1's download
    # overlap case i's denoise, the steady state of a multi-case CLI run
    cases = [dict(ref_image=ref, pose_images=poses, key=i) for i in range(3)]
    t0 = time.perf_counter()
    call_kw = {k: v for k, v in kw.items() if k not in ("width", "height")}
    n_out = sum(v.shape[0] for _, v in pipe.run_cases(cases, res, res, **call_kw))
    e2e_pipe = n_out / (time.perf_counter() - t0)
    where = torch.cuda.get_device_name(0) if on_card else "CPU"
    print(f"device: {where}\n"
          f"staged calls {', '.join(f'{t:.3f}' for t in times)} s, median {dt:.3f} s "
          f"({fps:.3f} frames/s)\n"
          f"phase breakdown ({runs} staged calls): {phases}\n"
          f"e2e incl. host transfers: {e2e:.2f} s ({frames / e2e:.3f} f/s); "
          f"pipelined e2e over 3 cases: {e2e_pipe:.3f} f/s", file=sys.stderr)

    if baseline is None:  # the 512 px / 25 step cost model by latent area and steps
        baseline = A100_FPS_512_25 * (512 / res) ** 2 * (25 / steps)
    _one_line(metric or f"frames_per_sec_{res}px_{steps}step", fps, baseline)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", choices=("pose2vid256", "vid2vid24", "long", "audio2mesh",
                                             "audio2vid", "audio2vid_acc"))
    parser.add_argument("--encoder-cache", type=int, default=1)
    parser.add_argument("--window-fusion", action="store_true")
    parser.add_argument("--window-batch", type=int, default=1)
    parser.add_argument("--frames", type=int, default=120, help="--config long's length")
    parser.add_argument("--tiny", action="store_true",
                        help="tiny models, 2 steps, 4 frames, 64 px, on the CPU")
    parser.add_argument("--pose-maps", choices=("draw", "fixture"), default="draw",
                        help="audio2vid: draw the pose maps (OpenCV), or take the test "
                             "fixture's and leave drawing out of the time")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--quality", action="store_true",
                        help="OURS REF [quality_gate flags]: the PSNR/SSIM/LPIPS gate "
                             "(every argument after --quality goes to it)")
    return parser.parse_args(argv)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--quality" in argv:
        from aniportrait_tpu_torch.scripts.quality_gate import main as quality_main

        return quality_main(argv[argv.index("--quality") + 1:])
    args = parse_args(argv)
    device = "cpu" if args.tiny else args.device
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("bench: no CUDA device (pass --device cpu or --tiny to "
                             "run on the CPU)")
    if args.tiny:
        return bench_pose2vid(size="tiny", steps=2, frames=4, res=64,
                              metric="frames_per_sec_tiny_smoke", baseline=1.0,
                              device=device)
    if args.config == "audio2mesh":
        return bench_audio2mesh(device)
    if args.config in ("audio2vid", "audio2vid_acc"):
        return bench_audio2vid(pose_maps=args.pose_maps, device=device,
                               acc=args.config == "audio2vid_acc")
    if args.config == "pose2vid256":
        return bench_pose2vid(steps=10, frames=16, res=256, device=device)
    if args.config == "vid2vid24":
        wf, wb = args.window_fusion, args.window_batch
        return bench_pose2vid(steps=25, frames=24, res=512,
                              metric="vid2vid_frames_per_sec_512px_24f"
                              + ("_fused" if wf else "") + (f"_wb{wb}" if wb != 1 else ""),
                              window_fusion=wf, window_batch=wb, device=device)
    if args.config == "long":
        wf, n = args.window_fusion, args.frames
        return bench_pose2vid(steps=25, frames=n, res=512, window_batch=2,
                              metric=f"long_frames_per_sec_512px_{n}f"
                              + ("_fused" if wf else "_exact"),
                              window_fusion=wf, device=device)
    ec = args.encoder_cache
    return bench_pose2vid(metric="frames_per_sec_512px_25step"
                          + (f"_enccache{ec}" if ec > 1 else ""),
                          baseline=A100_FPS_512_25, encoder_cache_interval=ec,
                          device=device)


if __name__ == "__main__":
    sys.exit(main())
