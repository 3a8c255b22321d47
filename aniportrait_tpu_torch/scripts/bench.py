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
    python -m aniportrait_tpu_torch.scripts.bench --tiny                  # tiny smoke, on the CPU

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

The models run on the card; ``--device cpu`` (or ``--tiny``, which implies
it) asks for the CPU.  Without a card and without either, the bench fails.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

A100_FPS_512_25 = 1.0  # bench.py:34, cost-modeled reference throughput

# configurations of the JAX bench whose paths the port does not have yet
NOT_PORTED = {
    "audio2mesh": "the audio models are not ported yet: ROADMAP M9",
    "audio2vid": "the audio models are not ported yet: ROADMAP M9",
    "audio2vid_acc": "-acc (FiLM) and the audio models are not ported yet: ROADMAP M8, M9",
}


def _one_line(metric: str, fps: float, baseline: float, unit: str = "frames/s") -> None:
    print(json.dumps({"metric": metric, "value": round(fps, 3), "unit": unit,
                      "vs_baseline": round(fps / baseline, 3)}), flush=True)


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
    parser.add_argument("--config", choices=("pose2vid256", "vid2vid24", "long",
                                             *NOT_PORTED))
    parser.add_argument("--encoder-cache", type=int, default=1)
    parser.add_argument("--window-fusion", action="store_true")
    parser.add_argument("--window-batch", type=int, default=1)
    parser.add_argument("--frames", type=int, default=120, help="--config long's length")
    parser.add_argument("--tiny", action="store_true",
                        help="tiny models, 2 steps, 4 frames, 64 px, on the CPU")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--quality", nargs="+", metavar="VIDEO",
                        help="the LPIPS/PSNR gate: not ported yet (ROADMAP M13)")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.quality:
        raise NotImplementedError("--quality (LPIPS/PSNR gate) is not ported yet: "
                                  "ROADMAP M13")
    if args.config in NOT_PORTED:
        raise NotImplementedError(f"--config {args.config}: {NOT_PORTED[args.config]}")
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
    main()
