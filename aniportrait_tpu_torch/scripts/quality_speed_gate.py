"""Quality against speed of the opt-in approximations (port of ``scripts/quality_speed_gate.py``).

    python -m aniportrait_tpu_torch.scripts.quality_speed_gate [--res 512] [--steps 25]
        [--frames 16] [--win-frames 24] [--long-frames 0] [--check] [--out report.json]

What can be measured without pretrained weights: the numerical divergence
each approximation brings against the exact path of the same model (the
full-size architecture, random bf16 weights from seed 0, fixed seeds), as
PSNR / SSIM between the two outputs (uint8 frames).  That is the error of
the mechanism itself, not perceptual quality on real weights.  The weights
are drawn by the rule the stored table was measured on, the JAX gate's
``init_random_params`` (flax's initializers: ``factory.init_flax_defaults``);
under it the motion modules' zero ``proj_out`` makes them start as the
identity, so the fusion and rotation rows measure the clip's numerical
noise more than the mechanisms.

Rows:
  * encoder cache k=2 and k=3 against the exact path at ``--frames`` (the
    main config: 512x512, 16 frames, 25 steps);
  * window fusion (``fusion_motion`` 'context' and 'auto') and context
    rotation against the exact windowed path (the step-0 window table) at
    ``--win-frames``, window batch 1;
  * with ``--long-frames`` n, the wide-window fusion at n frames.

Each row is one call, timed from staged inputs to the uint8 video on the
device (frames/s); the models run on the card unless ``--device cpu``.  A
markdown table goes to stdout, the rows as JSON to ``--out``; ``--check``
holds the rows to the stored table (``docs/quality_gate*.json``) through
``utils/quality_gate.py:check_regression`` (1.5 dB, 0.002 SSIM) and exits 1
on a regression.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from aniportrait_tpu_torch.utils.quality import psnr, ssim


def _metrics(a: np.ndarray, b: np.ndarray):
    """Mean PSNR and SSIM over the frames of two uint8 clips."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    return (float(np.mean([psnr(x, y) for x, y in zip(a, b)])),
            float(np.mean([ssim(x, y) for x, y in zip(a, b)])))


def measure(args, clips: dict | None = None) -> list:
    """The gate's rows, ``(mode, frames/s, psnr, ssim)``; each row's uint8
    clip goes into ``clips`` by mode where a dict is given."""
    import torch

    from aniportrait_tpu_torch import factory
    from aniportrait_tpu_torch.pipelines import Pose2VideoPipeline

    device = args.device
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("quality_speed_gate: no CUDA device (pass --device cpu)")
    modules = factory.build_models(args.size, device, torch.bfloat16, seed=0,
                                   init=factory.init_flax_defaults)

    def build(**kw):
        return Pose2VideoPipeline(modules, dtype=torch.bfloat16, window_batch=1, **kw)

    rs = np.random.RandomState(0)
    res = args.res
    ref = rs.randint(0, 255, (res, res, 3), np.uint8)

    def timed(pipe, poses):
        kw = dict(width=res, height=res, video_length=len(poses),
                  num_inference_steps=args.steps, guidance_scale=3.5, seed=0,
                  windowed=True, decode_chunk=8)
        staged = pipe.stage_inputs(ref, poses, res, res, device=True)
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        video = pipe(staged, None, None, return_device=True, **kw)
        if device == "cuda":
            torch.cuda.synchronize()
        return video.cpu().numpy(), len(poses) / (time.perf_counter() - t0)

    rows = []
    clips = {} if clips is None else clips

    def exact_row(name, pipe, poses):
        clips[name], fps = timed(pipe, poses)
        rows.append((name, fps, None, None))
        return clips[name]

    def compare(name, pipe, poses, exact):
        clips[name], fps = timed(pipe, poses)
        rows.append((name, fps, *_metrics(clips[name], exact)))

    if not args.skip_enc_cache:
        poses = [rs.randint(0, 255, (res, res, 3), np.uint8) for _ in range(args.frames)]
        exact = exact_row("pose2vid exact (k=1)", build(), poses)
        for k in (2, 3):
            compare(f"encoder cache k={k}", build(encoder_cache_interval=k), poses, exact)

    if not args.skip_fusion:
        poses = [rs.randint(0, 255, (res, res, 3), np.uint8) for _ in range(args.win_frames)]
        # the fixed-table exact twin: fusion cannot rotate its window table,
        # so the comparison isolates the fusion mechanism from table phase
        exact = exact_row(f"windowed exact ({args.win_frames}f)", build(context_rotate=False),
                          poses)
        compare("window fusion (motion=context)",
                build(window_fusion=True, fusion_motion="context"), poses, exact)
        compare("window fusion (auto: whole-clip)", build(window_fusion=True), poses, exact)
        # per-step window phase (not the reference's behaviour) against the
        # step-0 table
        compare("context rotate (per-step tables)", build(context_rotate=True), poses, exact)

    if args.long_frames:
        poses = [rs.randint(0, 255, (res, res, 3), np.uint8) for _ in range(args.long_frames)]
        exact = exact_row(f"windowed exact ({args.long_frames}f)", build(context_rotate=False),
                          poses)
        compare("window fusion (auto: wide windows)", build(window_fusion=True), poses, exact)
    return rows


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--win-frames", type=int, default=24)
    ap.add_argument("--long-frames", type=int, default=0,
                    help="also gate the wide-window fusion at this length "
                         "(e.g. 48, the audio2vid clip)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-enc-cache", action="store_true")
    ap.add_argument("--skip-fusion", action="store_true")
    ap.add_argument("--check", action="store_true",
                    help="hold the rows to the stored gate table (docs/quality_gate*.json); "
                         "exit 1 if any approximation's divergence regressed past the "
                         "tolerance")
    ap.add_argument("--size", choices=("full", "micro"), default="full",
                    help="model size (micro: the CPU tests' small models)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def main(argv=None, clips: dict | None = None) -> int:
    """The CLI; ``clips`` (a dict) receives each row's uint8 clip."""
    args = parse_args(argv)
    rows = measure(args, clips)
    print("| mode | frames/s | PSNR vs exact (dB) | SSIM vs exact |")
    print("|---|---|---|---|")
    report = []
    for name, fps, ps, ss in rows:
        ps_s = "—" if ps is None else f"{ps:.2f}"
        ss_s = "—" if ss is None else f"{ss:.4f}"
        print(f"| {name} | {fps:.3f} | {ps_s} | {ss_s} |")
        report.append({"mode": name, "fps": fps, "psnr": ps, "ssim": ss})
    print(f"({args.size}-size random weights, fixed seed: the approximation's numerical "
          "divergence, not perceptual quality on real weights)", file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    if args.check:
        from aniportrait_tpu_torch.utils.quality_gate import check_regression

        problems = check_regression(report)
        if problems:
            print("\nQUALITY GATE REGRESSION:", file=sys.stderr)
            for p in problems:
                print(" -", p, file=sys.stderr)
            return 1
        print("gate check OK: no divergence regression vs stored table", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
