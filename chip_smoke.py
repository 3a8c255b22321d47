#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``aniportrait_tpu_torch``) on one GPU.

    python3 chip_smoke.py                  # all phases (what CI runs)
    python3 chip_smoke.py --phase kernels  # only the kernel phase

Phases, each of which fails the run (nonzero exit) on any error:

1. kernels: build the CUDA kernels from ``aniportrait_tpu_torch/csrc`` and
   hold each of K1-K4 against its plain PyTorch version at the main path's
   widths, in bf16 and float32, with the tolerances below; time both.
2. reference: the micro model at 256 px, 8 frames, 2 steps, float32, run
   through the pipeline on the GPU (kernels) and on the CPU (plain
   versions) from the same weights and latents; the final latents must
   agree.
3. pipeline: the full-size model (random bf16 weights from a seed) through
   ``Pose2VideoPipeline`` at 512x512, 16 frames, 25 DDIM steps, CFG 3.5:
   two requests with different inputs and seeds.  Every kernel must have
   launched during this phase.

The last line of standard output is the device summary JSON; the line before
it lists the kernels.  Without a CUDA device the script exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

# (max abs error, relative L2 error) allowed against the plain version.
# float32: both sides accumulate in float32 and differ only in summation
# order.  bf16: both sides compute in float32 from the same bf16 inputs and
# round the output to bf16 (8 significant bits: the step is 2^-7 of the
# binade, up to 2^-7 of the largest output); a difference in the last
# float32 place can flip that rounding by one step, so the max abs error is
# bounded by 2^-6 (two steps) of the largest |plain output|.
TOLERANCE = {"float32": (1e-4, 1e-5), "bfloat16": (2.0 ** -6, 5e-3)}
REF_LATENT_ATOL = 1e-3  # phase 2: float32 pipeline, GPU kernels vs CPU plain

SOURCES = {
    "K1": ("tok_flash_banked", "aniportrait_tpu_torch/csrc/flash_attn.cu",
           "aniportrait_tpu/ops/pallas_attention.py:1493"),
    "K2": ("tok_flash", "aniportrait_tpu_torch/csrc/flash_attn.cu",
           "aniportrait_tpu/ops/pallas_attention.py:1043"),
    "K3": ("nat_temporal", "aniportrait_tpu_torch/csrc/temporal_attn.cu",
           "aniportrait_tpu/ops/pallas_attention.py:2018"),
    "K4": ("flash_attention", "aniportrait_tpu_torch/csrc/flash_attn.cu",
           "aniportrait_tpu/ops/pallas_attention.py:294"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ kernels
def _time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _chunked(plain, n_rows: int, chunk: int):
    """Run a plain version over row chunks (its float32 logits at the main
    path's full batch would take tens of GB); ``plain(lo, hi)``."""
    import torch

    return lambda: torch.cat(
        [plain(lo, min(lo + chunk, n_rows)) for lo in range(0, n_rows, chunk)]
    )


def kernel_cases(dtype):
    """(kernel id, label, kernel call, plain call) at main-path widths."""
    import torch

    from aniportrait_tpu_torch.ops import kernels as K
    from aniportrait_tpu_torch.ops.kernels import flash, temporal

    g = torch.Generator(device="cuda").manual_seed(0)
    rand = lambda *s: torch.randn(*s, generator=g, device="cuda", dtype=dtype)
    cases = []

    # K1: cond CFG half at 64x64: 16 frame rows over self + one bank row
    b, s, c, h, rep = 16, 4096, 320, 8, 16
    q, k, v = rand(b, s, c), rand(b, s, c), rand(b, s, c)
    kb, vb = rand(b // rep, s, c), rand(b // rep, s, c)
    x = (q, k, v, kb, vb)
    cases.append(("K1", f"B={b} S={s} S_bank={s} C={c} H={h} rep={rep}",
                  lambda x=x: K.tok_flash_banked(*x, h, rep),
                  _chunked(lambda lo, hi, x=x: flash.plain_tok_flash_banked(
                      x[0][lo:hi], x[1][lo:hi], x[2][lo:hi],
                      x[3][lo // rep:lo // rep + 1], x[4][lo // rep:lo // rep + 1],
                      h, hi - lo), b, 4)))

    # K2: uncond half at 64x64 (d=40) and the c=640 concat call (d=80)
    for b, sq, skv, c in ((16, 4096, 4096, 320), (16, 1024, 2048, 640)):
        q, k, v = rand(b, sq, c), rand(b, skv, c), rand(b, skv, c)
        cases.append(("K2", f"B={b} Sq={sq} Skv={skv} C={c} H={h}",
                      (lambda q=q, k=k, v=v: K.tok_flash(q, k, v, h)),
                      _chunked(lambda lo, hi, q=q, k=k, v=v: flash.plain_tok_flash(
                          q[lo:hi], k[lo:hi], v[lo:hi], h), b, 4)))

    # K3: every motion module width, f = 16, CFG rows b = 2
    for s, c in ((4096, 320), (1024, 640), (256, 1280)):
        f, bb = 16, 2
        x = [rand(bb * f, s, c) for _ in range(3)]
        sc = math.log2(math.e) / math.sqrt(c // h)
        cases.append(("K3", f"b={bb} f={f} s={s} C={c} H={h} d={c // h}",
                      (lambda x=x, sc=sc: K.nat_temporal(*x, f, h, sc)),
                      (lambda x=x, sc=sc: temporal.plain_nat_temporal(
                          *x, f, h, sc * temporal.LN2))))

    # K4: PoseGuider stage-0 transformer (16 frames, 1024 tokens, 16 x 88);
    # with drop rows: 2048 keys, alternate rows see only the first 1024
    b, s, hh, d = 16, 1024, 16, 88
    q = rand(b, s, hh, d)
    for skv, drop, split in ((s, None, None),
                             (2 * s, torch.arange(b, device="cuda") % 2 == 1, s)):
        k, v = rand(b, skv, hh, d), rand(b, skv, hh, d)
        label = f"B={b} S={s} Skv={skv} H={hh} d={d}" + (
            f" drop_tail kv_split={split}" if drop is not None else "")
        cases.append(("K4", label,
                      (lambda q=q, k=k, v=v, drop=drop, split=split:
                       K.flash_attention(q, k, v, drop, split)),
                      _chunked(lambda lo, hi, q=q, k=k, v=v, drop=drop, split=split:
                               flash.plain_attention_bshd(
                                   q[lo:hi], k[lo:hi], v[lo:hi],
                                   None if drop is None else drop[lo:hi], split),
                               b, 4)))
    return cases


def kernel_phase(results: dict) -> None:
    import torch

    from aniportrait_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    build.library()
    log(f"[kernels] built {build.BUILD_DIR} in {time.perf_counter() - t0:.1f} s "
        f"from {', '.join(p.name for p in build.sources())}")
    for line in (build.BUILD_DIR / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"[ptxas] {line.strip()}")
    failed = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        atol, rtol = TOLERANCE[name]
        for kid, label, run, plain in kernel_cases(dtype):
            got = run()
            torch.cuda.synchronize()
            ref = plain()
            diff = (got.float() - ref.float())
            max_abs = diff.abs().max().item()
            rel_l2 = (diff.norm() / ref.float().norm().clamp_min(1e-30)).item()
            finite = bool(torch.isfinite(got).all())
            bound = atol * ref.float().abs().max().item() if dtype == torch.bfloat16 else atol
            ok = finite and max_abs <= bound and rel_l2 <= rtol
            ms = _time_ms(run, 5)
            plain_ms = _time_ms(plain, 2)
            log(f"[kernels] {kid} {name} {label}: max_abs_err={max_abs:.3e} "
                f"rel_l2={rel_l2:.3e} (tol {bound:.3g}/{rtol:g}) kernel {ms:.3f} ms "
                f"plain {plain_ms:.3f} ms {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"{kid} {name} {label}")
            if kid not in results and name == "bfloat16":
                results[kid] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms)
            del got, ref, diff
        torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"kernel phase failed: {failed}")


# ---------------------------------------------------------------- reference
def reference_phase() -> None:
    """Micro model, 256 px, 8 frames, 2 steps, float32: GPU (kernels) vs CPU
    (plain versions) from the same weights, inputs and initial latents."""
    import numpy as np
    import torch

    from aniportrait_tpu_torch import factory
    from aniportrait_tpu_torch.ops import kernels as K
    from aniportrait_tpu_torch.pipelines import Pose2VideoPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res, frames, steps = 256, 8, 2
    rs = np.random.RandomState(3)
    ref = rs.randint(0, 255, (res, res, 3), np.uint8)
    poses = [rs.randint(0, 255, (res, res, 3), np.uint8) for _ in range(frames)]
    lat0 = rs.randn(1, frames, res // 8, res // 8, 4).astype(np.float32)
    cpu_modules = factory.build_models("micro", "cpu", torch.float32, seed=0)
    out = {}
    K.reset_launch_counts()
    for device, modules in (("cuda", cpu_modules.to("cuda")), ("cpu", cpu_modules)):
        pipe = Pose2VideoPipeline(modules, dtype=torch.float32)
        ref_u8, clip_u8, pose_u8 = pipe.stage_inputs(ref, poses, res, res)
        ctx, _, banks = pipe._encode_reference(ref_u8, clip_u8)
        pose_fea = pipe._pose_features(pose_u8)
        sampler = pipe._build_sampler(frames, res // 8, res // 8, steps, 3.5, True)
        lat = sampler(torch.from_numpy(lat0).to(device), ctx, banks, pose_fea)
        out[device] = lat.cpu().numpy()
    counts = K.launch_counts()
    err = float(np.abs(out["cuda"] - out["cpu"]).max())
    log(f"[reference] micro {res}px {frames}f {steps} steps float32: final latents "
        f"max |gpu - cpu| = {err:.3e} (tol {REF_LATENT_ATOL:g}); kernel "
        f"launches on the GPU run {counts}")
    if not np.isfinite(out["cuda"]).all() or err > REF_LATENT_ATOL:
        raise SystemExit("reference phase failed: GPU pipeline disagrees with CPU")
    missing = [k for k in ("K1", "K2", "K3") if counts[k] == 0]
    if missing:
        raise SystemExit(f"reference phase: kernels {missing} never launched")


# ----------------------------------------------------------------- pipeline
def pipeline_phase(results: dict) -> None:
    import numpy as np
    import torch

    from aniportrait_tpu_torch import factory
    from aniportrait_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    res, frames, steps = 512, 16, 25
    t0 = time.perf_counter()
    pipe = factory.build_pipeline("full", device="cuda", dtype=torch.bfloat16,
                                  seed=0)
    torch.cuda.synchronize()
    log(f"[pipeline] full-size models built on the GPU in "
        f"{time.perf_counter() - t0:.1f} s")
    requests = []
    for seed in (0, 1):
        rs = np.random.RandomState(100 + seed)
        ref = rs.randint(0, 255, (res, res, 3), np.uint8)
        poses = [rs.randint(0, 255, (res, res, 3), np.uint8) for _ in range(frames)]
        requests.append((ref, poses, seed))

    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    videos = []
    for i, (ref, poses, seed) in enumerate(requests):
        pipe.timer.totals.clear()
        pipe.timer.counts.clear()
        t0 = time.perf_counter()
        video = pipe(ref, poses, None, width=res, height=res, video_length=frames,
                     num_inference_steps=steps, guidance_scale=3.5, seed=seed,
                     decode_chunk=8)
        dt = time.perf_counter() - t0
        videos.append(video)
        log(f"[pipeline] request {i} (seed {seed}): {dt:.2f} s, "
            f"{frames / dt:.3f} frames/s; phases {pipe.timer.report()}")
        if video.shape != (frames, res, res, 3):
            raise SystemExit(f"pipeline: output shape {video.shape}")
        if not np.isfinite(video).all() or video.min() < 0 or video.max() > 1:
            raise SystemExit("pipeline: output not finite in [0, 1]")
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[pipeline] {res}x{res}, {frames} frames, {steps} steps, CFG 3.5, bf16: "
        f"peak device memory {peak:.2f} GiB; kernel launches {counts}")
    if np.array_equal(videos[0], videos[1]):
        raise SystemExit("pipeline: two different requests gave the same video")
    never = [k for k, n in counts.items() if n == 0]
    if never:
        raise SystemExit(f"pipeline: kernels {never} never launched on the main path")
    for kid, n in counts.items():
        results.setdefault(kid, {})["launches"] = n


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phase", choices=("all", "kernels"), default="all")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 2
    log(gpu_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    results: dict = {}
    kernel_phase(results)
    if args.phase == "all":
        reference_phase()
        pipeline_phase(results)
    kernels = [
        dict(name=f"{kid} {SOURCES[kid][0]}", route="cuda", source=SOURCES[kid][1],
             replaces=SOURCES[kid][2], launches=results[kid].get("launches", 0),
             max_abs_err=results[kid]["max_abs_err"], ms=results[kid]["ms"],
             plain_ms=results[kid]["plain_ms"])
        for kid in sorted(SOURCES)
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
