"""Generation cells: pose2vid requests, closed loop, one client, as
``serve.py``'s single worker runs them.

Set-up: the program's models (``factory.build_models``) filled with the
benchmark's weights from ``--seed``, the ``Pose2VideoPipeline`` of the
configuration's sampler, one warm-up request (its time is the estimate of
the window rule) and the window's inputs made from the seed.  Each request
is ``pipe(ref, poses, None, W, H, L, steps, cfg, seed=...)`` on host uint8
arrays and returns host frames; it takes a reference image, ``frames`` pose
maps and an initial-noise seed of its own.  After the window: with
``--trace 1`` a traced piece of ``trace_requests`` more requests; then the
program is freed and one finished request, drawn from the seed, is made
again by the plain reference (float32, TF32 off), and the frames compared.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from harness import check, common, trace, weights
from reference import pipeline as ref_pipeline
from reference.ddim import DDIMScheduler
from reference.models import set_precision
from reference.precision import FP32, no_tf32

WARMUP = 1 << 20  # the warm-up request's index in the seed's inputs


def _keep(model, generator):
    """An ``init`` that leaves the weights to :func:`load_weights`."""
    return model


def build_program(cfg: dict, device):
    from aniportrait_tpu_torch import factory
    from aniportrait_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline

    prog, s = cfg["program"], cfg["sampler"]
    dtype = getattr(torch, prog["dtype"])
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = bool(prog["tf32"])
        torch.backends.cudnn.allow_tf32 = bool(prog["tf32"])
    modules = factory.build_models(prog["size"], device, dtype, seed=0, init=_keep)
    return Pose2VideoPipeline(modules, dtype=dtype, context_frames=s["context_frames"],
                              context_stride=s["context_stride"],
                              context_overlap=s["context_overlap"],
                              window_batch=s["window_batch"])


def load_weights(pipe, cfg: dict, seed: int, device) -> None:
    for role, state in weights.iter_state_dicts(cfg["models"], seed, device):
        weights.load_into(getattr(pipe.m, role), state)


def request(cfg: dict, traffic: dict, seed: int, i: int):
    """Request ``i`` of the run: (reference image (H, W, 3), pose maps
    (L, H, W, 3), both uniform uint8, initial-noise seed)."""
    s = cfg["sampler"]
    r = common.rng(seed, 1, i)
    shape = (s["height"], s["width"], 3)
    ref = r.integers(0, 256, shape, dtype=np.uint8)
    poses = r.integers(0, 256, (traffic["frames"],) + shape, dtype=np.uint8)
    return ref, poses, common.sub_seed(seed, 2, i)


def call(pipe, cfg: dict, req) -> np.ndarray:
    """The timed entry: host uint8 arrays in, host frames out (float32
    in [0, 1], uint8 levels / 255)."""
    s = cfg["sampler"]
    ref, poses, noise_seed = req
    return pipe(ref, list(poses), None, s["width"], s["height"], len(poses),
                num_inference_steps=s["steps"], guidance_scale=s["guidance_scale"],
                seed=noise_seed, windowed=True)


def to_uint8(frames: np.ndarray) -> np.ndarray:
    return np.rint(np.asarray(frames, np.float64) * 255.0).astype(np.uint8)


def reference_frames(cfg: dict, seed: int, req, device, prec=FP32) -> np.ndarray:
    """The request made again by the plain reference in ``prec``."""
    no_tf32()
    models = weights.reference_models(cfg["models"], seed, device)
    for m in models.values():
        set_precision(m, prec)
    ref, poses, noise_seed = req
    out = ref_pipeline.generate(models, DDIMScheduler(**cfg["scheduler"]), cfg["sampler"],
                                ref, poses, noise_seed, device)
    del models
    common.free(device)
    return out


def run(ctx):
    cfg, traffic, args, dev = ctx.config, ctx.traffic, ctx.args, ctx.device
    seed, frames = args.seed, traffic["frames"]
    pipe = build_program(cfg, dev)
    load_weights(pipe, cfg, seed, dev)
    warm = request(cfg, traffic, seed, WARMUP)
    t = time.perf_counter()
    out = call(pipe, cfg, warm)
    estimate = time.perf_counter() - t
    if out.shape != warm[1].shape:
        raise SystemExit(f"pose2vid: the warm-up request gave {out.shape}")
    pool = [request(cfg, traffic, seed, i)
            for i in range(int(args.seconds / estimate) + 2)]
    common.sync(dev)
    setup_s = time.perf_counter() - ctx.t_start
    ctx.log(f"set-up {setup_s:.3f} s; warm-up request {estimate:.3f} s")

    pipe.timer.totals.clear()
    pipe.timer.counts.clear()
    common.reset_peak(dev)
    outputs, walls = [], []

    def issue(i):
        t = time.perf_counter()
        outputs.append(call(pipe, cfg, pool[i % len(pool)]))
        walls.append(time.perf_counter() - t)

    with common.HostWatch() as host:
        t0, done = common.closed_loop(issue, args.seconds, estimate)
    window_s = done[-1] - t0
    peak = common.peak_bytes(dev)
    n = len(done)
    timer = dict(pipe.timer.totals)
    failed = sum(1 for i, o in enumerate(outputs)
                 if o.shape != pool[i % len(pool)][1].shape or not np.isfinite(o).all())
    ctx.log(f"window {window_s:.4f} s: {n} requests of {frames} frames, walls "
            f"{', '.join(f'{w:.4f}' for w in walls)} s; phases {pipe.timer.report()}; "
            f"peak {peak / 2**30:.3f} GiB; {host.line()}")

    summary, launches = None, None
    if args.trace and torch.device(dev).type == "cuda":
        from aniportrait_tpu_torch.ops import kernels

        kernels.reset_launch_counts()
        with trace.Traced() as tr:
            for i in range(int(traffic["trace_requests"])):
                call(pipe, cfg, pool[i % len(pool)])
        launches = kernels.launch_counts()
        t = time.perf_counter()
        summary = trace.reduce(tr.prof, tr.window_s)
        del tr
        ctx.log(f"trace read in {time.perf_counter() - t:.1f} s")
        ctx.log(f"traced {traffic['trace_requests']} request(s): {summary.window_s:.4f} s "
                f"(untraced {window_s / n:.4f} s a request in the window), "
                f"busy {summary.busy_s:.4f} s, {summary.kernels} device operations; "
                f"families {summary.families}; launches {launches}")

    pick = int(common.rng(seed, 3).integers(n))
    program = to_uint8(outputs[pick])
    del pipe, outputs
    common.free(dev)
    t = time.perf_counter()
    reference = reference_frames(cfg, seed, pool[pick % len(pool)], dev)
    ctx.log(f"reference of request {pick}: {time.perf_counter() - t:.1f} s")
    numbers = {"frames_rmse": check.frames_rmse(program, reference)}
    correct, checks = check.verdict(numbers, traffic["limits"])
    layer = SimpleNamespace(kind="pose2vid", cfg=cfg, traffic=traffic, requests=n,
                            frames=frames, window_s=window_s, walls=walls, timer=timer,
                            trace=summary, launches=launches,
                            trace_requests=int(traffic["trace_requests"]))
    return common.outcome(
        end_to_end={"gen_frames_per_s": n * frames / window_s,
                    "peak_mem_gib": peak / 2**30, "setup_s": setup_s},
        layer=layer, correct=correct and failed == 0, checks=checks, attempted=n,
        failed=failed, memory_peak_bytes=peak, trace=summary)
