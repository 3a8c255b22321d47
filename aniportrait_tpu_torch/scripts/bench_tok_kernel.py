"""A/B of the token-layout flash kernels at the serving config's hot shapes.

The port of ``scripts/bench_tok_kernel.py``: the same four shapes, the same
input distribution (q ~ N(0, 1), k ~ 0.1 N(0, 1), v ~ N(0, 1), bf16, from a
seed) and the same four variants of one function, ``softmax(q k^T / sqrt(d))
v`` per head over ``(B, S, C)`` tensors:

* ``runmax``: :func:`ops.kernels.tok_flash` (K2 as the port runs it: an
  online running max);
* ``bounded``: K8, a fixed per-row shift by the Cauchy-Schwarz bound;
* ``noshift``: K7, base e with no shift;
* ``unshifted``: K2u, K2's TPU form, base 2 with no shift;

plus a fifth reference column, ``F.scaled_dot_product_attention`` on the
``(B, S, H, d)`` views (the library's time; the port never calls it).  The
fixed-shift variants carry their guard: each line says whether it held
(flag clear, the fast path's output stands) and each variant's max abs
difference from ``runmax``.  The last shape, d = 128 at the first shape's
sequence lengths, is the padding experiment of the original.

Times: a warm-up call, then the median of ``reps`` single-call timings
(CUDA events on a GPU; the host clock on the CPU, which times the plain
versions and says nothing of a GPU).

    python -m aniportrait_tpu_torch.scripts.bench_tok_kernel
    python -m aniportrait_tpu_torch.scripts.bench_tok_kernel --device cpu --tiny

Exits nonzero without a GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import math
import statistics
import sys
import time

import torch
import torch.nn.functional as F

from aniportrait_tpu_torch.ops import kernels as K
from aniportrait_tpu_torch.ops.kernels.flash import cauchy_schwarz_bound, scaled_in_dtype

# name -> (batch, sq, skv, heads, d)
SHAPES = {
    "cond 4096q/8192kv d40": (16, 4096, 8192, 8, 40),
    "uncond 4096q/4096kv d40": (16, 4096, 4096, 8, 40),
    "res2 1024q/3072kv d80": (16, 1024, 3072, 8, 80),
    "padding-exp 4096q/8192kv d128": (16, 4096, 8192, 8, 128),
}
TINY = {"tiny 40q/50kv d8": (2, 40, 50, 2, 8)}

VARIANTS = {
    "runmax": K.tok_flash,
    "bounded": K.tok_flash_bounded,
    "noshift": K.tok_flash_noshift,
    "unshifted": K.tok_flash_unshifted,
}


def _median_ms(fn, reps: int, device: str) -> float:
    fn()  # warm-up
    times = []
    for _ in range(reps):
        if device == "cpu":
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
            continue
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def inputs(shape, device: str):
    """q, k, v of one shape in the original's distribution, bf16, from
    seed 0."""
    b, sq, skv, heads, d = shape
    c = heads * d
    gen = torch.Generator(device=device).manual_seed(0)

    def randn(*s, scale=1.0):
        x = torch.randn(*s, generator=gen, device=device, dtype=torch.float32)
        return (x * scale).to(torch.bfloat16)

    return randn(b, sq, c), randn(b, skv, c, scale=0.1), randn(b, skv, c)


def run(device: str = "cuda", shapes: dict = SHAPES, reps: int = 5,
        log=print) -> list[dict]:
    """Time the four variants and the library call at each shape; returns
    one dict per shape: ``ms``, ``guard_held`` and ``max_abs_diff`` per
    variant, ``runmax_max_abs`` (the largest |output|), ``sdpa_ms``, ``cs_bound_ms`` (K8's Cauchy-Schwarz bound alone),
    ``best`` and its useful TFLOP/s."""
    results = []
    for name, shape in shapes.items():
        b, sq, skv, heads, d = shape
        q, k, v = inputs(shape, device)
        ref = None
        row = dict(name=name, shape=shape, device=device, ms={}, guard_held={},
                   max_abs_diff={})
        for vname, fn in VARIANTS.items():
            out = fn(q, k, v, heads)
            if ref is None:
                ref = out.float()
                row["runmax_max_abs"] = ref.abs().max().item()
            row["max_abs_diff"][vname] = (out.float() - ref).abs().max().item()
            guard = getattr(fn, "last_guard", None)
            row["guard_held"][vname] = None if guard is None else guard.item() == 0
            del out
            row["ms"][vname] = _median_ms(lambda fn=fn: fn(q, k, v, heads), reps, device)
        views = [x.view(b, x.shape[1], heads, d).transpose(1, 2) for x in (q, k, v)]
        row["sdpa_ms"] = _median_ms(lambda: F.scaled_dot_product_attention(*views),
                                    reps, device)
        qs = scaled_in_dtype(q, math.log2(math.e) / math.sqrt(d))
        row["cs_bound_ms"] = _median_ms(lambda: cauchy_schwarz_bound(qs, k, heads), reps,
                                        device)
        flops = 4.0 * b * heads * sq * skv * d
        best = min(row["ms"], key=row["ms"].get)
        row["best"], row["best_tflops"] = best, flops / row["ms"][best] / 1e9
        cols = " | ".join(
            f"{v} {row['ms'][v]:.3f} ms (guard "
            f"{'-' if row['guard_held'][v] is None else 'held' if row['guard_held'][v] else 'TRIPPED'}"
            f", max|diff| {row['max_abs_diff'][v]:.3e})" for v in VARIANTS)
        log(f"[tok-ab] {name} on {device}: {cols} | sdpa {row['sdpa_ms']:.3f} ms | "
            f"C-S bound {row['cs_bound_ms']:.3f} ms | best {best} "
            f"({row['best_tflops']:.1f} useful TF/s)")
        results.append(row)
        del q, k, v, qs, ref, views
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--tiny", action="store_true",
                        help="one tiny shape in place of the four hot shapes")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_tok_kernel: no CUDA device (pass --device cpu to run the plain "
              "versions on the CPU)", file=sys.stderr)
        return 2
    if args.device == "cuda":
        print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    run(args.device, TINY if args.tiny else SHAPES, args.reps,
        log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
