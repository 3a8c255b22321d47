"""One run of one cell:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic mix and metrics are found by name
(``manifest.py``); the mix's ``kind`` names the driver that sets up the
program, runs the closed-loop window, the traced piece (``--trace 1``) and
the comparison with the plain reference.  The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit (also the last lines of
standard error).  Without a CUDA device, or with fewer than the cell asks
for, it exits with 2 and prints no result; with JAX or the JAX package
loaded once the window has closed, with 3.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from types import SimpleNamespace

from . import manifest as mf

FORBIDDEN = ("jax", "jaxlib", "flax", "aniportrait_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    port's own kernel library builds into ``build/kernels`` there)."""
    base = mf.ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ.setdefault("USE_FLAX", "0")


def kernel_library() -> str:
    """Build the port's kernel library (in a checkout's first run only: it is
    kept in ``build/kernels`` there, keyed by a hash of its sources) or load
    it, before the driver's set-up would; says which, and how long.  Both
    count in ``setup_s``, as a compilation does in a run that compiles."""
    import time

    from aniportrait_tpu_torch.ops.kernels import build

    t = time.perf_counter()
    built = not any(build.BUILD_DIR.glob(f"*_{build.source_hash()}.so"))
    build.library()
    return f"kernel library {'built' if built else 'loaded'} in {time.perf_counter() - t:.3f} s"


def result_line(cell, out, trace: int, manifest, device_kind: str) -> dict:
    if trace:
        metrics = {}
        for m in mf.cell_metrics(manifest, cell, "per_layer"):
            value = mf.metric_reader(m["name"])(out.layer)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(out.end_to_end[m["name"]]), "unit": m["unit"]}
                   for m in mf.cell_metrics(manifest, cell, "end_to_end")}
    device = {"platform": "gpu", "kind": device_kind,
              "count": int(cell["chips"]), "memory_peak_bytes": int(out.memory_peak_bytes)}
    line = {"correct": bool(out.correct), "attempted": int(out.attempted),
            "failed": int(out.failed), "metrics": metrics, "device": device}
    if trace and out.trace is not None:
        device["busy_s"] = out.trace.busy_s
        device["window_s"] = out.trace.window_s
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = out.checks
    return line


def main(argv=None, t_start: float | None = None) -> int:
    import time

    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    manifest = mf.load_manifest()
    cell = mf.workload(manifest, args.workload)
    cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"benchmark: the cell needs {cell['chips']} CUDA device(s); "
            f"available: {torch.cuda.is_available()}, count "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"card: {card_line()}")
    log(kernel_library())
    traffic = mf.traffic(cell["traffic"])
    ctx = SimpleNamespace(args=args, cell=cell, config=mf.config(manifest, cell["config"]),
                          traffic=traffic, t_start=t_start, device="cuda", log=log)
    out = mf.driver(traffic["kind"]).run(ctx)
    found = forbidden_modules()
    if found:
        log(f"benchmark: modules of JAX or the JAX package are loaded: {found}")
        return 3
    line = result_line(cell, out, args.trace, manifest, torch.cuda.get_device_name(0))
    for name, c in out.checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0
