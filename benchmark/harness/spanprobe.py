"""A cell's run with the program's tracer on, on the card: the cost of the
tracer, and the readings of the span-based readers beside the device trace.

The drivers keep the tracer off in every run (``--trace 0`` and ``1``), so
``setup.*``, ``pipeline.glue_device_s.gen`` and the ``.train`` span readers
find nothing there; this runs a cell's program as its driver does, with
the tracer switched on before the models are built, and reports:

* ``cost``: the same requests (steps) with the tracer off and on in turns
  (off, on, on, off, ...), each side's seconds and their ratio;
* ``metrics``: every per-layer reader of the cell's kind, fed the tracer's
  record (``spans``) and the traced piece's operations put to their spans
  (``span_ops``, ``harness/spans.py``);
* ``idle``: the traced piece's idle time, the share of it that begins inside
  a span of the main thread, its seconds by span path, and the longest gaps
  named by span; with host activity (training), the blocking runtime calls
  a step by span path and host operation, beside the ``host_syncs`` counter.

    python3 benchmark/harness/spanprobe.py --workload pose2vid-512.f16 --seed 7 \\
        --pairs 3 --out chiprun_out/spanprobe.f16.json
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parents[2])]

from harness import cli, common, spans, trace  # noqa: E402
from harness import manifest as mf  # noqa: E402
from harness.trace import _merge  # noqa: E402

METRICS = Path(__file__).resolve().parents[1] / "metrics"
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy", "cuStreamSynchronize", "cuCtxSynchronize")


def readers() -> dict:
    """Every metric file's reader (each returns None for a ctx of another
    kind)."""
    return {p.stem: mf.metric_reader(p.stem) for p in sorted(METRICS.glob("*.py"))}


def toggled(turns: int):
    """off, on, on, off, off, on, ...: ``turns`` pairs, each side first in
    half of them."""
    for k in range(turns):
        yield from ((False, True) if k % 2 == 0 else (True, False))


def idle_report(host, device, record, n: int = 10) -> dict:
    busy = _merge((d.start, d.end) for d in device)
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    index = spans._SpanIndex(record)
    by_path, inside = {}, 0
    for a, b in gaps:
        i = index.open_on(record.main_thread, a)
        path = record.path(i) if i is not None else "(no span)"
        by_path[path] = by_path.get(path, 0) + (b - a)
        inside += (b - a) if i is not None else 0
    total = sum(b - a for a, b in gaps)
    top = sorted(by_path.items(), key=lambda kv: -kv[1])[:n]
    return {"idle_s": total / 1e9, "inside_span_share": inside / total if total else None,
            "by_span_s": [[p, v / 1e9] for p, v in top],
            "gaps": spans.idle_gaps(host, device, record, n)}


def by_path(record, root: int, depth: int = 3) -> dict:
    """Seconds by span path of the spans that carry ``root``, down to
    ``depth`` names; with each path's self seconds (less its children)."""
    out = {}
    for i, s in enumerate(record.spans):
        path = record.path(i)
        if s.root != root or path.count("/") >= depth:
            continue
        total, own = out.get(path, (0.0, 0.0))
        kids = sum(record.spans[j].seconds for j in record.children(i))
        out[path] = (total + s.seconds, own + s.seconds - kids)
    return out


def setup_report(record, name: str, builds=("build_models", "build_training_models")):
    """Set-up's build by span path, and the first root ``name`` against the
    median of the later ones, path by path."""
    first_build = min(i for b in builds for i in record.roots(b))
    roots = record.roots(name)
    later = [by_path(record, i, 2) for i in roots[1:]]
    first = by_path(record, roots[0], 2)
    return {"build": {k: [v[0], v[1]] for k, v in by_path(record, first_build, 4).items()},
            "first_call": {k: [v[0], statistics.median(d.get(k, (0.0, 0.0))[0] for d in later)]
                           for k, v in first.items()}}


def sync_report(host, record, steps: int) -> dict:
    """Blocking runtime calls a step, by span path and the innermost host
    operation around the call."""
    index = spans._SpanIndex(record)
    ops = sorted((h for h in host if not h.name.startswith("cu")), key=lambda h: h.start)
    found = {}
    for h in host:
        if h.name not in SYNC_CALLS:
            continue
        i = index.at(h.start)
        around = [o for o in ops if o.start <= h.start and h.end <= o.end]
        op = min(around, key=lambda o: o.end - o.start).name if around else "-"
        key = f"{record.path(i) if i is not None else '(no span)'} | {op} | {h.name}"
        found[key] = found.get(key, 0) + 1
    return {"per_step": {k: v / steps for k, v in sorted(found.items())},
            "calls_per_step": sum(found.values()) / steps}


def gen(ctx, pairs: int, tracer) -> dict:
    from aniportrait_tpu_torch.ops import kernels

    drv = mf.driver("pose2vid")
    cfg, traffic, seed, dev = ctx.config, ctx.traffic, ctx.args.seed, ctx.device
    pipe = drv.build_program(cfg, dev)
    drv.load_weights(pipe, cfg, seed, dev)
    t = time.perf_counter()
    drv.call(pipe, cfg, drv.request(cfg, traffic, seed, drv.WARMUP))
    ctx.log(f"first request {time.perf_counter() - t:.3f} s")
    pool = [drv.request(cfg, traffic, seed, i) for i in range(pairs)]
    walls = {False: [], True: []}
    pipe.timer.totals.clear()
    pipe.timer.counts.clear()
    on_walls, n_on = [], 0
    for k, on in enumerate(toggled(pairs)):
        tracer.on = on
        before = dict(pipe.timer.totals)
        t = time.perf_counter()
        drv.call(pipe, cfg, pool[k // 2])
        walls[on].append(time.perf_counter() - t)
        if not on:  # the window's phases: the requests made with the tracer on
            pipe.timer.totals.clear()
            pipe.timer.totals.update(before)
        else:
            on_walls.append(walls[on][-1])
            n_on += 1
    timer = dict(pipe.timer.totals)
    tracer.on = True
    kernels.reset_launch_counts()
    before = len(tracer.record().spans)
    with trace.Traced() as tr:
        drv.call(pipe, cfg, pool[0])
    record = tracer.record()
    host, device = spans.events_of(tr.prof)
    summary = trace.reduce(tr.prof, tr.window_s)
    ops = spans.attribute(host, device, record)
    traced_roots = [i for i in record.roots("request") if i >= before]
    layer = SimpleNamespace(kind="pose2vid", cfg=cfg, traffic=traffic, requests=n_on,
                            frames=traffic["frames"], window_s=sum(on_walls), walls=on_walls,
                            timer=timer, trace=summary, launches=kernels.launch_counts(),
                            trace_requests=1, spans=record, span_ops=ops)
    phases = {k: v / n_on for k, v in timer.items()}
    return {"walls": walls, "layer": layer, "phases_per_request": phases,
            "setup": setup_report(record, "request"),
            "idle": idle_report(host, device, record),
            "ops_without_span": sum(op.span is None for op in ops), "ops": len(ops),
            "traced_request_s": [record.spans[i].seconds for i in traced_roots]}


def train_cell(ctx, pairs: int, tracer, block: int = 5) -> dict:
    from aniportrait_tpu_torch.ops import kernels
    from aniportrait_tpu_torch.train.stage2 import train

    drv = mf.driver("train")
    cfg, traffic, seed, dev = ctx.config, ctx.traffic, ctx.args.seed, ctx.device
    settings, modules, trainable, opt = drv.build_program(cfg, seed, dev)
    pool = drv.batch_pool(cfg, traffic, seed, dev, modules.clip.image_size)
    first = train(settings, modules, iter(pool[:3]), max_steps=3, device=dev, optimizer=opt)
    ctx.log(f"first steps {[h['seconds'] for h in first]}")
    seconds = {False: [], True: []}
    for k, on in enumerate(toggled(pairs)):
        tracer.on = on
        hist = train(settings, modules, (pool[(k + i) % len(pool)] for i in range(block)),
                     max_steps=block, device=dev, optimizer=opt)
        seconds[on] += [h["seconds"] for h in hist]
    tracer.on = True
    n_trace = int(traffic["trace_steps"])
    kernels.reset_launch_counts()
    before = len(tracer.record().spans)
    with trace.Traced(host=True) as tr:
        train(settings, modules, (pool[i % len(pool)] for i in range(n_trace)),
              max_steps=n_trace, device=dev, optimizer=opt)
    record = tracer.record()
    host, device = spans.events_of(tr.prof)
    summary = trace.reduce(tr.prof, tr.window_s, attention_ranges=(drv.K3_BACKWARD_RANGE,))
    ops = spans.attribute(host, device, record)
    traced = [i for i in record.roots("step") if i >= before]
    layer = SimpleNamespace(kind="train", cfg=cfg, traffic=traffic,
                            steps=len(seconds[True]), window_s=sum(seconds[True]),
                            trace=summary, launches=kernels.launch_counts(),
                            trace_steps=n_trace,
                            optimizer_state_bytes=drv.optimizer_state_bytes(opt),
                            dropout=drv.dropout_flags(settings, cfg, n_trace, dev),
                            spans=record, span_ops=ops)
    by_span = {}
    for op in ops:
        key = "/".join(record.path(op.span).split("/")[:2]) if op.span is not None else "-"
        by_span[key] = by_span.get(key, 0) + (op.end - op.start) / 1e9 / n_trace
    return {"walls": seconds, "layer": layer, "setup": setup_report(record, "step"),
            "idle": idle_report(host, device, record),
            "syncs": sync_report(host, record, n_trace),
            "host_syncs_counted": [record.count_under(i, "host_syncs") for i in traced],
            "device_s_by_span": sorted(by_span.items(), key=lambda kv: -kv[1]),
            "ops_without_span": sum(op.span is None for op in ops), "ops": len(ops),
            "traced_step_s": [record.spans[i].seconds for i in traced]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    t_start = time.perf_counter()
    manifest = mf.load_manifest()
    cell = mf.workload(manifest, args.workload)
    cli.cache_dirs()
    import torch

    if not torch.cuda.is_available():
        cli.log("spanprobe: needs a CUDA device")
        return 2
    from aniportrait_tpu_torch.utils.profiling import TRACER

    cli.log(f"card: {cli.card_line()}")
    cli.log(cli.kernel_library())
    traffic = mf.traffic(cell["traffic"])
    ctx = SimpleNamespace(args=args, cell=cell, config=mf.config(manifest, cell["config"]),
                          traffic=traffic, t_start=t_start, device="cuda", log=cli.log)
    TRACER.start()
    try:
        run = gen if traffic["kind"] == "pose2vid" else train_cell
        out = run(ctx, args.pairs, TRACER)
    finally:
        TRACER.stop()
    layer = out.pop("layer")
    values = {}
    for name, read in readers().items():
        v = read(layer)
        if v is not None:
            values[name] = float(v)
    walls = out.pop("walls")
    off, on = statistics.median(walls[False]), statistics.median(walls[True])
    line = {"workload": args.workload, "seed": args.seed, "card": cli.card_line(),
            "cost": {"off_s": walls[False], "on_s": walls[True], "median_off_s": off,
                     "median_on_s": on, "on_over_off": on / off},
            "metrics": values, **out}
    text = json.dumps(line, default=float)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    common.free("cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
