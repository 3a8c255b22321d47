"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a fixed
piece of work, with device activity only (the CUDA runtime calls beside
it), or with host activity too where a driver needs its host ranges.
Recording every host operation lengthens a dispatch-bound piece, so the
window, and the idle share read from it, would be the profiler's more than
the program's.  Reduced to

* device busy seconds: the union of the intervals in which a kernel, copy
  or fill ran (overlapping operations on two streams count once);
* device seconds by family (kernel names, as ``chip_smoke.py``'s
  ``_profile_families`` classifies them; attention first, so that a
  library attention kernel is not taken for a GEMM), with the kernels that
  run inside a named host range (the port's ``K3 plain backward``, K3's
  backward as plain autograd) counted to attention;
* the longest idle gaps, each named by the innermost host operation (with
  device activity only: the CUDA runtime call) that was running when the
  device went idle.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch

ATTENTION = "attention"
ELEMENTWISE = "elementwise, reductions, copies"
FAMILIES = (
    (ATTENTION, ("flash_", "temporal_kernel", "ctg_kernel", "ssa_kernel", "fmha",
                 "sdpa", "attention")),
    ("GEMM", ("gemm", "cutlass", "xmma", "cublas", "matmul", "nvjet")),
    ("convolution", ("conv", "cudnn", "implicit", "winograd", "fft", "dgrad", "wgrad")),
    ("norm", ("norm",)),
    ("optimizer", ("multi_tensor", "foreach", "adam")),
)


def family(kernel_name: str) -> str:
    name = kernel_name.lower()
    return next((f for f, keys in FAMILIES if any(k in name for k in keys)), ELEMENTWISE)


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    families: dict = field(default_factory=dict)
    idle_gaps: list = field(default_factory=list)
    kernels: int = 0

    def breakdown(self, n: int = 10) -> dict:
        ops = sorted(self.families.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in self.idle_gaps[:n]]}


def _merge(intervals):
    """Sorted (start, end) pairs -> their union as disjoint sorted pairs."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def reduce(prof, window_s: float, attention_ranges=(), n_gaps: int = 10) -> TraceSummary:
    """Summarise a finished ``torch.profiler.profile``; ``attention_ranges``:
    names of host ranges whose device-side kernels are attention work."""
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    host, device = [], []
    for e in events:
        (device if e.device_type() == cuda else host).append(e)
    host_names = {e.name() for e in host}
    ranges = sorted((e.start_ns(), e.end_ns()) for e in device
                    if e.name() in attention_ranges)
    starts = [a for a, _ in ranges]
    ops, families = [], {}
    for e in device:
        name = e.name()
        if name in host_names or e.is_user_annotation():
            continue  # the device copy of a host range, not an operation
        a, b = e.start_ns(), e.end_ns()
        if b <= a:
            continue
        i = bisect.bisect_right(starts, a) - 1
        fam = ATTENTION if i >= 0 and b <= ranges[i][1] else family(name)
        families[fam] = families.get(fam, 0.0) + (b - a) / 1e9
        ops.append((a, b))
    busy = _merge(ops)
    busy_s = sum(b - a for a, b in busy) / 1e9
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1]) for i in range(len(busy) - 1)),
                  reverse=True)[:n_gaps]
    spans = sorted((e.start_ns(), e.end_ns(), e.name()) for e in host if e.end_ns() > e.start_ns())
    named = []
    for length, at in gaps:
        inner = [(b - a, n) for a, b, n in spans[:bisect.bisect_right(spans, (at, 1 << 62, ""))]
                 if a <= at < b]
        named.append([min(inner)[1] if inner else "no host operation", length / 1e9])
    return TraceSummary(window_s=window_s, busy_s=busy_s, families=families,
                        idle_gaps=named, kernels=len(ops))


class Traced:
    """``with Traced() as t: work()`` profiles ``work`` (device activity;
    with ``host=True`` host operations and ranges too) between two device
    synchronisations; ``t.prof`` and ``t.window_s`` after the block."""

    def __init__(self, host: bool = False):
        self.host = host

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if self.host else [])
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        return False
