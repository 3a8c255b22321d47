"""Share (%) of their roofline that the attention kernels reach in the
traced requests: the least time of every attention call of a request
(``harness/work.py``, counted from the model's shapes, whatever implements
the call), times the requests, over the device time of every attention
kernel in the trace (the port's ``flash_*``, ``temporal_*``, ``ctg_*``,
``ssa_*`` and the library's flash, fmha and cuDNN attention)."""

from harness import work
from harness.trace import ATTENTION


def read(ctx):
    if ctx.kind != "pose2vid" or ctx.trace is None or not ctx.trace.families.get(ATTENTION):
        return None
    s = ctx.cfg["sampler"]
    calls = work.request_work(ctx.cfg["models"], s, ctx.frames, s["height"],
                              s["width"])["attention_calls"]
    least = work.attention_least_seconds(calls) * ctx.trace_requests
    return 100.0 * least / ctx.trace.families[ATTENTION]
