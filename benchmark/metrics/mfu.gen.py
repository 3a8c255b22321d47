"""Model FLOPs of the window's completed requests over (window seconds x
989 TFLOP/s), in %: the whole request's share of the card's bf16 peak.  The
FLOPs are the benchmark's own count at the cell's shapes (``harness/
work.py``: the plain reference on ``meta`` tensors)."""

from harness import work


def read(ctx):
    if ctx.kind != "pose2vid":
        return None
    s = ctx.cfg["sampler"]
    flops = work.request_work(ctx.cfg["models"], s, ctx.frames, s["height"],
                              s["width"])["flops"]
    return 100.0 * flops * ctx.requests / (ctx.window_s * work.PEAK_FLOPS_BF16)
