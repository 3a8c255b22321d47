"""Share (%) of the device's busy time in the traced steps spent in kernels
that are no GEMM, convolution, attention, norm or optimizer kernel: the
elementwise ops, reductions and copies (``harness/trace.py``'s families)."""

from harness.trace import ELEMENTWISE


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None or not ctx.trace.busy_s:
        return None
    return 100.0 * ctx.trace.families.get(ELEMENTWISE, 0.0) / ctx.trace.busy_s
