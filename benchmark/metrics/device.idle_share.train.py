"""Share (%) of the traced window in which no operation ran on the device:
1 - (union of the kernel, copy and fill intervals) / the window's wall."""


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None or not ctx.trace.busy_s:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
