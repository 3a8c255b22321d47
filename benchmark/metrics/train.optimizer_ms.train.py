"""Device milliseconds per step of the optimizer's kernels (the
``multi_tensor``, ``foreach`` and ``adam`` families) in the traced steps."""


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None or "optimizer" not in ctx.trace.families:
        return None
    return ctx.trace.families["optimizer"] / ctx.trace_steps * 1e3
