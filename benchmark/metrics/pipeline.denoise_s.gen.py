"""Seconds of the ``denoise`` phase per request over the window (the
pipeline's ``PhaseTimer``, which synchronises the compute stream at the
phase's end)."""


def read(ctx):
    if ctx.kind != "pose2vid" or "denoise" not in ctx.timer:
        return None
    return ctx.timer["denoise"] / ctx.requests
