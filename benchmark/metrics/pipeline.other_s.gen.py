"""Seconds per request outside the ``denoise`` phase over the window: the
reference encode, the pose features, the VAE decode, the host resize and
the copies between host and device (request wall minus ``denoise``)."""


def read(ctx):
    if ctx.kind != "pose2vid" or "denoise" not in ctx.timer:
        return None
    return (sum(ctx.walls) - ctx.timer["denoise"]) / ctx.requests
