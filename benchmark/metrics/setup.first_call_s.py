"""Seconds by which the process's first call outlasts a warm one: the first
root ``request`` span (generation) or ``step`` span (training) of the
tracer's record (``ctx.spans``) less the median of the later ones."""

import statistics

ROOT = {"pose2vid": "request", "train": "step"}


def read(ctx):
    record = getattr(ctx, "spans", None)
    if record is None or ctx.kind not in ROOT:
        return None
    seconds = [record.spans[i].seconds for i in record.roots(ROOT[ctx.kind])]
    if len(seconds) < 2:
        return None
    return seconds[0] - statistics.median(seconds[1:])
