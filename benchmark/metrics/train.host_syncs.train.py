"""Blocking host reads a training step: the program's ``host_syncs``
counter under each root ``step`` span of the tracer's record
(``ctx.spans``), the median over the steps."""

import statistics


def read(ctx):
    record = getattr(ctx, "spans", None)
    if ctx.kind != "train" or record is None or not record.roots("step"):
        return None
    return statistics.median(record.count_under(i, "host_syncs")
                             for i in record.roots("step"))
