"""Host seconds a training step spends issuing work: each root ``step``
span of the tracer's record (``ctx.spans``) less its ``sync`` children (the
waits for the loss and the gradient norm), the median over the steps after
the first."""

import statistics


def read(ctx):
    record = getattr(ctx, "spans", None)
    if ctx.kind != "train" or record is None:
        return None
    steps = record.roots("step")[1:]
    if not steps:
        return None
    return statistics.median(
        record.spans[i].seconds - sum(record.spans[j].seconds for j in record.children(i)
                                      if record.spans[j].name == "sync")
        for i in steps)
