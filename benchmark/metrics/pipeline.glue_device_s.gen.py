"""Device seconds per traced request of the pipeline's own work on the
card: the operations launched inside the ``denoise`` span but outside every
``denoising_unet`` span (the window gather, the CFG doubling, the scatter
and count, the divide, the CFG combine, the DDIM update).  Reads the
tracer's record (``ctx.spans``) and the trace's operations put to their
spans by ``harness/spans.py`` (``ctx.span_ops``); nothing without them."""

from harness.spans import within


def read(ctx):
    record, ops = getattr(ctx, "spans", None), getattr(ctx, "span_ops", None)
    if ctx.kind != "pose2vid" or record is None or not ops:
        return None
    ns = sum(op.end - op.start for op in ops if op.span is not None
             and within(record, op.span, "denoise")
             and not within(record, op.span, "denoising_unet"))
    return ns / 1e9 / ctx.trace_requests
