"""Seconds of set-up spent building the program's models: the first root
``build_models`` or ``build_training_models`` span of the tracer's record
(``ctx.spans``), the weight draw (``init``) included."""

BUILDS = ("build_models", "build_training_models")


def read(ctx):
    record = getattr(ctx, "spans", None)
    if record is None:
        return None
    roots = sorted(i for name in BUILDS for i in record.roots(name))
    return record.spans[roots[0]].seconds if roots else None
