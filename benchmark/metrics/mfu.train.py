"""Model FLOPs of the window's completed steps (forward and backward,
without the recompute of gradient checkpointing) over (window seconds x
989 TFLOP/s), in %.  The FLOPs are the benchmark's own count at the cell's
shapes (``harness/work.py``), for a step that reads the bank."""

from harness import work


def read(ctx):
    if ctx.kind != "train":
        return None
    t = ctx.cfg["training"]
    h, w = t["sample_size"]
    flops = work.train_step_work(ctx.cfg["models"], t["frames"], h, w, t["train_bs"],
                                 False)["flops"]
    return 100.0 * flops * ctx.steps / (ctx.window_s * work.PEAK_FLOPS_BF16)
