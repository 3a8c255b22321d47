"""Share (%) of their roofline that the attention kernels reach in the
traced steps: the least time of every attention call of each step, forward
and (where the call needs a gradient) backward (``harness/work.py``,
counted from the model's shapes, with each step's CFG-dropout flag deciding
whether the bank is read), over the device time of every attention kernel
in the trace, K3's plain-autograd backward (the port's ``K3 plain
backward`` range) included.  Gradient checkpointing's second forward is
device time and not work, as it should be for a roofline."""

from harness import work
from harness.trace import ATTENTION


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None or not ctx.trace.families.get(ATTENTION):
        return None
    t = ctx.cfg["training"]
    h, w = t["sample_size"]
    least = sum(work.attention_least_seconds(work.train_step_work(
        ctx.cfg["models"], t["frames"], h, w, t["train_bs"], flag)["attention_calls"])
        for flag in ctx.dropout)
    return 100.0 * least / ctx.trace.families[ATTENTION]
