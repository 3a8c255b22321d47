"""Seconds per request over the window that the pipeline spends in host
input and output: its ``host_inputs`` phase (the host resize of the
reference and the pose maps, their pinning and the uploads' issue) and its
``host_outputs`` phases (the waits for the last download copies once the
decode has finished on the device, and the host's concatenation and float
conversion of the frames).  Program spans: the pipeline's ``PhaseTimer``."""


def read(ctx):
    if ctx.kind != "pose2vid" or not {"host_inputs", "host_outputs"} <= set(ctx.timer):
        return None
    return (ctx.timer["host_inputs"] + ctx.timer["host_outputs"]) / ctx.requests
