"""Seconds per request over the window of the VAE decode less its host
output: the pipeline's ``vae_decode`` phase (the chunks' decode on the
device, ending in a synchronisation) minus the ``host_outputs`` phases
inside it.  Program spans: the pipeline's ``PhaseTimer``."""


def read(ctx):
    if ctx.kind != "pose2vid" or not {"vae_decode", "host_outputs"} <= set(ctx.timer):
        return None
    return (ctx.timer["vae_decode"] - ctx.timer["host_outputs"]) / ctx.requests
