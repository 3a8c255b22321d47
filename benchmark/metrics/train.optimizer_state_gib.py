"""GiB of the tensors that the training step's optimizer keeps between
steps (AdamW's two moments and step counts), read from the program's
optimizer after the window."""


def read(ctx):
    if ctx.kind != "train" or not ctx.optimizer_state_bytes:
        return None
    return ctx.optimizer_state_bytes / 2**30
