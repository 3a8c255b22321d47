"""Command-line entry points of the port (run as ``python -m
aniportrait_tpu_torch.scripts.<name>``)."""
