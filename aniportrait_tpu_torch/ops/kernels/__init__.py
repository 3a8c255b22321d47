"""Hand-written Hopper kernels of the port (the counterpart of
``aniportrait_tpu/ops/pallas_attention.py``), their wrappers and plain
versions.  Sources: ``aniportrait_tpu_torch/csrc``; build: ``build.py``."""

from aniportrait_tpu_torch.ops.kernels.flash import (
    flash_attention,
    tok_flash,
    tok_flash_banked,
)
from aniportrait_tpu_torch.ops.kernels.temporal import nat_temporal

# kernel id (the TPU kernel table in ROADMAP.md) -> wrapper
KERNELS = {
    "K1": tok_flash_banked,
    "K2": tok_flash,
    "K3": nat_temporal,
    "K4": flash_attention,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {kid: fn.launches for kid, fn in KERNELS.items()}
