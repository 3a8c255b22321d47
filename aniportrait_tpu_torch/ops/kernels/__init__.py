"""Hand-written Hopper kernels of the port (the counterpart of
``aniportrait_tpu/ops/pallas_attention.py``), their wrappers and plain
versions.  Sources: ``aniportrait_tpu_torch/csrc``; build: ``build.py``."""

from aniportrait_tpu_torch.ops.kernels import flash, temporal
from aniportrait_tpu_torch.ops.kernels.flash import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_fwd_lse,
    tok_flash,
    tok_flash_banked,
    tok_flash_bounded,
    tok_flash_noshift,
    tok_flash_unshifted,
)
from aniportrait_tpu_torch.ops.kernels.small_seq import ctg_packed, ssa_packed
from aniportrait_tpu_torch.ops.kernels.temporal import nat_temporal

# kernel id (the TPU kernel table in ROADMAP.md) -> wrapper; K2u is K2 in its
# TPU form (the unshifted softmax), which counts apart from tok_flash
KERNELS = {
    "K1": tok_flash_banked,
    "K2": tok_flash,
    "K2u": tok_flash_unshifted,
    "K3": nat_temporal,
    "K4": flash_attention,
    "K5a": flash_attention_fwd_lse,
    "K5b": flash_attention_bwd,
    "K6": ctg_packed,
    "K7": tok_flash_noshift,
    "K8": tok_flash_bounded,
    "K9": ssa_packed,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    flash.tensor_core_launches = 0
    flash.tensor_core_bwd_launches = 0
    temporal.tensor_core_launches = 0


def launch_counts() -> dict:
    return {kid: fn.launches for kid, fn in KERNELS.items()}
