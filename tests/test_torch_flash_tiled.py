"""The bf16 rounding contract of the tensor-core flash forward, on the CPU.

``flash.plain_attention_tiled`` computes the online softmax tile by tile as
the Pallas body does (``aniportrait_tpu/ops/pallas_attention.py:79-97``):
the scale after the float32 product, p rounded to v's dtype before PV.  The
CUDA kernel (``csrc/flash_attn_sm90.cu``) follows the same order; the card's
kernel phase prints its error against this version.

(a) With the JAX kernel's tile (``block_kv`` 128, the least the Pallas entry
    takes), bf16 inputs, the tiled version equals JAX ``flash_attention`` run
    in interpret mode to one bf16 step of each output: both sum the same
    rounded p in float32, in another order, so a rounding can flip.
(b) It stays within the smoke's bf16 tolerance (``chip_smoke.py``: max abs
    2^-6 of the largest |output|, rel-L2 5e-3) of the exact float32 softmax
    ``plain_attention_bshd``: rounding p costs ~2^-9 relative per term.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aniportrait_tpu_torch.ops import kernels as K
from aniportrait_tpu_torch.ops.kernels import flash


def _bf16_inputs(seed, b, sq, skv, h, d):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.randn(b, s, h, d).astype(np.float32)).to(torch.bfloat16)
            for s in (sq, skv, skv)]


@pytest.mark.parametrize("d,drop", [(40, False), (88, True)])
def test_tiled_contract_matches_pallas_and_exact(d, drop):
    from aniportrait_tpu.ops.pallas_attention import flash_attention

    b, sq, skv, h = 2, 70, 300, 2  # 300 keys: two full tiles and a ragged one
    q, k, v = _bf16_inputs(7, b, sq, skv, h, d)
    mask, split = (torch.tensor([True, False]), 90) if drop else (None, None)
    got = flash.plain_attention_tiled(q, k, v, 128, mask, split)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape

    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v))
    jmask = None if mask is None else jnp.asarray(mask.numpy().astype(np.int32))
    ref = flash_attention(jq, jk, jv, jmask, split, block_q=128, block_kv=128, interpret=True)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    # one bf16 step (8 significant bits) of each |output|
    step = 2.0 ** (torch.floor(torch.log2(ref.abs().clamp_min(2.0 ** -126))) - 7)
    assert ((got.float() - ref).abs() <= step).all()

    exact = flash.plain_attention_bshd(q, k, v, mask, split).float()
    diff = got.float() - exact
    assert diff.abs().max() <= 2.0 ** -6 * exact.abs().max()
    assert diff.norm() / exact.norm() <= 5e-3


def test_forward_form_is_a_function_of_dtype_and_head_dim():
    """bf16 takes the tensor-core form at every head dim the kernels take,
    float32 the 3xTF32 tensor-core form up to d = 128 and the FMA form
    above; anything else raises (no form to fall back to)."""
    for d in (1, 20, 40, 88, 160, 256):
        assert flash.forward_form(torch.bfloat16, d) == "wgmma"
        assert flash.forward_form(torch.float32, d) == ("tf32x3" if d <= 128 else "fma")
    assert flash.forward_form(torch.float32, 128) == "tf32x3"
    assert flash.forward_form(torch.float32, 129) == "fma"
    with pytest.raises(TypeError):
        flash.forward_form(torch.float16, 40)
    with pytest.raises(ValueError):
        flash.forward_form(torch.bfloat16, 257)


@pytest.mark.parametrize("d", [1, 8, 20, 40, 48, 64, 80, 88, 96, 128, 129, 160, 208, 256])
def test_wgmma_tile_choice(d):
    """``wgmma_block_kv`` takes 128 keys up to a head tile of 80 (d rounded
    up to 16: S, P and O fit the registers beside each other) and 64 above,
    and the tiled version at that tile stays within the smoke's bf16
    tolerance of the exact softmax (the card tests hold the kernel's own
    block to it)."""
    bkv = flash.wgmma_block_kv(d)
    assert bkv == (128 if -(-d // 16) * 16 <= 80 else 64)
    q, k, v = _bf16_inputs(d, 1, 33, 200, 2, d)
    got = flash.plain_attention_tiled(q, k, v, bkv)
    exact = flash.plain_attention_bshd(q, k, v).float()
    diff = got.float() - exact
    assert diff.abs().max() <= 2.0 ** -6 * exact.abs().max()
    assert diff.norm() / exact.norm() <= 5e-3


@pytest.mark.parametrize("d,drop", [(40, False), (80, True), (88, True)])
def test_tiled_contract_at_the_kernels_tile(d, drop):
    """At the kernel's own tile (``wgmma_block_kv``: 128 keys at d = 40 and
    80, 64 at 88) the tiled version stays within the smoke's bf16 tolerance
    of the exact softmax; 300 keys leave a ragged last tile either way."""
    b, sq, skv, h = 2, 70, 300, 2
    q, k, v = _bf16_inputs(11, b, sq, skv, h, d)
    mask, split = (torch.tensor([True, False]), 90) if drop else (None, None)
    got = flash.plain_attention_tiled(q, k, v, flash.wgmma_block_kv(d), mask, split)
    exact = flash.plain_attention_bshd(q, k, v, mask, split).float()
    diff = got.float() - exact
    assert diff.abs().max() <= 2.0 ** -6 * exact.abs().max()
    assert diff.norm() / exact.norm() <= 5e-3


def test_reset_launch_counts_zeroes_the_flash_counters():
    """``reset_launch_counts`` zeroes the flash forms' counters with the
    kernels' launches; CPU calls run the plain versions and move none."""
    flash.tensor_core_launches, flash.tf32x3_launches = 7, 9
    flash.tensor_core_bwd_launches = 5
    K.tok_flash.launches = 3
    K.reset_launch_counts()
    assert (flash.tensor_core_launches, flash.tf32x3_launches,
            flash.tensor_core_bwd_launches) == (0, 0, 0)
    assert set(K.launch_counts().values()) == {0}
    q = torch.randn(1, 5, 2 * 40).to(torch.bfloat16)
    K.tok_flash(q, q, q, 2)
    assert flash.tensor_core_launches == 0 and K.launch_counts()["K2"] == 0
