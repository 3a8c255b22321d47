"""The float32 tensor-core flash forward's arithmetic, on the CPU.

``csrc/flash_attn_tf32x3_sm90.cu`` runs every float32 flash-forward call
with head dim <= 128 on the tensor cores in 3xTF32: each operand split as
``big + small``, big rounded as ``cvt.rna.tf32.f32`` rounds (the kernel
adds 0x1000 to the bit pattern), small the rest truncated to TF32 (as the
tensor cores read it), each product summed as small*big + big*small, then
+ big*big.  ``flash.round_tf32`` is that rounding in torch
bit operations and ``flash.plain_attention_tf32x3`` the kernel's attention
in its order; the card's kernel phase (``chip_smoke.py``) prints the
kernel's error against it, and ``tests/test_torch_cuda.py`` holds the
kernel to it.

(a) ``round_tf32`` on crafted values: ties go away from zero, both signs,
    subnormals on the same grid, the largest finite overflows to Inf,
    Inf and NaN pass through.
(b) The split's residual ``|x - big - small|`` stays within 2^-21 |x|
    (small truncated; rounding it too would give 2^-22).
(c) The three-product attention at wav2vec2's width (12 heads, d=64, 256
    frames) stays within the smoke's float32 tolerance (max abs 1e-4,
    rel-L2 1e-5) of the exact softmax ``plain_attention_bshd`` and of JAX
    ``flash_attention`` on the Pallas kernel in interpret mode, with and
    without ``drop_tail`` / ``kv_split``.
(d) One TF32 product (big*big) at the same inputs errs at least 10x more:
    the split is what keeps float32 accuracy.
(e) Inf and NaN: the split keeps them (its small part is NaN), so a NaN in
    q, K or V gives NaN wherever the exact softmax gives one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aniportrait_tpu_torch.ops.kernels import flash

F32_ATOL, F32_REL_L2 = 1e-4, 1e-5  # chip_smoke.TOLERANCE["float32"]


def _from_bits(*bits):
    return torch.tensor(np.array(bits, np.uint32).view(np.int32)).view(torch.float32)


def _bits(x):
    return [b & 0xFFFFFFFF for b in x.view(torch.int32).tolist()]


@pytest.mark.parametrize("name,bits,want", [
    ("one", 0x3F800000, 0x3F800000),
    ("tie up, away from zero", 0x3F801000, 0x3F802000),           # 1 + 2^-11
    ("negative tie, away from zero", 0xBF801000, 0xBF802000),
    ("just below a tie", 0x3F800FFF, 0x3F800000),
    ("tie at an odd last bit", 0x3F803000, 0x3F804000),           # 1 + 3 * 2^-11
    ("just above a tie", 0xC0001001, 0xC0002000),
    ("subnormal, up", 0x00001800, 0x00002000),
    ("subnormal tie", 0x00001000, 0x00002000),
    ("subnormal, down to zero", 0x00000FFF, 0x00000000),
    ("negative zero", 0x80000000, 0x80000000),
    ("largest finite overflows", 0x7F7FFFFF, 0x7F800000),
    ("below the largest tie", 0x7F7FEFFF, 0x7F7FE000),
    ("negative largest finite", 0xFF7FFFFF, 0xFF800000),
    ("inf", 0x7F800000, 0x7F800000),
    ("negative inf", 0xFF800000, 0xFF800000),
])
def test_round_tf32_crafted(name, bits, want):
    assert _bits(flash.round_tf32(_from_bits(bits))) == [want], name


def test_round_tf32_nan_and_grid():
    assert torch.isnan(flash.round_tf32(_from_bits(0x7FC00000, 0xFFC00001))).all()
    rs = np.random.RandomState(3)
    x = torch.from_numpy((rs.randn(4096) * 10.0 ** rs.uniform(-30, 30, 4096)).astype(np.float32))
    r = flash.round_tf32(x)
    assert ((r.view(torch.int32) & 0x1FFF) == 0).all()  # 10 stored bits
    # nearest: within half a TF32 step (2^-11 of the binade) of x
    assert ((r - x).abs() <= x.abs() * 2.0 ** -11).all()
    with pytest.raises(TypeError):
        flash.round_tf32(x.double())


def test_split_residual():
    x = torch.from_numpy(np.random.RandomState(4).randn(1 << 16).astype(np.float32))
    big, small = flash.split_tf32(x)
    for part in (big, small):
        assert ((part.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((x - big - small).abs() <= 2.0 ** -21 * x.abs()).all()
    assert (small.abs() <= 2.0 ** -11 * x.abs()).all()


def _inputs(seed, b=1, s=256, h=12, d=64):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.randn(b, s, h, d).astype(np.float32)) for _ in range(3)]


def _assert_f32_close(got, ref):
    diff = (got - ref).float()
    assert torch.isfinite(got).all()
    assert diff.abs().max().item() <= F32_ATOL
    assert (diff.norm() / ref.float().norm()).item() <= F32_REL_L2


@pytest.mark.parametrize("drop", [False, True])
def test_tf32x3_contract_meets_exact_and_pallas(drop):
    from aniportrait_tpu.ops.pallas_attention import flash_attention

    q, k, v = _inputs(11, b=2)
    # row 0 attends to the first 100 keys only (a ragged tile of 36)
    mask, split = (torch.tensor([True, False]), 100) if drop else (None, None)
    got = flash.plain_attention_tf32x3(q, k, v, mask, split)
    assert got.dtype == torch.float32 and got.shape == q.shape
    _assert_f32_close(got, flash.plain_attention_bshd(q, k, v, mask, split))

    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    jmask = None if mask is None else jnp.asarray(mask.numpy().astype(np.int32))
    ref = flash_attention(jq, jk, jv, jmask, split, block_q=128, block_kv=128, interpret=True)
    _assert_f32_close(got, torch.from_numpy(np.array(ref)))


def test_one_tf32_product_errs_ten_times_more():
    q, k, v = _inputs(12)
    exact = flash.plain_attention_bshd(q, k, v)
    three = (flash.plain_attention_tf32x3(q, k, v) - exact).abs().max().item()
    one = (flash.plain_attention_tf32x3(q, k, v, terms=1) - exact).abs().max().item()
    assert one >= 10 * three
    assert one > F32_ATOL  # one TF32 product misses the float32 tolerance


@pytest.mark.parametrize("d", [20, 40, 88, 128])
def test_tf32x3_contract_other_head_dims(d):
    """The 32-key tile above d = 64 and head dims that pad to 8 (20)."""
    q, k, v = _inputs(13, b=1, s=150, h=2, d=d)
    assert flash.tf32x3_block_kv(d) == (64 if d <= 64 else 32)
    _assert_f32_close(flash.plain_attention_tf32x3(q, k, v), flash.plain_attention_bshd(q, k, v))


@pytest.mark.parametrize("name,bits", [
    ("the card's NaN", 0x7FFFFFFF),          # + 0x1000 would carry into the sign
    ("negative NaN", 0xFFFFFFFF),            # + 0x1000 would wrap to +0
    ("NaN with low payload bits", 0x7F800001),  # its top 19 bits read as Inf
    ("quiet NaN", 0x7FC00000),
    ("inf", 0x7F800000),
    ("negative inf", 0xFF800000),
])
def test_split_keeps_non_finite(name, bits):
    x = _from_bits(bits)
    big, small = flash.split_tf32(x)
    assert _bits(big) == [bits], name  # passed through, not rounded
    assert torch.isnan(small).all(), name  # x - big is NaN: every product is


def test_tf32x3_contract_keeps_nans():
    """The kernel's test (tests/test_torch_cuda.py) on the CPU: NaN in one
    key, one V element and one query, in the bit patterns above."""
    q, k, v = _inputs(14, b=2, s=40, h=3, d=40)
    k[0, 5, 0] = _from_bits(0x7FFFFFFF)
    v.view(torch.int32)[1, 7, 1, 3] = -1
    q.view(torch.int32)[0, 9, 2] = 0x7F800001
    ref = flash.plain_attention_bshd(q, k, v)
    nan = torch.isnan(ref)
    assert nan[0, :, 0].all() and nan[1, :, 1, 3].all() and nan[0, 9, 2].all()
    got = flash.plain_attention_tf32x3(q, k, v)
    assert torch.equal(torch.isnan(got), nan)
    diff = (got - ref)[~nan]
    assert diff.abs().max().item() <= F32_ATOL
