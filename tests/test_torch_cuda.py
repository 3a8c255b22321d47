"""The port's CUDA kernels against their plain PyTorch versions on the card.

Skips without a CUDA GPU.  This file imports no JAX, so it also runs on a
machine without it (tests/conftest.py needs JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Shapes are small and odd (sequence lengths that are not multiples of the
tiles, head dims that need padding), in float32 (kernel error only) and
bf16.  The flash forward runs in three forms, chosen by dtype and head dim:
bf16 on the tensor cores (``csrc/flash_attn_sm90.cu``; head dims 20 and 24
take its scalar loader, the others TMA), float32 up to d = 128 on the
tensor cores in 3xTF32 (``csrc/flash_attn_tf32x3_sm90.cu``, also held to
its arithmetic ``flash.plain_attention_tf32x3``), float32 above 128 on the
FMA units.  Two forms each, bf16 on the tensor cores and float32 on the FMA
units, have the flash backward (bf16 up to d = 128:
``csrc/flash_bwd_sm90.cu``), the temporal kernel (bf16:
``csrc/temporal_attn_sm90.cu``, held to the Pallas rounding contract of
``temporal.plain_nat_temporal_rounded``) and the short-sequence kernels K6
and K9 (bf16 with d % 8 == 0: ``csrc/small_seq_attn_sm90.cu``, held to
their plain versions at the smoke's bf16 tolerance).  The normalisation
kernels N1 and N2 (``csrc/norm_sm90.cu``, bf16 only) are held to their plain
versions at the same tolerance at the shapes the generation cells run, and
the models' norms take them only where autograd records nothing.
"""

import copy
import math

import numpy as np
import pytest
import torch

from aniportrait_tpu_torch.ops import kernels as K
from aniportrait_tpu_torch.ops.kernels import flash, small_seq, temporal

# float32: summation order only; bf16: one output rounding step
TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4), torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# head dims of the flash forward's cases: SD-1.5's 40/80/160, the
# PoseGuider's 88, powers of two up to the largest, and 20 / 24 (not
# multiples of 16; 20 not of 8 either)
FLASH_DIMS = [20, 24, 40, 64, 80, 88, 128, 160, 256]


@pytest.fixture
def rand():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    g = torch.Generator(device="cuda").manual_seed(0)
    return lambda dtype, *s: torch.randn(*s, generator=g, device="cuda", dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", FLASH_DIMS)
@pytest.mark.parametrize("sq,skv", [(70, 90), (37, 1), (200, 1300)])
def test_flash_entries_match_plain(rand, dtype, d, sq, skv):
    """K2, K1 (a bank of 50 keys, rep 2) and K4 (drop_tail, kv_split 45 or
    1); 37 queries fill less than one tile, 1, 90 and 1300 keys leave ragged
    tiles (1300: 11 or 21 tiles, past every depth of the bf16 form's ring),
    200 queries a ragged second block.  bf16 runs the tensor-core form (its
    counter moves once a call) and also meets the tiled rounding contract's
    version."""
    h = 2
    before, before_tf32 = flash.tensor_core_launches, flash.tf32x3_launches
    q, k, v = rand(dtype, 3, sq, h * d), rand(dtype, 3, skv, h * d), rand(dtype, 3, skv, h * d)
    torch.testing.assert_close(K.tok_flash(q, k, v, h), flash.plain_tok_flash(q, k, v, h),
                               **TOL[dtype])
    q2 = rand(dtype, 4, sq, h * d)
    k2, v2 = rand(dtype, 4, skv, h * d), rand(dtype, 4, skv, h * d)
    kb, vb = rand(dtype, 2, 50, h * d), rand(dtype, 2, 50, h * d)
    torch.testing.assert_close(K.tok_flash_banked(q2, k2, v2, kb, vb, h, 2),
                               flash.plain_tok_flash_banked(q2, k2, v2, kb, vb, h, 2),
                               **TOL[dtype])
    q4, k4, v4 = (x.reshape(4, x.shape[1], h, d) for x in (q2, k2, v2))
    drop = torch.tensor([True, False, True, False], device="cuda")
    split = min(45, skv)
    got = K.flash_attention(q4, k4, v4, drop, split)
    torch.testing.assert_close(got, flash.plain_attention_bshd(q4, k4, v4, drop, split),
                               **TOL[dtype])
    form = flash.forward_form(dtype, d)
    assert flash.tensor_core_launches == before + 3 * (form == "wgmma")
    assert flash.tf32x3_launches == before_tf32 + 3 * (form == "tf32x3")
    if form == "wgmma":
        torch.testing.assert_close(
            got, flash.plain_attention_tiled(q4, k4, v4, flash.wgmma_block_kv(d), drop, split),
            **TOL[dtype])
    if form == "tf32x3":
        torch.testing.assert_close(
            got, flash.plain_attention_tf32x3(q4, k4, v4, drop, split), **TOL[dtype])


def _bf16_close(got, ref):
    """chip_smoke.py's bf16 tolerance: max abs error within 2^-6 of the
    largest |plain output| (two bf16 steps), rel-L2 within 5e-3."""
    diff = got.float() - ref.float()
    assert torch.isfinite(got).all()
    assert diff.abs().max().item() <= 2.0 ** -6 * ref.float().abs().max().item()
    assert (diff.norm() / ref.float().norm()).item() <= 5e-3


# the bf16 forward at the main paths' shapes (heads of 8, token layout):
# K1 as the cond half calls it (rep 16; here a bank of 777 keys, ragged),
# K2 at 64x64 (S = 4096, d = 40) and at 32x32 over self + bank (d = 80), K4
# at the PoseGuider's d = 88 with drop_tail / kv_split
MAIN_PATH_CASES = {
    "K1-rep16": dict(b=16, sq=300, skv=300, sbank=777, c=320, rep=16),
    "K2-4096": dict(b=2, sq=4096, skv=4096, c=320),
    "K2-d80": dict(b=2, sq=1024, skv=2048, c=640),
    "K4-drop": dict(b=4, sq=1024, skv=2048, c=16 * 88, h=16, split=1024),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(MAIN_PATH_CASES))
def test_flash_main_path_shapes(rand, case):
    """Each main-path call of the bf16 forward against the exact softmax and
    the tiled rounding contract at the kernel's tile, at the tolerance of
    ``test_flash_entries_match_plain``'s bf16 cases and the smoke's."""
    x = MAIN_PATH_CASES[case]
    b, sq, skv, c, h = x["b"], x["sq"], x["skv"], x["c"], x.get("h", 8)
    d = c // h
    q, k, v = rand(torch.bfloat16, b, sq, c), *(rand(torch.bfloat16, b, skv, c) for _ in "kv")
    before = flash.tensor_core_launches
    heads = [t.view(b, t.shape[1], h, d) for t in (q, k, v)]
    drop = split = None
    if "sbank" in x:
        kb, vb = (rand(torch.bfloat16, b // x["rep"], x["sbank"], c) for _ in "kv")
        got = K.tok_flash_banked(q, k, v, kb, vb, h, x["rep"])
        heads[1:] = [torch.cat([t, tb.repeat_interleave(x["rep"], 0)], 1).view(b, -1, h, d)
                     for t, tb in ((k, kb), (v, vb))]
    elif "split" in x:
        drop, split = torch.tensor([True, False, True, False], device="cuda"), x["split"]
        got = K.flash_attention(*heads, drop, split).reshape(b, sq, c)
    else:
        got = K.tok_flash(q, k, v, h)
    assert flash.tensor_core_launches == before + 1
    exact = flash.plain_attention_bshd(*heads, drop, split).reshape(b, sq, c)
    torch.testing.assert_close(got, exact, **TOL[torch.bfloat16])
    _bf16_close(got, exact)
    tiled = flash.plain_attention_tiled(*heads, flash.wgmma_block_kv(d), drop, split)
    _bf16_close(got, tiled.reshape(b, sq, c))


@pytest.mark.cuda
def test_flash_forward_repeats(rand):
    """Two calls on the same inputs give the same bits: each row's sums run
    in one order, in registers (K1 over 11 own tiles and a bank; K5a with
    its LSE)."""
    q, k, v = (rand(torch.bfloat16, 4, 1300, 320) for _ in range(3))
    kb, vb = (rand(torch.bfloat16, 2, 500, 320) for _ in range(2))
    assert torch.equal(K.tok_flash_banked(q, k, v, kb, vb, 8, 2),
                       K.tok_flash_banked(q, k, v, kb, vb, 8, 2))
    q4, k4, v4 = (t.view(4, 1300, 8, 40) for t in (q, k, v))
    (o1, l1), (o2, l2) = (K.flash_attention_fwd_lse(q4, k4, v4) for _ in range(2))
    assert torch.equal(o1, o2) and torch.equal(l1, l2)


@pytest.mark.cuda
def test_wgmma_block_matches_the_source(rand):  # rand: skips without a card
    """``flash.wgmma_block_kv`` (the tile of the plain version) is the block
    the bf16 kernel launches at every head dim; the K/V ring has two stages
    or more in 227 KB, and each block fits an SM."""
    for d in range(1, flash.MAX_HEAD_DIM + 1):
        shape = flash.wgmma_shape(d)
        assert shape["block_kv"] == flash.wgmma_block_kv(d), (d, shape)
        assert shape["dp"] == -(-d // 16) * 16 and shape["threads"] == 288, (d, shape)
        assert shape["stages"] >= 2 and shape["smem_bytes"] <= 232448, (d, shape)
        assert shape["blocks_per_sm"] >= 1, (d, shape)


@pytest.mark.cuda
def test_forward_form_follows_the_dtype(rand):
    """bf16 takes the tensor-core kernel and moves its counter; float32 up to
    d = 128 the 3xTF32 tensor-core kernel, which moves its own, and above
    128 the FMA kernel, which moves neither."""
    for d in FLASH_DIMS:
        assert flash.forward_form(torch.bfloat16, d) == "wgmma"
        assert flash.forward_form(torch.float32, d) == ("tf32x3" if d <= 128 else "fma")
    for dtype, d, moved in ((torch.bfloat16, 40, (1, 0)), (torch.float32, 40, (0, 1)),
                            (torch.float32, 160, (0, 0))):
        q = rand(dtype, 2, 40, 2 * d)
        before = (flash.tensor_core_launches, flash.tf32x3_launches)
        K.tok_flash(q, q, q, 2)
        assert (flash.tensor_core_launches - before[0],
                flash.tf32x3_launches - before[1]) == moved


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("frames", [16, 5])
def test_temporal_matches_plain(rand, dtype, frames):
    """float32 (FMA form) against the exact softmax; bf16 (tensor-core form)
    against the Pallas rounding contract."""
    x = [rand(dtype, 2 * frames, 37, 96) for _ in range(3)]
    if temporal.forward_form(dtype, 48) == "mma":
        ref = temporal.plain_nat_temporal_rounded(*x, frames, 2, 0.3)
    else:
        ref = temporal.plain_nat_temporal(*x, frames, 2, 0.3 * temporal.LN2)
    torch.testing.assert_close(K.nat_temporal(*x, frames, 2, 0.3), ref, **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [2, 5, 16, 24, 64])
@pytest.mark.parametrize("c,heads", [(96, 2), (320, 8), (1280, 8)])
def test_temporal_tensor_core_matches_rounded_contract(rand, frames, c, heads):
    """The bf16 tensor-core form at every frame count the K3 route admits
    from 2 to 64, head dims 48, 40 (an 8-column tail) and 160 (a head group
    per block); 37 positions are no multiple of any block's run."""
    x = [rand(torch.bfloat16, 2 * frames, 37, c) for _ in range(3)]
    scale = math.log2(math.e) / math.sqrt(c // heads)
    before = temporal.tensor_core_launches
    got = K.nat_temporal(*x, frames, heads, scale)
    assert temporal.tensor_core_launches == before + 1
    torch.testing.assert_close(
        got, temporal.plain_nat_temporal_rounded(*x, frames, heads, scale),
        **TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seq,heads,d", [(16, 8, 160), (24, 2, 40), (2, 3, 80), (32, 1, 80)])
def test_ctg_packed_matches_plain(rand, dtype, seq, heads, d):
    """K6 at the 576x768 motion-module width (16 frames, 8 x 160) and at
    other sequence lengths and head dims; 37 sequences, a count no packing
    divides."""
    x = [rand(dtype, 37, seq, heads * d) for _ in range(3)]
    scale = math.log2(math.e) / math.sqrt(d)
    before = K.ctg_packed.launches
    torch.testing.assert_close(K.ctg_packed(*x, seq, heads, scale),
                               small_seq.plain_ctg_packed(*x, seq, heads, scale),
                               **TOL[dtype])
    assert K.ctg_packed.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [2, 5, 16, 24, 32])
@pytest.mark.parametrize("d", [8, 40, 80, 160, 256])
def test_ctg_tensor_core_matches_plain(rand, seq, d):
    """K6's tensor-core form: 37 sequences of 2 heads (a block's run is up
    to 8 sequences), head dims with an 8-column tail (8, 40), a padded
    shared-memory row (80) and head groups per block (160, 256)."""
    x = [rand(torch.bfloat16, 37, seq, 2 * d) for _ in range(3)]
    scale = math.log2(math.e) / math.sqrt(d)
    before = (K.ctg_packed.launches, small_seq.tensor_core_launches)
    got = K.ctg_packed(*x, seq, 2, scale)
    assert (K.ctg_packed.launches, small_seq.tensor_core_launches) == (
        before[0] + 1, before[1] + 1)
    _bf16_close(got, small_seq.plain_ctg_packed(*x, seq, 2, scale))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [16, 120, 128])
@pytest.mark.parametrize("seq", [2, 16, 24, 32])
@pytest.mark.parametrize("dead", [0, 8])
@pytest.mark.parametrize("dp", [40, 80])
def test_ssa_tensor_core_matches_plain(rand, t, seq, dead, dp):
    """K9's tensor-core form: 37 tiles (a block's run is 1 to 8 tiles),
    ragged last groups (T % seq != 0, or one group shorter than seq), and
    the last 8 rows of each tile dead or not."""
    x = [rand(torch.bfloat16, 37, t, dp) for _ in range(3)]
    before = (K.ssa_packed.launches, small_seq.tensor_core_launches)
    got = K.ssa_packed(*x, seq, t - dead)
    assert (K.ssa_packed.launches, small_seq.tensor_core_launches) == (
        before[0] + 1, before[1] + 1)
    _bf16_close(got, small_seq.plain_ssa_packed(*x, seq, t - dead))


@pytest.mark.cuda
def test_small_seq_tensor_core_repeats(rand):
    """No atomics: two launches of K6 and of K9 repeat bit for bit."""
    x = [rand(torch.bfloat16, 101, 24, 640) for _ in range(3)]
    assert torch.equal(K.ctg_packed(*x, 24, 8, 0.16), K.ctg_packed(*x, 24, 8, 0.16))
    y = [rand(torch.bfloat16, 33, 128, 80) for _ in range(3)]
    assert torch.equal(K.ssa_packed(*y, 24, 120), K.ssa_packed(*y, 24, 120))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,form", [
    (torch.bfloat16, 40, "mma"), (torch.bfloat16, 20, "fma"), (torch.float32, 40, "fma"),
])
def test_small_seq_form_and_counter(rand, dtype, d, form):
    """forward_form follows dtype and head dim, the tensor-core counter
    moves exactly for the "mma" form, and either form meets its plain
    version."""
    assert small_seq.forward_form(dtype, d) == form
    x = [rand(dtype, 9, 16, 2 * d) for _ in range(3)]
    y = [rand(dtype, 5, 64, d) for _ in range(3)]
    before = small_seq.tensor_core_launches
    got = (K.ctg_packed(*x, 16, 2, 0.2), K.ssa_packed(*y, 16, 60))
    assert small_seq.tensor_core_launches == before + 2 * (form == "mma")
    torch.testing.assert_close(got[0], small_seq.plain_ctg_packed(*x, 16, 2, 0.2),
                               **TOL[dtype])
    torch.testing.assert_close(got[1], small_seq.plain_ssa_packed(*y, 16, 60), **TOL[dtype])


@pytest.mark.cuda
def test_small_seq_tensor_core_rejects_misaligned(rand):
    """The tensor-core forms load 16 bytes at a time: a bf16 operand that
    does not start on 16 bytes raises (no quiet fallback)."""
    x = rand(torch.bfloat16, 9 * 16 * 80 + 1)[1:].view(9 * 16, 80)
    with pytest.raises(ValueError):
        K.ctg_packed(x, x, x, 16, 2, 0.2)
    y = rand(torch.bfloat16, 3 * 64 * 40 + 1)[1:].view(3, 64, 40)
    with pytest.raises(ValueError):
        K.ssa_packed(y, y, y, 16)


TOK_VARIANTS = {  # wrapper, plain version (returns (out, flag))
    "noshift": (K.tok_flash_noshift, flash.plain_tok_flash_noshift),
    "bounded": (K.tok_flash_bounded, flash.plain_tok_flash_bounded),
    "unshifted": (K.tok_flash_unshifted, flash.plain_tok_flash_unshifted),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", FLASH_DIMS)
@pytest.mark.parametrize("variant", sorted(TOK_VARIANTS))
def test_tok_variants_match_plain(rand, dtype, d, variant):
    """K7, K8 and K2's TPU form on 70 queries over 90 keys (ragged tiles):
    the guard holds on random inputs and the output meets the plain
    version's and the running max's."""
    fn, plain = TOK_VARIANTS[variant]
    h = 2
    q, k, v = rand(dtype, 3, 70, h * d), rand(dtype, 3, 90, h * d), rand(dtype, 3, 90, h * d)
    before = fn.launches
    got = fn(q, k, v, h)
    assert fn.launches == before + 1
    assert fn.last_guard.is_cuda and fn.last_guard.item() == 0
    ref, flag = plain(q, k, v, h)
    assert flag.item() == 0
    torch.testing.assert_close(got, ref, **TOL[dtype])
    torch.testing.assert_close(got, flash.plain_tok_flash(q, k, v, h), **TOL[dtype])


def _crafted(kind, dtype=torch.float32):
    """The crafted inputs of tests/test_pallas_attention.py (exact in bf16
    too)."""
    rs = np.random.RandomState(6)
    q = np.zeros((1, 16, 8), np.float32)
    if kind == "orthogonal":  # every true logit 0, huge norms
        q[..., 0] = 1e4
        k = np.zeros((1, 16, 8), np.float32)
        k[..., 1] = 1e4
    else:  # one logit of 1e3 / sqrt(8): exp overflows
        q[..., 0] = 1e3
        k = (0.01 * rs.randn(1, 16, 8)).astype(np.float32)
        k[:, 3, 0] = 1.0
    v = rs.randn(1, 16, 8).astype(np.float32)
    return [torch.from_numpy(x).cuda().to(dtype) for x in (q, k, v)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant,kind,tripped", [
    ("noshift", "orthogonal", False), ("noshift", "overflow", True),
    ("bounded", "orthogonal", True), ("unshifted", "overflow", True),
])
def test_tok_variant_guards_take_the_jax_branch(rand, dtype, variant, kind, tripped):
    """The flag is set exactly where the JAX guard falls back, and then the
    predicated running-max launch has replaced the output (bf16: both
    launches on the tensor-core form)."""
    fn, plain = TOK_VARIANTS[variant]
    q, k, v = _crafted(kind, dtype)
    got = fn(q, k, v, 1)
    assert fn.last_guard.item() == int(tripped)
    ref, flag = plain(q, k, v, 1)
    assert flag.item() == int(tripped)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32 else TOL[dtype]
    torch.testing.assert_close(got, ref, **tol)
    if tripped:
        torch.testing.assert_close(got, K.tok_flash(q, k, v, 1), atol=0, rtol=0)
    if kind == "orthogonal":
        torch.testing.assert_close(got, v.mean(1, keepdim=True).expand_as(got), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,t,dp,seq,nv", [
    (37, 128, 40, 16, 128),  # the 512x512 motion-module pack
    (11, 128, 80, 24, 120),  # a dead tail; the last group straddles n_valid
    (5, 100, 24, 32, 90),    # T % seq != 0, head dim 24
    (6, 16, 256, 24, 0),     # a group longer than the tile, all rows dead
])
def test_ssa_packed_matches_plain(rand, dtype, n, t, dp, seq, nv):
    x = [rand(dtype, n, t, dp) for _ in range(3)]
    before = K.ssa_packed.launches
    torch.testing.assert_close(K.ssa_packed(*x, seq, nv),
                               small_seq.plain_ssa_packed(*x, seq, nv), **TOL[dtype])
    assert K.ssa_packed.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssa_autograd_and_folded_entry_match_cpu(rand, dtype):
    """SsaPacked's forward runs K9 and its gradient meets the CPU's; the
    head-folded entry meets the library's attention."""
    import torch.nn.functional as F

    from aniportrait_tpu_torch.ops.attention import small_seq_attention_folded
    from aniportrait_tpu_torch.ops.kernels.autograd import SsaPacked

    x = [rand(dtype, 9, 120, 40) for _ in range(3)]
    g = rand(dtype, 9, 120, 40)
    grads = {}
    for device in ("cuda", "cpu"):
        leaves = [t.detach().to(device).requires_grad_() for t in x]
        before = K.ssa_packed.launches
        SsaPacked.apply(*leaves, 24, 96).backward(g.to(device))
        assert K.ssa_packed.launches == before + (device == "cuda")
        grads[device] = [t.grad for t in leaves]
    for a, c in zip(grads["cuda"], grads["cpu"]):
        scale = c.float().abs().max().item()
        torch.testing.assert_close(a.cpu().float(), c.float(), rtol=TOL[dtype]["rtol"],
                                   atol=TOL[dtype]["atol"] * scale)
    q, k, v = (rand(dtype, 70, 16, 4, 40) for _ in range(3))
    lib = F.scaled_dot_product_attention(*(t.transpose(1, 2) for t in (q, k, v)))
    torch.testing.assert_close(small_seq_attention_folded(q, k, v), lib.transpose(1, 2),
                               **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("wrap", [False, True])
def test_windowed_motion_module_matches_cpu(rand, wrap):
    """A motion module over 20 frames with 16-frame windows (contiguous, or
    wrapping around the clip: the gather branch) on a 5 x 9 grid, which K3
    cannot pack: K6 runs on the GPU and the result meets the CPU's."""
    from aniportrait_tpu_torch.models.motion_module import MotionModule

    torch.backends.cuda.matmul.allow_tf32 = False
    windows = np.array([[*range(12, 20), *range(8)], list(range(4, 20))] if wrap
                       else [list(range(16)), list(range(4, 20))])
    cpu = MotionModule(64, heads=8).eval()
    gpu = copy.deepcopy(cpu).cuda()
    x = rand(torch.float32, 2 * 20, 64, 5, 9)
    before = K.ctg_packed.launches
    with torch.no_grad():
        got = gpu(x, 20, windows)
        ref = cpu(x.cpu(), 20, windows)
    assert K.ctg_packed.launches > before
    torch.testing.assert_close(got.cpu(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", FLASH_DIMS)
@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("sq,skv", [(70, 90), (300, 1100)])
def test_flash_fwd_lse_and_bwd_match_plain(rand, dtype, d, drop, sq, skv):
    """K5a (out, lse) and K5b (dq, dk, dv); d >= 160 takes the backward's
    32-row tiles; 300 x 1100 runs several query blocks and key tiles, all
    ragged.  Gradients are held to the output's tolerance scaled by their
    largest magnitude."""
    b, h = 3, 2
    q, k, v, do = (rand(dtype, b, s, h, d) for s in (sq, skv, skv, sq))
    mask = (torch.tensor([True, False, True], device="cuda"), 45) if drop else (None, None)
    out, lse = K.flash_attention_fwd_lse(q, k, v, *mask)
    ref_out, ref_lse = flash.plain_attention_fwd_lse(q, k, v, *mask)
    torch.testing.assert_close(out, ref_out, **TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(out, K.flash_attention(q, k, v, *mask), **TOL[dtype])
    got = K.flash_attention_bwd(q, k, v, ref_out, ref_lse, do, *mask)
    ref = flash.plain_attention_bwd(q, k, v, ref_out, ref_lse, do, *mask)
    for g, r in zip(got, ref):
        scale = r.float().abs().max().item()
        tol = TOL[dtype]
        torch.testing.assert_close(g.float(), r.float(), atol=tol["atol"] * scale,
                                   rtol=tol["rtol"])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 20, 88])
def test_flash_fwd_lse_of_rows_without_keys(rand, d):
    """A row with no key to attend to is fully masked: K5a gives it output
    0 and LSE 0, as the plain version and the TPU kernel do (d = 20 takes
    the scalar loads)."""
    q = rand(torch.bfloat16, 2, 70, 2, d)
    k = rand(torch.bfloat16, 2, 0, 2, d)
    out, lse = K.flash_attention_fwd_lse(q, k, k)
    ref_out, ref_lse = flash.plain_attention_fwd_lse(q, k, k)
    assert torch.equal(out, torch.zeros_like(q)) and torch.equal(out, ref_out)
    assert torch.equal(lse, torch.zeros_like(lse)) and torch.equal(lse, ref_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [d for d in FLASH_DIMS if d <= 128])
@pytest.mark.parametrize("drop", [False, True])
def test_flash_bwd_tensor_core_matches_plain(rand, d, drop):
    """K5b's tensor-core form (bf16, d <= 128) on ragged lengths, with and
    without drop_tail, against plain_attention_bwd; its counter moves."""
    b, sq, skv, h = 3, 70, 90, 2
    q, k, v, do = (rand(torch.bfloat16, b, s, h, d) for s in (sq, skv, skv, sq))
    mask = (torch.tensor([True, False, True], device="cuda"), 45) if drop else (None, None)
    out, lse = flash.plain_attention_fwd_lse(q, k, v, *mask)
    before = flash.tensor_core_bwd_launches
    got = K.flash_attention_bwd(q, k, v, out, lse, do, *mask)
    assert flash.tensor_core_bwd_launches == before + 1
    ref = flash.plain_attention_bwd(q, k, v, out, lse, do, *mask)
    for g, r in zip(got, ref):
        scale = r.float().abs().max().item()
        torch.testing.assert_close(g.float(), r.float(), rtol=TOL[torch.bfloat16]["rtol"],
                                   atol=TOL[torch.bfloat16]["atol"] * scale)


@pytest.mark.cuda
def test_flash_bwd_tensor_core_repeats(rand):
    """Two runs of one call: dk and dv bit for bit (summed in registers);
    dq within one bf16 step of its largest |value| (its float32 partials
    meet in the L2's bulk reductions, in the order the blocks run)."""
    b, sq, skv, h, d = 2, 300, 700, 2, 40
    q, k, v, do = (rand(torch.bfloat16, b, s, h, d) for s in (sq, skv, skv, sq))
    out, lse = K.flash_attention_fwd_lse(q, k, v)
    dq1, dk1, dv1 = K.flash_attention_bwd(q, k, v, out, lse, do)
    dq2, dk2, dv2 = K.flash_attention_bwd(q, k, v, out, lse, do)
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)
    step = 2.0 ** -7 * dq1.float().abs().max().item()
    assert (dq1.float() - dq2.float()).abs().max().item() <= step


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_functions_match_plain_grads(rand, dtype):
    """TokFlash, TokFlashBanked and FlashAttention: the backward runs K5a
    and K5b and equals the plain versions' backward."""
    from aniportrait_tpu_torch.ops.kernels.autograd import (
        FlashAttention, TokFlash, TokFlashBanked)

    h, d = 2, 40
    x = [rand(dtype, 4, 70, h * d) for _ in range(3)] + [rand(dtype, 2, 50, h * d)
                                                       for _ in range(2)]
    g = rand(dtype, 4, 70, h * d)
    cases = [
        (lambda q, k, v, kb, vb: TokFlash.apply(q, k, v, h),
         lambda q, k, v, kb, vb: flash.plain_tok_flash(q, k, v, h)),
        (lambda q, k, v, kb, vb: TokFlashBanked.apply(q, k, v, kb, vb, h, 2),
         lambda q, k, v, kb, vb: flash.plain_tok_flash_banked(q, k, v, kb, vb, h, 2)),
        (lambda q, k, v, kb, vb: FlashAttention.apply(
            *(t.reshape(4, 70, h, d) for t in (q, k, v)),
            torch.tensor([1, 0, 0, 1], device="cuda"), 30).reshape(4, 70, h * d),
         lambda q, k, v, kb, vb: flash.plain_attention_bshd(
             *(t.reshape(4, 70, h, d) for t in (q, k, v)),
             torch.tensor([1, 0, 0, 1], device="cuda"), 30).reshape(4, 70, h * d)),
    ]
    for fn, plain in cases:
        counts = K.launch_counts()
        tc_bwd = flash.tensor_core_bwd_launches
        a = [t.clone().requires_grad_() for t in x]
        fn(*a).backward(g)
        after = K.launch_counts()
        assert after["K5a"] > counts["K5a"] and after["K5b"] > counts["K5b"]
        wgmma = flash.backward_form(dtype, d) == "wgmma"
        assert (flash.tensor_core_bwd_launches > tc_bwd) == wgmma
        r = [t.float().clone().requires_grad_() for t in x]
        plain(*r).backward(g.float())
        for ga, gr in zip(a, r):
            if gr.grad is None:
                assert ga.grad is None
                continue
            scale = gr.grad.abs().max().item()
            torch.testing.assert_close(ga.grad.float(), gr.grad, rtol=5e-2,
                                       atol=TOL[dtype]["atol"] * 4 * scale)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(rand):
    q = rand(torch.float32, 2, 70, 80)
    with pytest.raises(ValueError):
        K.tok_flash(q, q.transpose(1, 2).contiguous().transpose(1, 2), q, 2)
    with pytest.raises(TypeError):
        K.tok_flash(q.half(), q.half(), q.half(), 2)
    q4 = q.reshape(2, 70, 2, 40)
    out, lse = K.flash_attention_fwd_lse(q4, q4, q4)
    with pytest.raises(ValueError):
        K.flash_attention_bwd(q4, q4, q4, out, lse.double(), q4)
    with pytest.raises(ValueError):
        K.flash_attention_bwd(q4, q4, q4, out, lse, q4, torch.ones(2, device="cuda"), 0)
    with pytest.raises(ValueError):
        K.tok_flash_bounded(q, q[:, :, :40].contiguous(), q, 2)
    x = rand(torch.bfloat16, 2 * 16 * 64 * 80 + 1)[1:].view(32, 64, 80)
    with pytest.raises(ValueError):  # K3's tensor-core form: not on 16 bytes
        K.nat_temporal(x, x, x, 16, 2, 0.2)
    t = rand(torch.float32, 2, 256, 40)
    with pytest.raises(ValueError):  # K9: T > 128
        K.ssa_packed(t, t, t, 16)
    t = t[:, :128].contiguous()
    with pytest.raises(ValueError):  # K9: seq > 32
        K.ssa_packed(t, t, t, 48)
    with pytest.raises(ValueError):  # K9: n_valid_rows > T
        K.ssa_packed(t, t, t, 16, 129)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1024, 1800])
def test_flash_at_wav2vec2_shapes(rand, dtype, s):
    """K4 at wav2vec2-base's self-attention (B=1, 12 heads, d=64): 1024
    frames, the first that take K4, and 1800 (60 s of audio; a ragged last
    tile), through the model's dispatch; float32 runs the 3xTF32 tensor-core
    form and also meets its arithmetic, bf16 the wgmma form and also meets
    the tiled rounding contract."""
    from aniportrait_tpu_torch.ops.attention import scaled_dot_product_attention

    q, k, v = (rand(dtype, 1, s, 12, 64) for _ in range(3))
    before, tc = K.launch_counts()["K4"], flash.tensor_core_launches
    tf32 = flash.tf32x3_launches
    got = scaled_dot_product_attention(q, k, v)
    assert K.launch_counts()["K4"] == before + 1
    assert flash.tensor_core_launches - tc == (dtype == torch.bfloat16)
    assert flash.tf32x3_launches - tf32 == (dtype == torch.float32)
    torch.testing.assert_close(got, flash.plain_attention_bshd(q, k, v), **TOL[dtype])
    if dtype == torch.bfloat16:
        torch.testing.assert_close(
            got, flash.plain_attention_tiled(q, k, v, flash.wgmma_block_kv(64)), **TOL[dtype])
    else:
        torch.testing.assert_close(got, flash.plain_attention_tf32x3(q, k, v), **TOL[dtype])


def _tf32x3_close(got, ref_exact, ref_contract):
    """float32 tolerance against both the exact softmax and the kernel's
    3xTF32 arithmetic."""
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref_exact, **TOL[torch.float32])
    torch.testing.assert_close(got, ref_contract, **TOL[torch.float32])


TF32X3_DIMS = [40, 64, 80, 88, 128]


@pytest.mark.cuda
@pytest.mark.parametrize("d", TF32X3_DIMS)
@pytest.mark.parametrize("sq,skv", [(70, 90), (130, 257), (37, 1)])
def test_tf32x3_running_max_modes(rand, d, sq, skv):
    """The float32 tensor-core form in its RUNMAX mode: K4 with and without
    drop_tail / kv_split, K5a's LSE, K2 in token layout and K1's bank
    segment (50 keys, rep 2), on ragged S (keys and queries that fill no
    tile); each call moves tf32x3_launches by one."""
    h = 2
    q, k, v = (rand(torch.float32, 4, s, h, d) for s in (sq, skv, skv))
    drop = torch.tensor([True, False, True, False], device="cuda")
    split = min(45, skv)
    before = flash.tf32x3_launches
    for mask in ((None, None), (drop, split)):
        _tf32x3_close(K.flash_attention(q, k, v, *mask), flash.plain_attention_bshd(q, k, v, *mask),
                      flash.plain_attention_tf32x3(q, k, v, *mask))
        out, lse = K.flash_attention_fwd_lse(q, k, v, *mask)
        ref_out, ref_lse = flash.plain_attention_fwd_lse(q, k, v, *mask)
        _tf32x3_close(out, ref_out, flash.plain_attention_tf32x3(q, k, v, *mask))
        torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    tq, tk, tv = (x.reshape(4, x.shape[1], h * d) for x in (q, k, v))
    torch.testing.assert_close(K.tok_flash(tq, tk, tv, h), flash.plain_tok_flash(tq, tk, tv, h),
                               **TOL[torch.float32])
    kb, vb = rand(torch.float32, 2, 50, h * d), rand(torch.float32, 2, 50, h * d)
    got = K.tok_flash_banked(tq, tk, tv, kb, vb, h, 2)
    kc = torch.cat([tk, kb.repeat_interleave(2, 0)], 1).view(4, skv + 50, h, d)
    vc = torch.cat([tv, vb.repeat_interleave(2, 0)], 1).view(4, skv + 50, h, d)
    _tf32x3_close(got, flash.plain_tok_flash_banked(tq, tk, tv, kb, vb, h, 2),
                  flash.plain_attention_tf32x3(q, kc, vc).reshape(got.shape))
    assert flash.tf32x3_launches == before + 6


@pytest.mark.cuda
@pytest.mark.parametrize("d", TF32X3_DIMS)
@pytest.mark.parametrize("variant", sorted(TOK_VARIANTS))
def test_tf32x3_fixed_shift_modes(rand, d, variant):
    """K7, K8 and K2u in float32 on the 3xTF32 form: 70 queries over 90
    keys, the guard holds, the output meets the plain version's, the
    running max's and the kernel's arithmetic; one count a call."""
    fn, plain = TOK_VARIANTS[variant]
    h = 2
    q, k, v = rand(torch.float32, 3, 70, h * d), rand(torch.float32, 3, 90, h * d), \
        rand(torch.float32, 3, 90, h * d)
    before = flash.tf32x3_launches
    got = fn(q, k, v, h)
    assert flash.tf32x3_launches == before + 1
    assert fn.last_guard.item() == 0
    ref, flag = plain(q, k, v, h)
    assert flag.item() == 0
    heads = [x.view(3, x.shape[1], h, d) for x in (q, k, v)]
    _tf32x3_close(got, ref, flash.plain_attention_tf32x3(*heads).reshape(got.shape))
    torch.testing.assert_close(got, flash.plain_tok_flash(q, k, v, h), **TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("variant,kind,tripped", [
    ("noshift", "orthogonal", False), ("noshift", "overflow", True),
    ("bounded", "orthogonal", True), ("unshifted", "overflow", True),
])
def test_tf32x3_guards_take_the_jax_branch(rand, variant, kind, tripped):
    """The crafted inputs at d = 8 in float32: the 3xTF32 form's guard trips
    where JAX's does, and the predicated running-max launch (the same form)
    then replaces the output."""
    fn, plain = TOK_VARIANTS[variant]
    q, k, v = _crafted(kind)
    before = flash.tf32x3_launches
    got = fn(q, k, v, 1)
    assert flash.tf32x3_launches == before + 1
    assert fn.last_guard.item() == int(tripped)
    torch.testing.assert_close(got, plain(q, k, v, 1)[0], atol=1e-4, rtol=1e-4)
    if tripped:
        torch.testing.assert_close(got, K.tok_flash(q, k, v, 1), atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("d,offset", [(18, 0), (36, 1), (64, 1), (5, 0), (52, 0)])
def test_tf32x3_scalar_loads(rand, d, offset):
    """Head dims that are no multiple of 4, and operands 4 bytes off a
    16-byte boundary, take the kernel's 4-byte copies (d = 52 takes the
    16-byte copies into the 64-column tile that d = 49 ... 56 use)."""
    b, s, h = 2, 75, 3
    n = b * s * h * d
    q, k, v = (rand(torch.float32, n + offset)[offset:].view(b, s, h, d) for _ in range(3))
    before = flash.tf32x3_launches
    got = K.flash_attention(q, k, v)
    assert flash.tf32x3_launches == before + 1
    _tf32x3_close(got, flash.plain_attention_bshd(q, k, v), flash.plain_attention_tf32x3(q, k, v))


def _with_nans(q, k, v, card_nan):
    """q, k, v (B >= 2, S >= 10, H >= 3, D >= 4) with NaNs the 3xTF32 split
    must keep: ``card_nan`` (made on the card) in key 5 of row 0, head 0;
    the negative NaN 0xffffffff at one V element (row 1, key 7, head 1,
    column 3); the NaN 0x7f800001, whose payload lies in the bits a tf32
    operand drops, in query 9 of row 0, head 2."""
    q, k, v = q.clone(), k.clone(), v.clone()
    k[0, 5, 0] = card_nan
    v.view(torch.int32)[1, 7, 1, 3] = -1
    q.view(torch.int32)[0, 9, 2] = 0x7F800001
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 64, 88])
def test_tf32x3_keeps_nans(rand, d):
    """A NaN in q, K or V gives NaN wherever the exact softmax gives one,
    and only there: the split's rounding add carries the card's own NaN
    (0/0, bit pattern 0x7fffffff) into big's sign bit (-0 as a tf32
    operand), so the unrounded small part must carry it; the other entries
    still meet the plain version."""
    card_nan = torch.zeros((), device="cuda") / torch.zeros((), device="cuda")
    q, k, v = _with_nans(*(rand(torch.float32, 2, 40, 3, d) for _ in range(3)), card_nan)
    got = K.flash_attention(q, k, v)
    ref = flash.plain_attention_bshd(q, k, v)
    nan = torch.isnan(ref)
    assert nan[0, :, 0].all() and nan[1, :, 1, 3].all() and nan[0, 9, 2].all()
    assert torch.equal(torch.isnan(got), nan)
    torch.testing.assert_close(got[~nan], ref[~nan], **TOL[torch.float32])
    assert torch.equal(torch.isnan(flash.plain_attention_tf32x3(q, k, v)), nan)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(TOK_VARIANTS))
def test_tf32x3_nan_trips_the_guards(rand, variant):
    """K7, K8 and K2u in float32: a NaN from the card in one key trips the
    guard, as the JAX guard falls back on a non-finite sum, and the
    running-max result then carries the NaN as the plain version does."""
    fn, plain = TOK_VARIANTS[variant]
    h, d = 3, 40
    card_nan = torch.zeros((), device="cuda") / torch.zeros((), device="cuda")
    q, k, v = _with_nans(*(rand(torch.float32, 2, 40, h, d) for _ in range(3)), card_nan)
    q, k, v = (x.reshape(2, 40, h * d) for x in (q, k, v))
    got = fn(q, k, v, h)
    assert fn.last_guard.item() == 1
    ref, flag = plain(q, k, v, h)
    assert flag.item() == 1
    assert torch.equal(torch.isnan(got), torch.isnan(ref))


@pytest.mark.cuda
def test_tf32x3_block_matches_the_source(rand):  # rand: skips without a card
    """``flash.tf32x3_block_kv``, the tile of the plain version, is the one
    the kernel launches at every head dim it takes; each instantiation fits
    at least one block an SM."""
    for d in range(1, flash.TF32X3_MAX_HEAD_DIM + 1):
        shape = flash.tf32x3_shape(d)
        assert shape["block_kv"] == flash.tf32x3_block_kv(d), d
        assert shape["dp"] >= d and shape["blocks_per_sm"] >= 1, (d, shape)
    for mode in (flash.NOSHIFT_E, flash.BOUNDED_2, flash.UNSHIFTED_2):
        assert flash.tf32x3_shape(64, mode)["blocks_per_sm"] >= 1
    assert flash.tf32x3_shape(64, lse=True)["blocks_per_sm"] >= 1


@pytest.mark.cuda
def test_audio_models_match_cpu(rand):
    """Tiny Audio2Mesh and Audio2Pose, float32 with TF32 off, on the card
    against the CPU; 1100 frames, so the encoder's attention takes K4."""
    from aniportrait_tpu_torch.audio.audio2mesh import Audio2MeshModel
    from aniportrait_tpu_torch.audio.audio2pose import Audio2PoseModel

    tiny = dict(hidden=48, layers=2, heads=4, intermediate=64, pos_conv_kernel=16,
                pos_conv_groups=4, conv_layers=((16, 10, 5), (16, 3, 2)))
    torch.manual_seed(0)
    a2m = Audio2MeshModel(latent_dim=16, wav2vec2=tiny).eval()
    torch.nn.init.normal_(a2m.out_fn.weight, std=0.3)
    a2p = Audio2PoseModel(latent_dim=16, wav2vec2=tiny).eval()
    wav = torch.randn(1, 16000 * 2)
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            want = a2m(wav, 1100), a2p(wav[:, :8000], 40, torch.tensor([5]))
            before = K.launch_counts()["K4"]
            got = (copy.deepcopy(a2m).cuda()(wav.cuda(), 1100).cpu(),
                   copy.deepcopy(a2p).cuda()(wav[:, :8000].cuda(), 40,
                                             torch.tensor([5], device="cuda")).cpu())
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    assert K.launch_counts()["K4"] == before + 2
    for g, w in zip(got, want):
        scale = w.abs().max().item()
        assert scale > 1e-3
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * scale)


# N1 at the shapes the generation cells run: (rows, c, h, w, frames a sample
# for the pooled form); the UNet's levels at 32 (f16) and 128 (f48) rows, the
# widest concatenations, the ReferenceNet's 2 rows, the PoseGuider's 16, the
# VAE's 64-512 px levels (8-frame decode chunks, the 1-image encode), the
# pooled form, and odd shapes that take the scalar accesses
N1_SHAPES = [
    (32, 320, 64, 64, 1), (32, 960, 64, 64, 1), (32, 640, 32, 32, 1), (32, 1920, 32, 32, 1),
    (32, 1280, 16, 16, 1), (32, 2560, 16, 16, 1), (32, 1280, 8, 8, 1), (32, 2560, 8, 8, 1),
    (128, 320, 64, 64, 1), (128, 640, 64, 64, 1), (128, 640, 32, 32, 1),
    (128, 1280, 16, 16, 1), (128, 1280, 8, 8, 1), (2, 1280, 8, 8, 1),
    (32, 320, 64, 64, 16), (128, 640, 32, 32, 16),
    (16, 320, 32, 32, 1), (16, 640, 16, 16, 1), (16, 1280, 8, 8, 1),
    (8, 512, 64, 64, 1), (8, 512, 128, 128, 1), (8, 256, 256, 256, 1), (8, 512, 256, 256, 1),
    (8, 128, 512, 512, 1), (8, 256, 512, 512, 1), (1, 128, 512, 512, 1),
    (6, 64, 5, 3, 1), (6, 64, 5, 3, 3), (4, 96, 9, 12, 1),
]
# N2: (shape, with the positional encoding); the transformer tokens of the
# UNets, the motion modules' natural (b, f, s, c) with the encoding, CLIP,
# the PoseGuider's 1408 channels, and odd widths (scalar form)
N2_SHAPES = [
    ((32, 4096, 320), False), ((32, 1024, 640), False), ((32, 256, 1280), False),
    ((32, 64, 1280), False), ((128, 4096, 320), False), ((128, 64, 1280), False),
    ((2, 16, 4096, 320), True), ((2, 16, 1024, 640), True), ((2, 16, 256, 1280), True),
    ((2, 16, 64, 1280), True), ((8, 16, 4096, 320), True), ((8, 16, 64, 1280), True),
    ((1, 257, 1024), False), ((1, 1024), False), ((16, 1024, 1408), False),
    ((16, 64, 1408), False), ((3, 5, 12), False), ((2, 3, 4, 12), True), ((7, 2304), False),
]


def _affine(rand, c, dtype=torch.bfloat16):
    return (rand(torch.float32, c) * 0.3 + 1).to(dtype), (rand(torch.float32, c) * 0.3).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("rows,c,h,w,frames", N1_SHAPES)
def test_group_norm_matches_plain(rand, rows, c, h, w, frames, silu):
    """N1 against its plain version (the float32 composition, then F.silu
    in bf16), per frame and pooled, at chip_smoke.py's bf16 tolerance; it
    counts a launch.  Inputs off zero mean, as activations are."""
    from aniportrait_tpu_torch.ops.kernels import norm

    x = (rand(torch.float32, rows, c, h, w) * 2 + 0.5).to(torch.bfloat16)
    for wdtype in (torch.bfloat16, torch.float32):
        weight, bias = _affine(rand, c, wdtype)
        before = K.launch_counts()["N1"]
        got = norm.group_norm(x, 32, weight, bias, 1e-5, frames, silu)
        assert K.launch_counts()["N1"] == before + 1
        _bf16_close(got, norm.plain_group_norm(x, 32, weight, bias, 1e-5, frames, silu))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,with_pe", N2_SHAPES)
def test_layer_norm_matches_plain(rand, shape, with_pe):
    """N2 against its plain version (the float32 composition, plus the
    encoding in bf16) at chip_smoke.py's bf16 tolerance, with bf16 and
    float32 parameters and encodings; it counts a launch."""
    from aniportrait_tpu_torch.ops.kernels import norm

    c = shape[-1]
    x = (rand(torch.float32, *shape) * 2 + 0.5).to(torch.bfloat16)
    for pdtype in (torch.bfloat16, torch.float32):
        weight, bias = _affine(rand, c, pdtype)
        pe = rand(pdtype, shape[1], c) if with_pe else None
        before = K.launch_counts()["N2"]
        got = norm.layer_norm(x, weight, bias, 1e-5, pe)
        assert K.launch_counts()["N2"] == before + 1
        _bf16_close(got, norm.plain_layer_norm(x, weight, bias, 1e-5, pe))


@pytest.mark.cuda
def test_norm_modules_engage_only_where_autograd_records_nothing(rand):
    """The models' GroupNorm and LayerNorm on the card: a bf16 call under
    no_grad, or with nothing requiring a gradient, runs N1 / N2; a call
    autograd records (a trainable weight, or an input that requires a
    gradient) and every float32 call take the composition, bit for bit,
    and the counters do not move."""
    from aniportrait_tpu_torch.models.attention import LayerNorm
    from aniportrait_tpu_torch.models.resnet import GroupNorm
    from aniportrait_tpu_torch.ops.kernels import norm

    gn = GroupNorm(32, 320, eps=1e-6).cuda()
    ln = LayerNorm(320).cuda()
    for dtype in (torch.bfloat16, torch.float32):
        gn.to(dtype), ln.to(dtype)
        x = rand(dtype, 4, 320, 16, 16)
        t = rand(dtype, 2, 4, 64, 320)
        pe = rand(torch.float32, 4, 320)
        plain_g = norm.plain_group_norm(x, 32, gn.weight, gn.bias, gn.eps, 1, True)
        plain_l = norm.plain_layer_norm(t, ln.weight, ln.bias, ln.eps, pe)
        for grad in (False, True):
            for trainable in (False, True):
                gn.requires_grad_(trainable), ln.requires_grad_(trainable)
                before = K.launch_counts()
                with torch.set_grad_enabled(grad):
                    got_g, got_l = gn(x, silu=True), ln(t, pe=pe)
                    xr = x.detach().requires_grad_()
                    recorded = gn(xr, silu=True)
                counts = K.launch_counts()
                kernel = dtype == torch.bfloat16 and not (grad and trainable)
                assert counts["N2"] - before["N2"] == int(kernel)
                assert counts["N1"] - before["N1"] == int(kernel) + int(
                    dtype == torch.bfloat16 and not grad)
                if kernel:
                    _bf16_close(got_g, plain_g)
                    _bf16_close(got_l, plain_l)
                else:
                    assert torch.equal(got_g, plain_g) and torch.equal(got_l, plain_l)
                if grad:
                    assert recorded.requires_grad and torch.equal(recorded, plain_g)


@pytest.mark.cuda
def test_norm_wrappers_refuse_what_the_kernels_do_not_take(rand):
    """Float32, non-contiguous and misshapen inputs are refused with a clear
    error, never run by a fallback."""
    from aniportrait_tpu_torch.ops.kernels import norm

    x = rand(torch.bfloat16, 4, 64, 8, 8)
    w, b = _affine(rand, 64)
    with pytest.raises(TypeError, match="bf16"):
        norm.group_norm(x.float(), 32, w, b, 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        norm.group_norm(x.transpose(2, 3), 32, w, b, 1e-5)
    with pytest.raises(ValueError, match="groups"):
        norm.group_norm(x, 32, w, b, 1e-5, frames=3)
    t = rand(torch.bfloat16, 2, 4, 8, 64)
    with pytest.raises(TypeError, match="bf16"):
        norm.layer_norm(t.float(), w, b, 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        norm.layer_norm(t.transpose(1, 2), w, b, 1e-5)
    with pytest.raises(ValueError, match="pe"):
        norm.layer_norm(t, w, b, 1e-5, rand(torch.float32, 3, 64))
