"""The port's CUDA kernels against their plain PyTorch versions on the card.

Skips without a CUDA GPU.  This file imports no JAX, so it also runs on a
machine without it (tests/conftest.py needs JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Shapes are small and odd (sequence lengths that are not multiples of the
tiles, head dims that need padding), in float32 (kernel error only) and
bf16.  The flash forward runs in two forms, chosen by dtype: bf16 on the
tensor cores (``csrc/flash_attn_sm90.cu``; head dims 20 and 24 take its
scalar loader, the others TMA), float32 on the FMA units.  So do the flash
backward (bf16 up to d = 128: ``csrc/flash_bwd_sm90.cu``) and the temporal
kernel (bf16: ``csrc/temporal_attn_sm90.cu``, held to the Pallas rounding
contract of ``temporal.plain_nat_temporal_rounded``).
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
@pytest.mark.parametrize("sq,skv", [(70, 90), (37, 1)])
def test_flash_entries_match_plain(rand, dtype, d, sq, skv):
    """K2, K1 (a bank of 50 keys, rep 2) and K4 (drop_tail, kv_split 45 or
    1); 37 queries fill less than one tile, 1 and 90 keys leave ragged
    tiles.  bf16 runs the tensor-core form and also meets the tiled
    rounding contract's version."""
    h = 2
    before = flash.tensor_core_launches
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
    wgmma = flash.forward_form(dtype, d) == "wgmma"
    assert flash.tensor_core_launches == before + 3 * wgmma
    if wgmma:
        torch.testing.assert_close(
            got, flash.plain_attention_tiled(q4, k4, v4, flash.wgmma_block_kv(d), drop, split),
            **TOL[dtype])


@pytest.mark.cuda
def test_forward_form_follows_the_dtype(rand):
    """bf16 takes the tensor-core kernel and moves its counter; float32 the
    FMA kernel, which does not."""
    for d in FLASH_DIMS:
        assert flash.forward_form(torch.bfloat16, d) == "wgmma"
        assert flash.forward_form(torch.float32, d) == "fma"
    for dtype, moved in ((torch.bfloat16, 1), (torch.float32, 0)):
        q = rand(dtype, 2, 40, 80)
        before = flash.tensor_core_launches
        K.tok_flash(q, q, q, 2)
        assert flash.tensor_core_launches == before + moved


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
def test_flash_fwd_lse_and_bwd_match_plain(rand, dtype, d, drop):
    """K5a (out, lse) and K5b (dq, dk, dv); d >= 160 takes the backward's
    32-row tiles.  Gradients are held to the output's tolerance scaled by
    their largest magnitude."""
    b, sq, skv, h = 3, 70, 90, 2
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
