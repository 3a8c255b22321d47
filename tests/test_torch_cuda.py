"""The port's CUDA kernels against their plain PyTorch versions on the card.

Skips without a CUDA GPU.  This file imports no JAX, so it also runs on a
machine without it (tests/conftest.py needs JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Shapes are small and odd (sequence lengths that are not multiples of the
64-row tiles, head dims 40 and 24 that need padding), in float32 (kernel
error only) and bf16.
"""

import pytest
import torch

from aniportrait_tpu_torch.ops import kernels as K
from aniportrait_tpu_torch.ops.kernels import flash, temporal

# float32: summation order only; bf16: one output rounding step
TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4), torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture
def rand():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    g = torch.Generator(device="cuda").manual_seed(0)
    return lambda dtype, *s: torch.randn(*s, generator=g, device="cuda", dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [40, 24])
def test_flash_entries_match_plain(rand, dtype, d):
    h = 2
    q, k, v = rand(dtype, 3, 70, h * d), rand(dtype, 3, 90, h * d), rand(dtype, 3, 90, h * d)
    torch.testing.assert_close(K.tok_flash(q, k, v, h), flash.plain_tok_flash(q, k, v, h),
                               **TOL[dtype])
    q2 = rand(dtype, 4, 70, h * d)
    k2, v2 = rand(dtype, 4, 90, h * d), rand(dtype, 4, 90, h * d)
    kb, vb = rand(dtype, 2, 50, h * d), rand(dtype, 2, 50, h * d)
    torch.testing.assert_close(K.tok_flash_banked(q2, k2, v2, kb, vb, h, 2),
                               flash.plain_tok_flash_banked(q2, k2, v2, kb, vb, h, 2),
                               **TOL[dtype])
    q4, k4, v4 = (x.reshape(4, x.shape[1], h, d) for x in (q2, k2, v2))
    drop = torch.tensor([True, False, True, False], device="cuda")
    torch.testing.assert_close(K.flash_attention(q4, k4, v4, drop, 45),
                               flash.plain_attention_bshd(q4, k4, v4, drop, 45),
                               **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("frames", [16, 5])
def test_temporal_matches_plain(rand, dtype, frames):
    x = [rand(dtype, 2 * frames, 37, 96) for _ in range(3)]
    torch.testing.assert_close(K.nat_temporal(*x, frames, 2, 0.3),
                               temporal.plain_nat_temporal(*x, frames, 2, 0.3 * temporal.LN2),
                               **TOL[dtype])


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(rand):
    q = rand(torch.float32, 2, 70, 80)
    with pytest.raises(ValueError):
        K.tok_flash(q, q.transpose(1, 2).contiguous().transpose(1, 2), q, 2)
    with pytest.raises(TypeError):
        K.tok_flash(q.half(), q.half(), q.half(), 2)
    with pytest.raises(NotImplementedError):
        g = q.clone().requires_grad_()
        K.tok_flash(g, g, g, 2)
