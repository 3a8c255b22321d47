"""K7 (no-shift), K8 (bounded) and K2's TPU form (unshifted) of the port
against the JAX package.

On the CPU each wrapper (``ops.kernels.tok_flash_noshift``,
``tok_flash_bounded``, ``tok_flash_unshifted``) runs its plain version, which
follows its Pallas body's rounding contract and guard step by step.  Each
must equal the JAX function on its Pallas kernel in interpret mode: same
numpy inputs, float32, 2e-5 abs / 1e-4 rel, KV lengths that leave a ragged
tail.  On the crafted inputs of tests/test_pallas_attention.py the port's
guard takes the branch the JAX guard takes, and the K8 bound equals
``_bounds_cauchy_schwarz``.  The CUDA kernels are tested in
tests/test_torch_cuda.py.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aniportrait_tpu_torch.ops import kernels as K
from aniportrait_tpu_torch.ops.kernels import flash
from aniportrait_tpu_torch.scripts import bench_tok_kernel

ATOL, RTOL = 2e-5, 1e-4
VARIANTS = {  # port wrapper, JAX function name
    "noshift": (K.tok_flash_noshift, "flash_attention_tokens_noshift"),
    "bounded": (K.tok_flash_bounded, "flash_attention_tokens_bounded"),
    "unshifted": (K.tok_flash_unshifted, "flash_attention_tokens_unshifted"),
}


def _jax(name, q, k, v, heads):
    from aniportrait_tpu.ops import pallas_attention as pa

    with jax.default_matmul_precision("highest"):
        return np.asarray(getattr(pa, name)(
            *map(jnp.asarray, (q, k, v)), heads=heads, block_q=16, block_kv=16,
            interpret=True))


def _port(fn, q, k, v, heads):
    out = fn(*map(torch.from_numpy, (q, k, v)), heads).numpy()
    return out, int(fn.last_guard.item())


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("b,sq,skv,heads,d", [(2, 40, 50, 2, 8), (1, 48, 40, 4, 16)])
def test_variant_matches_pallas(variant, b, sq, skv, heads, d):
    fn, jax_name = VARIANTS[variant]
    rs = np.random.RandomState(sq + skv)
    q = rs.randn(b, sq, heads * d).astype(np.float32)
    k, v = (rs.randn(b, skv, heads * d).astype(np.float32) for _ in range(2))
    got, guard = _port(fn, q, k, v, heads)
    assert guard == 0
    np.testing.assert_allclose(got, _jax(jax_name, q, k, v, heads), atol=ATOL, rtol=RTOL)


def _orthogonal(rs):
    """Huge-norm q along e0, k along e1: every true logit is 0."""
    q = np.zeros((1, 16, 8), np.float32)
    q[..., 0] = 1e4
    k = np.zeros((1, 16, 8), np.float32)
    k[..., 1] = 1e4
    return q, k, rs.randn(1, 16, 8).astype(np.float32)


def _overflow(rs):
    """Aligned huge q and one key: that logit is 1e3 / sqrt(8), past exp's
    float32 range."""
    q = np.zeros((1, 16, 8), np.float32)
    q[..., 0] = 1e3
    k = (0.01 * rs.randn(1, 16, 8)).astype(np.float32)
    k[:, 3, 0] = 1.0
    return q, k, rs.randn(1, 16, 8).astype(np.float32)


@pytest.mark.parametrize("variant,inputs,tripped", [
    ("noshift", _orthogonal, False),  # exp(0) needs no shift: the fast path stands
    ("noshift", _overflow, True),     # exp overflows: the running max takes over
    ("bounded", _orthogonal, True),   # the bound is ~1e8 too high: l underflows
])
def test_guard_takes_the_jax_branch(variant, inputs, tripped):
    fn, jax_name = VARIANTS[variant]
    q, k, v = inputs(np.random.RandomState(6))
    got, guard = _port(fn, q, k, v, 1)
    assert guard == int(tripped)
    np.testing.assert_allclose(got, _jax(jax_name, q, k, v, 1), atol=ATOL, rtol=RTOL)
    if inputs is _orthogonal:  # all logits equal: the uniform mean of v
        np.testing.assert_allclose(got, np.broadcast_to(v.mean(1, keepdims=True), got.shape),
                                   atol=ATOL, rtol=RTOL)
    else:  # the running max's answer: one-hot on the dominant key
        np.testing.assert_allclose(got, flash.plain_tok_flash(
            *map(torch.from_numpy, (q, k, v)), 1).numpy(), atol=ATOL, rtol=RTOL)


def test_cauchy_schwarz_bound_matches_jax():
    from aniportrait_tpu.ops.pallas_attention import _bounds_cauchy_schwarz

    rs = np.random.RandomState(9)
    b, sq, skv, heads, d = 2, 24, 40, 4, 16
    q = rs.randn(b, sq, heads * d).astype(np.float32)
    k = rs.randn(b, skv, heads * d).astype(np.float32)
    scale = math.log2(math.e) / math.sqrt(d)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(_bounds_cauchy_schwarz(jnp.asarray(q), jnp.asarray(k), heads, d,
                                                scale, sq))
    got = flash.cauchy_schwarz_bound(torch.from_numpy(q), torch.from_numpy(k), heads, scale)
    assert got.shape == (b, sq, heads) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref[..., :heads], atol=ATOL, rtol=RTOL)


def test_ab_entry_runs_four_agreeing_columns_on_cpu():
    rows = bench_tok_kernel.run("cpu", bench_tok_kernel.TINY, 1, log=lambda m: None)
    (row,) = rows
    assert sorted(row["ms"]) == sorted(bench_tok_kernel.VARIANTS)
    assert all(row["guard_held"][v] for v in ("bounded", "noshift", "unshifted"))
    # bf16: the variants round p differently; within two bf16 steps of the
    # largest output
    assert max(row["max_abs_diff"].values()) <= 2 ** -6 * row["runmax_max_abs"]
    assert row["sdpa_ms"] > 0 and row["cs_bound_ms"] > 0
