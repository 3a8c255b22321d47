"""K6 (attention within many short sequences) of the port against the JAX
package.

On the CPU the wrapper ``ops.kernels.ctg_packed`` runs its plain version and
``CtgPacked``'s backward is autograd of it; both must equal the JAX
``ctg_packed`` on its Pallas kernel in interpret mode and ``jax.vjp`` of it:
same numpy inputs, float32, 2e-5 abs / 1e-4 rel.  The port's generic
attention entry must equal the JAX ``small_seq_attention`` on the Pallas
route.  The CUDA kernel itself is tested in tests/test_torch_cuda.py.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aniportrait_tpu_torch.ops import kernels as K
from aniportrait_tpu_torch.ops.attention import scaled_dot_product_attention
from aniportrait_tpu_torch.ops.kernels.autograd import CtgPacked

ATOL, RTOL = 2e-5, 1e-4


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def _packed(rs, seq, heads, d, n_seqs):
    """q, k, v in the JAX packing (n, g * seq, C), g = 128 // seq, and an
    output gradient."""
    g = max(1, 128 // seq)
    n = -(-n_seqs // g)
    shape = (n, g * seq, heads * d)
    return [rs.randn(*shape).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("seq,heads,d", [(4, 2, 8), (16, 4, 8), (24, 2, 16)])
def test_k6_forward_and_vjp_match_pallas(seq, heads, d):
    from aniportrait_tpu.ops.pallas_attention import ctg_packed

    rs = np.random.RandomState(seq)
    q, k, v, g = _packed(rs, seq, heads, d, 40)
    scale = math.log2(math.e) / math.sqrt(d)  # the base-2 contract

    def jax_fn(a, b, c):
        return ctg_packed(a, b, c, seq, heads, True, scale)

    with jax.default_matmul_precision("highest"):
        ref, vjp = jax.vjp(jax_fn, *map(jnp.asarray, (q, k, v)))
        ref_grads = vjp(jnp.asarray(g))
    _close(K.ctg_packed(*map(torch.from_numpy, (q, k, v)), seq, heads, scale), ref)
    # the kernel is per sequence: (n * g, seq, C) is the same call
    flat = [torch.from_numpy(x).reshape(-1, seq, heads * d) for x in (q, k, v)]
    _close(K.ctg_packed(*flat, seq, heads, scale).reshape(q.shape), ref)

    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = CtgPacked.apply(*leaves, seq, heads, scale)
    _close(out, ref)
    out.backward(torch.from_numpy(g))
    for leaf, r in zip(leaves, ref_grads):
        _close(leaf.grad, r)


@pytest.mark.parametrize("b,s,h,d", [(130, 16, 8, 4), (40, 24, 2, 8)])
def test_sdpa_short_sequences_match_jax_small_seq(b, s, h, d):
    """The port's generic entry routes these shapes to K6 (b * h >= 1024 or
    not) exactly as the JAX dispatch does; held to the JAX Pallas route."""
    from aniportrait_tpu.ops.attention import small_seq_attention

    rs = np.random.RandomState(b)
    q, k, v = (rs.randn(b, s, h, d).astype(np.float32) for _ in range(3))
    with jax.default_matmul_precision("highest"):
        ref = small_seq_attention(*map(jnp.asarray, (q, k, v)), impl="pallas")
    before = K.ctg_packed.launches
    _close(scaled_dot_product_attention(*map(torch.from_numpy, (q, k, v))), ref)
    assert K.ctg_packed.launches == before  # CPU tensors: the plain version


@pytest.mark.parametrize("dtype,d,form", [
    (torch.bfloat16, 8, "mma"), (torch.bfloat16, 40, "mma"), (torch.bfloat16, 160, "mma"),
    (torch.bfloat16, 20, "fma"), (torch.float32, 40, "fma"), (torch.float32, 20, "fma"),
])
def test_forward_form_by_dtype_and_head_dim(dtype, d, form):
    """bf16 with d % 8 == 0 takes the tensor-core form of K6 and K9 on the
    card, everything else the FMA kernel; other dtypes have no form.  On
    the CPU no form runs and no tensor-core launch is counted."""
    from aniportrait_tpu_torch.ops.kernels import small_seq

    assert small_seq.forward_form(dtype, d) == form
    with pytest.raises(TypeError):
        small_seq.forward_form(torch.float16, d)
    before = small_seq.tensor_core_launches
    x = torch.zeros(2, 16, 2 * d, dtype=dtype)
    K.ctg_packed(x, x, x, 16, 2, 0.3)
    K.ssa_packed(x, x, x, 8)
    assert small_seq.tensor_core_launches == before
