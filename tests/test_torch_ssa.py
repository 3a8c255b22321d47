"""K9 (head-folded packed short-sequence attention) of the port against the
JAX package.

On the CPU the wrapper ``ops.kernels.ssa_packed`` runs its plain version and
``SsaPacked``'s backward is autograd of it; both must equal the JAX
``ssa_packed`` on its Pallas kernel in interpret mode and ``jax.vjp`` of it:
same numpy inputs, float32, 2e-5 abs / 1e-4 rel.  The cases are a full
(4, 128, 64) tile at seq 16 and a dead tail (seq 24, rows 120-127 dead, the
last group straddling n_valid_rows).  The port's head-folded entry equals
the JAX ``small_seq_attention`` on its head-folded route.  The CUDA kernel is
tested in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aniportrait_tpu_torch.ops import kernels as K
from aniportrait_tpu_torch.ops.attention import small_seq_attention_folded
from aniportrait_tpu_torch.ops.kernels.autograd import SsaPacked

ATOL, RTOL = 2e-5, 1e-4


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n,t,dp,seq,nv", [(4, 128, 64, 16, 128), (3, 128, 16, 24, 120)])
def test_k9_forward_and_vjp_match_pallas(n, t, dp, seq, nv):
    from aniportrait_tpu.ops.pallas_attention import ssa_packed

    rs = np.random.RandomState(seq)
    q, k, v, g = (rs.randn(n, t, dp).astype(np.float32) for _ in range(4))

    def jax_fn(a, b, c):
        return ssa_packed(a, b, c, seq, nv, True)

    with jax.default_matmul_precision("highest"):
        ref, vjp = jax.vjp(jax_fn, *map(jnp.asarray, (q, k, v)))
        ref_grads = vjp(jnp.asarray(g))
    before = K.ssa_packed.launches
    _close(K.ssa_packed(*map(torch.from_numpy, (q, k, v)), seq, nv), ref)

    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = SsaPacked.apply(*leaves, seq, nv)
    _close(out, ref)
    out.backward(torch.from_numpy(g))
    for leaf, r in zip(leaves, ref_grads):
        _close(leaf.grad, r)
    assert K.ssa_packed.launches == before  # CPU tensors: the plain version


@pytest.mark.parametrize("b,s,h,d", [(21, 16, 4, 8), (7, 24, 2, 8)])
def test_folded_entry_matches_jax_head_folded_route(b, s, h, d):
    """B * H sequences that fill no whole number of tiles (dead sequences
    pad the last tile); held to the JAX route that packs the same way."""
    from aniportrait_tpu.ops.attention import small_seq_attention

    rs = np.random.RandomState(b)
    q, k, v = (rs.randn(b, s, h, d).astype(np.float32) for _ in range(3))
    with jax.default_matmul_precision("highest"):
        ref = small_seq_attention(*map(jnp.asarray, (q, k, v)), impl="xla")
    _close(small_seq_attention_folded(*map(torch.from_numpy, (q, k, v))), ref)
