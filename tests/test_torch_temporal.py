"""The tensor-core kernels' contracts on the CPU.

(a) ``temporal.plain_nat_temporal_rounded``, the rounding contract of the
    bf16 temporal kernel (``csrc/temporal_attn_sm90.cu``), against the JAX
    ``nat_packed`` on its Pallas kernel in interpret mode, both on the same
    bf16 inputs: within 2^-10 of the largest |output|, an eighth of a bf16
    step (the exact float32 softmax, ``plain_nat_temporal``, misses the
    Pallas output by a whole step at the third shape).
(b) The forms the C entry points choose by dtype and head dim:
    ``flash.backward_form`` (tensor-core backward for bf16 up to d = 128)
    and ``temporal.forward_form`` (tensor-core temporal kernel for bf16 with
    d % 8 == 0).
The kernels themselves are tested in tests/test_torch_cuda.py.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aniportrait_tpu_torch.ops import kernels as K
from aniportrait_tpu_torch.ops.kernels import flash, temporal


@pytest.mark.parametrize("b,f,s,c,heads", [(2, 8, 32, 16, 2), (1, 16, 16, 32, 4),
                                           (2, 16, 64, 64, 4)])
def test_k3_rounded_contract_matches_pallas_bf16(b, f, s, c, heads):
    from aniportrait_tpu.ops.pallas_attention import nat_packed

    rs = np.random.RandomState(2)
    x = [rs.randn(b * f, s, c).astype(np.float32) for _ in range(3)]
    scale = math.log2(math.e) / math.sqrt(c // heads)  # the base-2 contract
    ref = nat_packed(*(jnp.asarray(a, jnp.bfloat16) for a in x), f, heads, True, scale)
    ref = np.asarray(ref.astype(jnp.float32))
    tx = [torch.from_numpy(a).bfloat16() for a in x]
    port = temporal.plain_nat_temporal_rounded(*tx, f, heads, scale)
    assert port.dtype == torch.bfloat16
    # the wrapper takes it for bf16 CPU tensors, as the card takes the
    # tensor-core form
    assert torch.equal(K.nat_temporal(*tx, f, heads, scale), port)
    err = np.abs(port.float().numpy() - ref).max()
    assert err <= 2.0 ** -10 * np.abs(ref).max()


@pytest.mark.parametrize("dtype,d,bwd,temporal_form", [
    (torch.bfloat16, 40, "wgmma", "mma"),
    (torch.bfloat16, 88, "wgmma", "mma"),
    (torch.bfloat16, 128, "wgmma", "mma"),
    (torch.bfloat16, 160, "fma", "mma"),
    (torch.bfloat16, 20, "wgmma", "fma"),
    (torch.float32, 40, "fma", "fma"),
    (torch.float32, 160, "fma", "fma"),
])
def test_kernel_forms_by_dtype_and_head_dim(dtype, d, bwd, temporal_form):
    assert flash.backward_form(dtype, d) == bwd
    assert temporal.forward_form(dtype, d) == temporal_form
    with pytest.raises(TypeError):
        temporal.forward_form(torch.float16, d)
