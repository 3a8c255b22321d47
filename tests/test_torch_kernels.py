"""Port kernels (aniportrait_tpu_torch/ops/kernels) against the JAX package.

(a) On the CPU each wrapper runs its plain PyTorch version; it must equal the
    JAX function on its Pallas kernel, run in interpret mode as
    tests/test_pallas_attention.py runs it: same numpy inputs, float32,
    2e-5 abs / 1e-4 rel.
(e) attention_route at the full-size main path's shapes gives the kernel the
    TPU table assigns (K1 banked, K2 token, K3 temporal, K4 head layout).
The CUDA kernels themselves are tested in tests/test_torch_cuda.py.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aniportrait_tpu_torch.ops import kernels as K
from aniportrait_tpu_torch.ops.attention import attention_route

ATOL, RTOL = 2e-5, 1e-4


def _rand(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("rep", [1, 2])
def test_k1_banked_matches_pallas(rep):
    from aniportrait_tpu.ops.pallas_attention import tok_flash_banked

    rs = np.random.RandomState(5)
    B, SQ, SB, H, D = 4, 40, 30, 2, 8  # ragged: 40 and 30 are not multiples of 16
    C = H * D
    q, k, v = _rand(rs, B, SQ, C), _rand(rs, B, SQ, C), _rand(rs, B, SQ, C)
    kb, vb = _rand(rs, B // rep, SB, C), _rand(rs, B // rep, SB, C)
    with jax.default_matmul_precision("highest"):
        ref = tok_flash_banked(*map(jnp.asarray, (q, k, v, kb, vb)), H, rep, 16, 16, True)
    port = K.tok_flash_banked(*map(torch.from_numpy, (q, k, v, kb, vb)), H, rep)
    _close(port, ref)


@pytest.mark.parametrize("entry", ["tok_flash", "flash_attention_tokens"])
def test_k2_token_flash_matches_pallas(entry):
    from aniportrait_tpu.ops import pallas_attention as pa

    rs = np.random.RandomState(3)
    B, SQ, SKV, H, D = 2, 40, 50, 2, 8
    C = H * D
    q, k, v = _rand(rs, B, SQ, C), _rand(rs, B, SKV, C), _rand(rs, B, SKV, C)
    with jax.default_matmul_precision("highest"):
        ref = getattr(pa, entry)(*map(jnp.asarray, (q, k, v)), H, 16, 16, True)
    _close(K.tok_flash(*map(torch.from_numpy, (q, k, v)), H), ref)


@pytest.mark.parametrize("b,f,s,c,heads", [(2, 8, 32, 16, 2), (1, 16, 16, 32, 4)])
def test_k3_temporal_matches_pallas(b, f, s, c, heads):
    from aniportrait_tpu.ops.pallas_attention import nat_packed

    rs = np.random.RandomState(2)
    q, k, v = (_rand(rs, b * f, s, c) for _ in range(3))
    scale = math.log2(math.e) / math.sqrt(c // heads)  # the base-2 contract
    with jax.default_matmul_precision("highest"):
        ref = nat_packed(*map(jnp.asarray, (q, k, v)), f, heads, True, scale)
    # the wrapper takes the same base-2 scale and converts it
    _close(K.nat_temporal(*map(torch.from_numpy, (q, k, v)), f, heads, scale), ref)


@pytest.mark.parametrize("drop", [None, [1, 0, 1, 0]])
def test_k4_head_flash_matches_pallas(drop):
    from aniportrait_tpu.ops.pallas_attention import flash_attention

    rs = np.random.RandomState(1)
    B, SQ, SKV, H, D = 4, 40, 50, 2, 8
    q, k, v = _rand(rs, B, SQ, H, D), _rand(rs, B, SKV, H, D), _rand(rs, B, SKV, H, D)
    split = None if drop is None else 30
    drop_np = None if drop is None else np.asarray(drop, np.int32)
    with jax.default_matmul_precision("highest"):
        ref = flash_attention(
            *map(jnp.asarray, (q, k, v)),
            drop_tail=None if drop is None else jnp.asarray(drop_np),
            kv_split=split, block_q=16, block_kv=16, interpret=True,
        )
    port = K.flash_attention(
        *map(torch.from_numpy, (q, k, v)),
        None if drop is None else torch.from_numpy(drop_np), split,
    )
    _close(port, ref)


# full-size main-path shapes (SD-1.5 widths, 512 px, 16 frames, CFG) -> route
MAIN_PATH_ROUTES = [
    # cond CFG half at 64x64: 16 frame rows over self + bank
    (dict(batch=16, sq=4096, skv=4096, heads=8, head_dim=40, bank=4096), "K1"),
    # uncond half and the ReferenceNet at 64x64
    (dict(batch=16, sq=4096, skv=4096, heads=8, head_dim=40), "K2"),
    (dict(batch=2, sq=4096, skv=4096, heads=8, head_dim=40), "K2"),
    # c=640: cond half through the concat, uncond and ReferenceNet self
    (dict(batch=16, sq=1024, skv=1024, heads=8, head_dim=80, bank=1024), "K2"),
    (dict(batch=16, sq=1024, skv=1024, heads=8, head_dim=80), "K2"),
    (dict(batch=2, sq=1024, skv=1024, heads=8, head_dim=80), "K2"),
    # motion modules at every resolution
    (dict(batch=2, sq=4096, skv=4096, heads=8, head_dim=40, frames=16), "K3"),
    (dict(batch=2, sq=1024, skv=1024, heads=8, head_dim=80, frames=16), "K3"),
    (dict(batch=2, sq=256, skv=256, heads=8, head_dim=160, frames=16), "K3"),
    (dict(batch=2, sq=64, skv=64, heads=8, head_dim=160, frames=16), "K3"),
    # PoseGuider stage-0 transformer at 32x32 (16 x 88, inner 1408)
    (dict(batch=16, sq=1024, skv=1024, heads=16, head_dim=88), "K4"),
    # below the flash threshold or left to XLA by the JAX package
    (dict(batch=16, sq=256, skv=256, heads=16, head_dim=88), "sdpa"),
    (dict(batch=16, sq=256, skv=256, heads=8, head_dim=160, bank=256), "sdpa"),
    (dict(batch=32, sq=64, skv=64, heads=8, head_dim=160), "sdpa"),
    (dict(batch=32, sq=4096, skv=1, heads=8, head_dim=40), "single_kv"),
    (dict(batch=1, sq=257, skv=257, heads=16, head_dim=64), "sdpa"),  # CLIP
    (dict(batch=8, sq=4096, skv=4096, heads=1, head_dim=512), "sdpa"),  # VAE
    # frame counts the temporal kernel cannot pack: JAX's K6 (not ported)
    (dict(batch=2, sq=4100, skv=4100, heads=8, head_dim=40, frames=16), "K6"),
    (dict(batch=2, sq=64, skv=64, heads=8, head_dim=40, frames=1), "single_kv"),
]


@pytest.mark.parametrize("shape,route", MAIN_PATH_ROUTES)
def test_attention_route_main_path(shape, route):
    assert attention_route(**shape) == route
