"""The port's normalisation (``aniportrait_tpu_torch/ops/kernels/norm.py``)
on the CPU.

The models' GroupNorm and LayerNorm take kernels N1 and N2 only for CUDA
bf16 calls that autograd does not record; on the CPU (and in float32) they
take the plain versions, which must be the float32 composition the port ran
before the kernels, bit for bit, with the call sites' SiLU and positional
encoding applied as before.  The kernels themselves are tested on the card
in tests/test_torch_cuda.py.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from aniportrait_tpu_torch.models.attention import LayerNorm
from aniportrait_tpu_torch.models.motion_module import TemporalTransformerBlock
from aniportrait_tpu_torch.models.resnet import GroupNorm, ResnetBlock3D
from aniportrait_tpu_torch.ops import kernels as K
from aniportrait_tpu_torch.ops.kernels import norm
from test_torch_modules import one_thread  # noqa: F401 (autouse)

DTYPES = [torch.float32, torch.bfloat16]


def _rand(seed, *shape, dtype=torch.float32):
    rs = np.random.RandomState(seed)
    return torch.from_numpy(rs.randn(*shape).astype(np.float32) * 2 + 0.5).to(dtype)


def composition_group_norm(x, gn: GroupNorm, video_length: int = 1):
    """``GroupNorm.forward`` as the port computed it before N1."""
    xf = x.float()
    pooled = not gn.inflated and video_length > 1
    if pooled:
        bf, c, h, w = x.shape
        xf = xf.reshape(bf // video_length, video_length, c, h, w).transpose(1, 2)
    y = F.group_norm(xf, gn.num_groups, gn.weight.float(), gn.bias.float(), gn.eps)
    if pooled:
        y = y.transpose(1, 2).reshape(bf, c, h, w)
    return y.to(x.dtype)


def composition_layer_norm(x, ln: LayerNorm):
    """``LayerNorm.forward`` as the port computed it before N2."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps).to(x.dtype)


def _affine(mod, seed, dtype):
    with torch.no_grad():
        mod.weight.copy_(_rand(seed, *mod.weight.shape) * 0.3 + 1)
        mod.bias.copy_(_rand(seed + 1, *mod.bias.shape) * 0.3)
    return mod.to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("inflated", [True, False])
@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_module_is_the_composition(dtype, inflated, silu):
    """GroupNorm on the CPU, per frame and pooled over a sample's frames,
    with and without the fused SiLU: the composition (then ``F.silu`` in
    the input's dtype) bit for bit, and N1 does not launch."""
    gn = _affine(GroupNorm(4, 24, eps=1e-6, inflated=inflated), 3, dtype)
    x = _rand(0, 6, 24, 5, 3, dtype=dtype)
    before = K.launch_counts()
    got = gn(x, 3, silu=silu)
    want = composition_group_norm(x, gn, 3)
    want = F.silu(want) if silu else want
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(norm.group_norm(x, 4, gn.weight, gn.bias, gn.eps,
                                       1 if inflated else 3, silu), want)
    assert K.launch_counts() == before


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_pe", [False, True])
def test_layer_norm_module_is_the_composition(dtype, with_pe):
    """LayerNorm on the CPU, with and without the motion module's
    positional encoding: ``composition(x) + pe[:, :f, None, :].to(dtype)``
    bit for bit (the encoding buffer in float32 and in the model's dtype),
    and N2 does not launch."""
    b, f, s, c = 2, 5, 3, 16
    ln = _affine(LayerNorm(c, eps=1e-5), 5, dtype)
    x = _rand(1, b, f, s, c, dtype=dtype)
    before = K.launch_counts()
    for pe_buffer in (_rand(2, 1, 8, c), _rand(2, 1, 8, c, dtype=dtype)):
        pe = pe_buffer[0, :f] if with_pe else None
        got = ln(x, pe=pe)
        want = composition_layer_norm(x, ln)
        if with_pe:
            want = want + pe_buffer[:, :f, None, :].to(dtype)
        assert got.dtype == dtype and torch.equal(got, want)
        assert torch.equal(norm.layer_norm(x, ln.weight, ln.bias, ln.eps, pe), want)
    assert K.launch_counts() == before


@pytest.mark.parametrize("dtype", DTYPES)
def test_call_sites_keep_their_rounding(dtype):
    """The SiLU folded into ResnetBlock3D's norms and the encoding folded
    into TemporalTransformerBlock's norms give the blocks' earlier outputs
    bit for bit."""
    torch.manual_seed(0)
    block = ResnetBlock3D(32, 48, 16, groups=8).to(dtype)
    for m in (block.norm1, block.norm2):
        _affine(m, 7, dtype)
    x, temb = _rand(3, 4, 32, 6, 6, dtype=dtype), _rand(4, 2, 16, dtype=dtype)
    with torch.no_grad():
        h = block.conv1(F.silu(composition_group_norm(x, block.norm1, 2)))
        t = block.time_emb_proj(F.silu(temb))
        h = h + t.repeat_interleave(2, dim=0)[:, :, None, None]
        h = block.conv2(F.silu(composition_group_norm(h, block.norm2, 2)))
        want = block.conv_shortcut(x) + h
        assert torch.equal(block(x, temb, 2), want)

    tb = TemporalTransformerBlock(32, 2, pe_max_len=8).to(dtype)
    y = _rand(5, 2, 4, 3, 32, dtype=dtype)
    with torch.no_grad():
        want = y
        for attn, ln in zip(tb.attention_blocks, tb.norms):
            pe = attn.pos_encoder.pe[:, :4, None, :].to(dtype)
            want = want + attn(composition_layer_norm(want, ln) + pe)
        want = want + tb.ff(composition_layer_norm(want, tb.ff_norm))
        assert torch.equal(tb(y), want)


def _stand_in(cuda=True, dtype=torch.bfloat16, requires_grad=False):
    return SimpleNamespace(is_cuda=cuda, dtype=dtype, requires_grad=requires_grad)


@pytest.mark.parametrize("grad_mode", [False, True])
def test_engages_on_cuda_bf16_calls_autograd_does_not_record(grad_mode):
    """The kernels' rule, from what the call can see: a CUDA bf16 input,
    and either gradients off or nothing (input, weight, bias) requiring
    one.  CPU tensors, float32 and recorded calls keep the composition."""
    frozen = _stand_in()
    trained = _stand_in(requires_grad=True)
    with torch.set_grad_enabled(grad_mode):
        assert norm.engages(_stand_in(), frozen, frozen)
        assert not norm.engages(_stand_in(cuda=False), frozen, frozen)
        assert not norm.engages(_stand_in(dtype=torch.float32), frozen, frozen)
        assert not norm.engages(torch.zeros(2, dtype=torch.bfloat16), frozen, frozen)
        recorded = (_stand_in(requires_grad=True), frozen, frozen), \
            (_stand_in(), trained, frozen), (_stand_in(), frozen, trained)
        for args in recorded:
            assert norm.engages(*args) is (not grad_mode)


def test_norm_reckoning_counts_the_models_norm_calls(monkeypatch):
    """``chip_smoke.norm_reckoning``, which the card's pipeline phase holds
    N1 and N2 to, counts the norm calls of one micro request (CLIP, the VAE
    encoder, the ReferenceNet, the PoseGuider, the denoising UNet a step,
    the VAE decoder a chunk)."""
    import chip_smoke
    from aniportrait_tpu_torch import factory

    calls = {"N1": 0, "N2": 0}
    for name, kid in (("plain_group_norm", "N1"), ("plain_layer_norm", "N2")):
        def counted(*args, _fn=getattr(norm, name), _kid=kid, **kwargs):
            calls[_kid] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(norm, name, counted)
    pipe = factory.build_pipeline("micro", device="cpu", dtype=torch.float32, seed=3)
    rs = np.random.RandomState(4)
    res, frames, steps, chunk = 64, 3, 2, 2
    ref = rs.randint(0, 255, (res, res, 3), np.uint8)
    poses = [rs.randint(0, 255, (res, res, 3), np.uint8) for _ in range(frames)]
    pipe(ref, poses, None, width=res, height=res, video_length=frames,
         num_inference_steps=steps, guidance_scale=3.5, seed=0, decode_chunk=chunk)
    want = chip_smoke.norm_reckoning(pipe.m, unet_calls=steps, decode_chunks=2)
    assert all(want.values()), want
    assert calls == want
