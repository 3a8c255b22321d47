"""The plain reference against the port at micro size on the CPU, model by
model, from the same weights: the same names and shapes, and the same
outputs to float32 rounding (both sides compute in float32 here; the port's
kernels run their plain versions on the CPU)."""

import pytest
import torch

import micro
from harness import weights
from reference.models import make_models

SEED = 2**33 + 1


@pytest.fixture(scope="module")
def pair():
    from aniportrait_tpu_torch import factory

    port = factory.make_models("micro")
    for role, state in weights.iter_state_dicts(micro.MODELS, SEED, "cpu"):
        weights.load_into(port[role], state)
    ref = weights.reference_models(micro.MODELS, SEED, "cpu")
    return {k: m.eval() for k, m in port.items()}, ref


def close(a, b):
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_same_parameters():
    from aniportrait_tpu_torch import factory

    port = factory.make_models("micro")
    with torch.device("meta"):
        ref = make_models(micro.MODELS)
    for role in weights.ROLES:
        a = {k: tuple(v.shape) for k, v in port[role].state_dict().items()}
        b = {k: tuple(v.shape) for k, v in ref[role].state_dict().items()}
        assert a == b, role


@torch.no_grad()
def test_encoders(pair):
    port, ref = pair
    g = torch.Generator().manual_seed(0)
    img = torch.rand(2, 3, 64, 64, generator=g) * 2 - 1
    close(port["vae"].encode(img)[0], ref["vae"].encode(img)[0])
    z = torch.randn(2, 4, 8, 8, generator=g)
    close(port["vae"].decode(z), ref["vae"].decode(z))
    clip = torch.randn(1, 3, 32, 32, generator=g)
    close(port["clip"](clip), ref["clip"](clip))
    pose = torch.rand(1, 4, 3, 64, 64, generator=g) * 2 - 1
    for a, b in zip(port["pose_guider"](pose), ref["pose_guider"](pose)):
        close(a, b)


@torch.no_grad()
def test_unets(pair):
    port, ref = pair
    g = torch.Generator().manual_seed(1)
    ctx = torch.randn(2, 1, 16, generator=g)
    lat = torch.randn(2, 1, 4, 8, 8, generator=g)
    t = torch.zeros(2, dtype=torch.long)
    _, banks_p = port["reference_unet"](lat, t, ctx, capture_banks=True)
    _, banks_r = ref["reference_unet"](lat, t, ctx)
    assert set(banks_p) == set(banks_r)
    for k in banks_p:
        close(banks_p[k], banks_r[k])
    f = 16
    x = torch.randn(2, f, 4, 8, 8, generator=g)
    pose = ref["pose_guider"](torch.rand(1, f, 3, 64, 64, generator=g) * 2 - 1)
    pose = [p.expand(2, -1, -1, -1, -1) for p in pose]
    tt = torch.full((2,), 500, dtype=torch.long)
    out_p, _ = port["denoising_unet"](x, tt, ctx, pose_cond_fea=pose, ref_banks=banks_p,
                                      drop_mode="first_half")
    out_r, _ = ref["denoising_unet"](x, tt, ctx, pose, banks_r, bank_rows=[False, True])
    close(out_p, out_r)
