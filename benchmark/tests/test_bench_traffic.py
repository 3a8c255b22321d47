"""The traffic generators: the same seed gives the same inputs, another
seed others, every size of seed the driver may pass works."""

import numpy as np
import pytest
import torch

import micro
from harness import common
from harness import manifest as mf

SEEDS = [0, 7, 2**31 + 5, 2**40 + 3]


@pytest.mark.parametrize("mix", ["clip16", "clip48"])
def test_requests_are_seeded(mix):
    drv = mf.driver("pose2vid")
    cfg, traffic = micro.gen_config(), micro.traffic(mix)
    a = drv.request(cfg, traffic, SEEDS[2], 3)
    b = drv.request(cfg, traffic, SEEDS[2], 3)
    c = drv.request(cfg, traffic, SEEDS[3], 3)
    d = drv.request(cfg, traffic, SEEDS[2], 4)
    assert a[1].shape == (traffic["frames"], 64, 64, 3) and a[1].dtype == np.uint8
    assert all(np.array_equal(x, y) for x, y in zip(a[:2], b[:2])) and a[2] == b[2]
    for other in (c, d):
        assert not np.array_equal(a[1], other[1]) and a[2] != other[2]


def test_batches_are_seeded():
    drv = mf.driver("train")
    cfg, traffic = micro.train_config(), micro.traffic("stage2-steps")
    a = drv.batch_pool(cfg, traffic, SEEDS[3], "cpu", 32)
    b = drv.batch_pool(cfg, traffic, SEEDS[3], "cpu", 32)
    c = drv.batch_pool(cfg, traffic, SEEDS[1], "cpu", 32)
    assert len(a) == traffic["pool"]
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]) and not torch.equal(a[0][k], c[0][k])
        assert not torch.equal(a[0][k], a[1][k])  # the steps' batches all differ
    assert a[0]["pixel_values"].shape == (1, 8, 64, 64, 3)
    assert float(a[0]["pixel_values"].abs().max()) <= 1.0


def test_seeds_of_any_size():
    got = {common.sub_seed(s, 1, 2) for s in SEEDS}
    assert len(got) == len(SEEDS) and all(0 <= g < 2**63 for g in got)
    assert common.sub_seed(SEEDS[3], 1) == common.sub_seed(SEEDS[3], 1)
    torch.Generator().manual_seed(max(got))  # a torch seed


def test_weights_are_seeded():
    from harness import weights

    a = dict(weights.iter_state_dicts(micro.MODELS, SEEDS[2], "cpu", ("pose_guider",)))
    b = dict(weights.iter_state_dicts(micro.MODELS, SEEDS[2], "cpu", ("pose_guider",)))
    c = dict(weights.iter_state_dicts(micro.MODELS, SEEDS[0], "cpu", ("pose_guider",)))
    w = "conv_layers.0.weight"
    assert torch.equal(a["pose_guider"][w], b["pose_guider"][w])
    assert not torch.equal(a["pose_guider"][w], c["pose_guider"][w])
    assert float(a["pose_guider"]["scale"]) == 1.0
    assert float(a["pose_guider"]["conv_layers.0.bias"].abs().max()) == 0.0
