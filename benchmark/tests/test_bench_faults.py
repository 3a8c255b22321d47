"""Each fault a cell can have, planted under the timed path, turns
``correct`` false: a whole run of the cell's driver at micro size on the
CPU (the look for a card skipped), float32, with limits for that size (its
sound runs read 0.02 levels and 1e-5; ``readings.py`` reads the same faults
at the cells' own size on the card against the cells' limits)."""

import pytest

import micro
from harness import faults
from harness import manifest as mf

GEN_LIMITS = {"frames_rmse": 0.1}
TRAIN_LIMITS = {"loss_rel": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3}


def run_gen(mix, fault=None):
    ctx = micro.context(micro.gen_config(), micro.traffic(mix, limits=GEN_LIMITS),
                        seconds=0.3)
    if fault is None:
        return mf.driver("pose2vid").run(ctx)
    with faults.gen_fault(fault):
        return mf.driver("pose2vid").run(ctx)


def run_train(fault=None):
    ctx = micro.context(micro.train_config(), micro.traffic("stage2-steps",
                                                            limits=TRAIN_LIMITS),
                        seconds=0.3)
    if fault is None:
        return mf.driver("train").run(ctx)
    with faults.train_fault(fault):
        return mf.driver("train").run(ctx)


@pytest.mark.parametrize("mix", ["clip16", "clip48"])
@pytest.mark.parametrize("fault", [None, *faults.GEN])
def test_generation_fault_is_caught(mix, fault):
    out = run_gen(mix, fault)
    assert out.correct is (fault is None), out.checks


@pytest.mark.parametrize("fault", [None, *faults.TRAIN])
def test_training_fault_is_caught(fault):
    out = run_train(fault)
    assert out.correct is (fault is None), out.checks
