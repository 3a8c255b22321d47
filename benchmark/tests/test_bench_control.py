"""The control: the plain reference in the precision below the one the
configuration states (bf16 -> fp8 operands) put in the program's place,
which the comparison must find not correct, while the program passes.

On the CPU at micro size: the control reads far above the program (in
float32 there).  On the card (``cuda``), at each cell's own size on three
seeds, against the cell's own limits: ``readings.py``'s readings."""

import pytest

import micro
from harness import check, readings
from harness import manifest as mf


def test_control_separates_at_micro_size():
    gen = readings.gen_readings(micro.gen_config(), micro.traffic("clip16"), [21], {21},
                                lambda m: None, device="cpu")[0]
    assert gen["control"]["frames_rmse"] > 50 * gen["program"]["frames_rmse"]
    train = readings.train_readings(micro.train_config(), micro.traffic("stage2-steps"),
                                    [22], {22}, lambda m: None, device="cpu")[0]
    assert train["control"]["loss_rel"] > 50 * train["program"]["loss_rel"]
    assert train["control"]["grad_gap"] > 50 * train["program"]["grad_gap"]


CELLS = ["pose2vid-512.f16", "stage2-train-512.f16", "pose2vid-512.f48-windows"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_control_fails_and_program_passes_on_the_card(cell_name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size")
    manifest = mf.load_manifest()
    if cell_name not in {w["name"] for w in manifest["workloads"]}:
        pytest.skip(f"{cell_name} is not a cell of BENCHMARK.json")
    cell = mf.workload(manifest, cell_name)
    cfg, traffic = mf.config(manifest, cell["config"]), mf.traffic(cell["traffic"])
    seeds = [2**31 + 101, 2**31 + 102, 2**31 + 103]
    fn = readings.gen_readings if traffic["kind"] == "pose2vid" else readings.train_readings
    for row in fn(cfg, traffic, seeds, set(seeds), print):
        assert check.verdict(row["program"], traffic["limits"])[0], row
        assert not check.verdict(row["control"], traffic["limits"])[0], row
