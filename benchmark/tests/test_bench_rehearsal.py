"""A rehearsal of each traffic mix on the CPU at micro size, float32: the
cell's whole loop (set-up, the window rule, the seeded inputs, the
comparison with the plain reference, the result line) through its driver.
Nothing here is printed: a CPU number is never a device metric.  And
``run.py`` itself refuses to run without a card."""

import json
import subprocess
import sys

import pytest

import micro
from harness import cli
from harness import manifest as mf

CASES = {
    "clip16": (micro.gen_config, {"frames_rmse": 0.5}, "pose2vid-512.f16"),
    "clip48": (micro.gen_config, {"frames_rmse": 0.5}, "pose2vid-512.f48-windows"),
    "stage2-steps": (micro.train_config, {"loss_rel": 1e-4, "grad_gap": 1e-3,
                                          "change_gap": 1e-3}, "stage2-train-512.f16"),
}


@pytest.mark.parametrize("mix", sorted(CASES))
def test_rehearsal(mix):
    make_cfg, limits, cell_name = CASES[mix]
    traffic = micro.traffic(mix, limits=limits)
    logs = []
    ctx = micro.context(make_cfg(), traffic, seconds=0.8, logs=logs)
    out = mf.driver(traffic["kind"]).run(ctx)
    assert out.correct, (out.checks, logs)
    assert out.attempted >= 1 and out.failed == 0
    manifest = mf.load_manifest()
    cell = mf.workload(manifest, cell_name)
    line = cli.result_line(cell, out, 0, manifest, "rehearsal")
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {m["name"] for m in mf.cell_metrics(manifest, cell,
                                                                       "end_to_end")}
    assert all(v["value"] > 0 for k, v in line["metrics"].items() if k != "peak_mem_gib")
    assert set(line["checks"]) == set(limits)
    json.dumps(line)
    layer_line = cli.result_line(cell, out, 1, manifest, "rehearsal")
    assert all(v["value"] > 0 for v in layer_line["metrics"].values())
    if traffic["kind"] == "train":  # read from the optimizer, no trace needed
        assert "train.optimizer_state_gib" in layer_line["metrics"]


def test_run_refuses_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(mf.BENCH_DIR / "run.py"), "--workload",
                          "pose2vid-512.f16", "--seed", "3", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_run_fails_without_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copytree(mf.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(mf.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "pose2vid-512.f16", "--seed", "3", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert out.returncode != 0 and out.stdout == ""
