"""The port's multi-process paths (``aniportrait_tpu_torch/parallel``) on
the CPU: ranks are processes spawned over gloo (``parallel.launch.spawn``,
one intra-op thread each, no JAX), at micro size, against one process.

(a) The motion module under frame-block sharding (all-to-all to spatial
    positions) equals the unsharded module in float32 within 1e-5, whole
    clip and with a window table, at 2 and 4 ranks.
(b) One data-parallel stage-1 step at 2 ranks, float32 AdamW and 8-bit
    AdamW under ZeRO-1, equals the single-process step on the global batch
    with ``tests/test_parallel.py``'s ZeRO-1 tolerances (loss rtol 2e-5;
    weights atol 2e-5, rtol 2e-4), with rank 1's models built from another
    seed (the trainer replicates rank 0's).  Those weight bounds cannot see
    the gradient: Adam's first step moves a weight by ~lr * sign(g), 1e-5
    here.  So the averaged gradient the optimizer took is held to the global
    batch's within GRAD_RTOL of the largest, the norm before the clip within
    GRAD_RTOL, and each weight's move to the single process's within
    MOVE_TOL lr (plus two float32 spacings of the weight) wherever the
    gradient's sign is clear, where every weight moved by at least lr / 2.  The
    PoseGuider's running statistics equal the global batch's; each rank's
    optimizer state is at most total / ranks plus the largest parameter's.
(c) The synchronised BatchNorm: the PoseGuider's output rows, running
    statistics and weight gradients at 2 ranks equal one process on the
    global batch.
(d) ``init_distributed()`` is a no-op without torchrun's environment;
    ``FaceDataset.shard`` gives disjoint, complete, balanced shards.
(e) The sampler's options under a mesh (context rotation, the encoder
    cache, latent interpolation) at 2 and 4 ranks equal one process.
(f) The stage-1 CLI under ``torchrun`` (2 CPU ranks): rank 0 alone writes,
    the checkpoint holds every owner's optimizer state, a ``'latest'``
    resume restores on every rank, and a train_bs the ranks do not divide
    is refused.

The sampler's mesh paths are held to JAX's mesh outputs and to one process
in tests/test_torch_parallel_jax.py.  Spawns are grouped: one call of each
world size runs every case of this file.
"""

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from aniportrait_tpu_torch.parallel.launch import spawn
from aniportrait_tpu_torch.parallel.mesh import make_mesh
from aniportrait_tpu_torch.train.stage1 import Stage1Settings
from test_torch_modules import one_thread  # noqa: F401 (autouse)

MM_ATOL = 1e-5
LOSS_RTOL, W_ATOL, W_RTOL = 2e-5, 2e-5, 2e-4  # tests/test_parallel.py's ZeRO-1 bounds
# float32 sums over other row splits, grown through the PoseGuider's eight
# BatchNorms (E[x^2] - E[x]^2 cancels): its first conv's gradient differs by
# 3.3e-5 of the largest gradient, the norm before the clip by 1.2e-5
GRAD_RTOL = 1e-4
# Adam's first move is lr * g / (|g| + eps): where |g| is 10 x the gradient's
# bound, a sign flip is out and the move differs by eps / |g| of lr at most
MOVE_TOL = 1e-2
DP_LR = Stage1Settings().learning_rate  # dp_step's
BN_ATOL = 1e-5
VIDEO_ATOL = 1.5 / 255  # tests/test_parallel.py's: a uint8 rounding flip


@pytest.fixture(scope="module")
def runs():
    single = ranks.world2(make_mesh())  # no process group: one rank
    return single, {2: spawn(ranks.world2, 2, timeout=600),
                    4: spawn(ranks.world4, 4, timeout=600)}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", ["mm", "mm_win"])
def test_motion_module_all_to_all_equals_unsharded(runs, world, case):
    single, multi = runs
    got = np.concatenate([r[case] for r in multi[world]], axis=1)
    assert got.shape == single[case].shape
    np.testing.assert_allclose(got, single[case], atol=MM_ATOL, rtol=0)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", ["rotate", "cache", "fused_cache_interp"])
def test_sampler_options_compose_with_the_mesh(runs, world, case):
    """Context rotation, the encoder cache (k = 2, 3 steps) and latent
    interpolation under a mesh equal one process within 1.5/255, and every
    rank returns the same video."""
    single, multi = runs
    want = single["options"][case]
    videos = [r["options"][case] for r in multi[world]]
    for v in videos:
        np.testing.assert_array_equal(v, videos[0])
    assert videos[0].shape == want.shape
    np.testing.assert_allclose(videos[0], want, atol=VIDEO_ATOL)


@pytest.mark.parametrize("adam_8bit", [False, True])
def test_data_parallel_zero1_step_equals_global_batch_step(runs, adam_8bit):
    single, multi = runs
    want = single["dp"][adam_8bit]
    before = want["before"]
    scale = max(float(np.abs(g).max()) for g in want["grads"].values())
    assert scale > 0
    for rank, got in enumerate(r["dp"][adam_8bit] for r in multi[2]):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=GRAD_RTOL)
        assert got["params"].keys() == want["params"].keys()
        for k, w in want["params"].items():
            np.testing.assert_allclose(got["params"][k], w, atol=W_ATOL, rtol=W_RTOL,
                                       err_msg=f"rank {rank} {k}")
            g = want["grads"][k]
            np.testing.assert_allclose(got["grads"][k], g, atol=GRAD_RTOL * scale, rtol=0,
                                       err_msg=f"rank {rank} {k} gradient")
            moved = got["params"][k].astype(np.float64) - before[k]
            want_moved = w.astype(np.float64) - before[k]
            clear = np.abs(g) > 10 * GRAD_RTOL * scale
            bound = MOVE_TOL * DP_LR + 2 * np.spacing(np.abs(before[k]))
            bad = clear & (np.abs(moved - want_moved) > bound)
            assert not bad.any(), (f"rank {rank} {k}: {int(bad.sum())} of {int(clear.sum())} "
                                   "clear-gradient weights moved otherwise than one process's")
            if clear.any():
                assert np.abs(moved[clear]).min() > DP_LR / 2, f"rank {rank} {k} did not move"
        for k, w in want["stats"].items():
            np.testing.assert_allclose(got["stats"][k], w, atol=BN_ATOL, rtol=1e-5,
                                       err_msg=f"rank {rank} {k}")


@pytest.mark.parametrize("adam_8bit", [False, True])
def test_zero1_state_bytes_per_rank(runs, adam_8bit):
    single, multi = runs
    total = single["dp"][adam_8bit]["state_bytes"]
    per_rank = [r["dp"][adam_8bit]["state_bytes"] for r in multi[2]]
    largest = single["dp"][adam_8bit]["largest"]
    assert sum(per_rank) == total
    assert max(per_rank) <= total / 2 + largest, (per_rank, total, largest)
    assert min(per_rank) > 0


def test_sync_batch_norm_takes_the_global_batch(runs):
    single, multi = runs
    want = single["bn"]
    got = [r["bn"] for r in multi[2]]
    np.testing.assert_allclose(np.concatenate([g["out"] for g in got]), want["out"],
                               atol=BN_ATOL, rtol=1e-5)
    # a conv bias ahead of a BatchNorm has a gradient that is zero but for
    # rounding, so each gradient is held to the largest one's scale
    scale = max(float(np.abs(w).max()) for w in want["grads"].values())
    for g in got:
        for k, w in want["stats"].items():
            np.testing.assert_allclose(g["stats"][k], w, atol=BN_ATOL, rtol=1e-5, err_msg=k)
        for k, w in want["grads"].items():
            np.testing.assert_allclose(g["grads"][k], w, atol=1e-5 * scale, rtol=0,
                                       err_msg=k)


def test_init_distributed_is_a_noop_without_torchrun_env(monkeypatch):
    import torch.distributed as dist

    from aniportrait_tpu_torch.parallel import init_distributed

    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is False
    assert not dist.is_initialized()
    mesh = make_mesh()
    assert (mesh.size, mesh.rank, mesh.cfg_ways) == (1, 0, 1)


def test_dataset_shard_is_disjoint_and_complete():
    from aniportrait_tpu_torch.train.dataset import FaceDataset

    names = [f"v{i}" for i in range(10)]
    shards = []
    for rank in range(4):
        ds = FaceDataset.__new__(FaceDataset)  # shard() touches only .names
        ds.names = list(names)
        ds.shard(rank, 4)
        shards.append(ds.names)
    flat = [n for s in shards for n in s]
    assert sorted(flat) == sorted(names) and len(flat) == len(set(flat))
    assert max(map(len, shards)) - min(map(len, shards)) <= 1


def test_every_collective_is_the_identity_on_one_rank():
    mesh = make_mesh()
    x = torch.arange(6.0)
    assert torch.equal(mesh.world.all_reduce_(x.clone()), x)
    assert torch.equal(mesh.world.all_gather(x, [6])[0], x)
    assert torch.equal(mesh.world.all_to_all([x], [6])[0], x)


def _torchrun(args, tmp_path, nproc=2, steps=1):
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(root)}
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={nproc}", "-m", "aniportrait_tpu_torch.scripts.train_stage_1",
         *args, "--random-init", "--max-steps", str(steps), "--size", "micro",
         "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)


def test_training_cli_runs_under_torchrun(tmp_path):
    """``torchrun --nproc_per_node=2`` of the stage-1 CLI on the CPU (gloo):
    each rank reads one row of train_bs 2 from its shard; rank 0 alone
    writes the checkpoint (the ZeRO-1 state gathered to it), the log and the
    final state dicts.  A train_bs the ranks do not divide is refused."""
    import json
    from pathlib import Path

    import torch

    from test_torch_train_loop import _cli_config

    cfg = _cli_config(tmp_path, 1, val={"validation_steps": 0}, checkpointing_steps=1)
    import yaml

    data = yaml.safe_load(open(cfg))
    data["train_bs"] = 2
    open(cfg, "w").write(yaml.safe_dump(data))
    manifest = Path(data["data"]["json_path"])  # two videos: one a rank's shard
    videos = json.loads(manifest.read_text())
    manifest.write_text(json.dumps({f"{k}_{i}": v for i in range(2)
                                    for k, v in videos.items()}))
    res = _torchrun(["--config", cfg], tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    out = tmp_path / "out" / "stage1"
    assert sorted(p.name for p in out.glob("*.pth")) == [
        "denoising_unet-1.pth", "pose_guider-1.pth", "reference_unet-1.pth"]
    assert res.stdout.count("done, saved to") == 1
    state = torch.load(out / "checkpoints" / "checkpoint-1" / "state.pt", weights_only=True)
    assert state["optimizer"].keys() == state["trainable"].keys()  # every owner's state
    assert (out / "train_log.jsonl").read_text().count("loss") == 1

    # every rank restores the newest checkpoint (the state of the parameters
    # it owns) and goes on from step 1
    data["resume_from_checkpoint"] = "latest"
    open(cfg, "w").write(yaml.safe_dump(data))
    res = _torchrun(["--config", cfg], tmp_path, steps=2)
    assert res.returncode == 0, res.stderr[-3000:]
    assert sorted(p.name for p in (out / "checkpoints").iterdir()) == ["checkpoint-2"]
    assert (out / "denoising_unet-2.pth").exists()

    data["train_bs"] = 3
    open(cfg, "w").write(yaml.safe_dump(data))
    res = _torchrun(["--config", cfg], tmp_path)
    assert res.returncode != 0
    assert "train_bs 3 does not divide over 2 data-parallel ranks" in res.stderr + res.stdout
