"""The stage-2 trainer's loop features in the port, on the CPU, float32, at
micro size (tests/test_torch_train2.py holds the step and the optimizers to
the JAX package).

(a) Gradient checkpointing on equals off, and recomputes every temporal
    attention once.
(b) Trainable-only checkpoints round-trip, sync and async; a frozen weight
    of another shape is refused; ``'latest'`` resumes; a learning-rate
    schedule other than the YAMLs' is refused.
(c) The training CLIs at micro size on the CPU: stage 1 writes the
    reference's state dicts, stage 2 trains from them and ``mm_path`` and
    writes a motion-module file that ``load_pipeline`` reads back; without a
    card and without ``--device cpu`` they refuse.
(d) ``chip_smoke.stage2_reckoning`` counts the kernel routes of a step.
"""

import copy
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from aniportrait_tpu_torch import factory
from aniportrait_tpu_torch.train import checkpoint as ckpt
from aniportrait_tpu_torch.train import train_step as port_train
from aniportrait_tpu_torch.train.stage2 import Stage2Settings
from test_torch_train2 import (
    LR,
    TemporalSpy,
    _batch,
    _loss_and_grads,
    _micro,
    _seeded_draws,
    _torch_batch,
)
from test_torch_modules import one_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------- (a) checkpointing
def test_gradient_checkpointing_matches_no_checkpointing(monkeypatch):
    """Checkpointing only changes when activations are computed: the loss
    and every gradient agree to float32 rounding, and the backward runs
    each temporal attention's forward a second time."""
    m = _micro(seed=3)
    batch, draws = _torch_batch(_batch(seed=3)), _seeded_draws(3)
    spy = TemporalSpy(monkeypatch)
    results = {}
    for on in (False, True):
        mm = copy.deepcopy(m)
        mm.denoising_unet.gradient_checkpointing = on
        spy.calls = 0
        results[on] = _loss_and_grads(mm, draws, batch) + (spy.calls,)
    (loss_a, ga, calls_a), (loss_b, gb, calls_b) = results[False], results[True]
    assert calls_a == 14 and calls_b == 28
    np.testing.assert_allclose(loss_b, loss_a, rtol=1e-6)
    scale = max(float(g.abs().max()) for g in ga.values())
    for key in ga:
        np.testing.assert_allclose(gb[key].numpy(), ga[key].numpy(), rtol=0,
                                   atol=1e-6 * scale, err_msg=key)


# ------------------------------------------------------- (b) checkpoints
@pytest.mark.parametrize("block", [True, False], ids=["sync", "async"])
def test_checkpoint_round_trip(block, tmp_path):
    m = _micro(seed=7)
    trainable = port_train.apply_freeze(m, stage=2)
    opt = port_train.make_optimizer(trainable)
    batch = _torch_batch(_batch(f=2, h=32, seed=7))
    port_train.train_step(m, opt, batch, draws=_seeded_draws(7, f=2, h=32))
    saved = ckpt.snapshot(m, opt, trainable, 1, 2)
    save = ckpt.save_train_checkpoint(str(tmp_path), m, opt, trainable, 1, stage=2,
                                      block=block)
    assert (save is None) == block
    ckpt.finish_async_save(save)
    assert ckpt.latest_step(str(tmp_path)) == 1
    port_train.train_step(m, opt, batch, draws=_seeded_draws(8, f=2, h=32))
    assert not all(torch.equal(p, saved["trainable"][k]) for k, p in trainable.items())

    assert ckpt.restore_train_checkpoint(str(tmp_path), m, opt, trainable, stage=2) == 1
    again = ckpt.snapshot(m, opt, trainable, 1, 2)
    for part in ("trainable", "batch_stats"):
        assert saved[part].keys() == again[part].keys()
        for k in saved[part]:
            assert torch.equal(saved[part][k], again[part][k]), (part, k)
    assert saved["optimizer"].keys() == again["optimizer"].keys() == trainable.keys()
    for k, st in saved["optimizer"].items():
        for name, v in st.items():
            assert torch.equal(v, again["optimizer"][k][name]), (k, name)
    assert saved["frozen"] == again["frozen"] and saved["frozen"]

    other = _micro(seed=7)
    name, w = next(iter(other.vae.named_parameters()))
    owner, attr = name.rsplit(".", 1)
    setattr(other.vae.get_submodule(owner), attr,
            torch.nn.Parameter(torch.zeros(w.shape[0] + 1, *w.shape[1:])))
    other_trainable = port_train.apply_freeze(other, stage=2)
    with pytest.raises(ValueError, match="frozen weights differ"):
        ckpt.restore_train_checkpoint(str(tmp_path), other, port_train.make_optimizer(
            other_trainable), other_trainable, stage=2)
    with pytest.raises(ValueError, match="stage-2 checkpoint"):
        ckpt.restore_train_checkpoint(str(tmp_path), m, opt, trainable, stage=1)


def test_resume_from_latest(tmp_path):
    """The trainer saves every step (keeping the newest), and a second
    trainer with ``resume_from_checkpoint: 'latest'`` starts from it."""
    from aniportrait_tpu_torch.train.stage2 import train

    settings = Stage2Settings(checkpointing_steps=1, gradient_checkpointing=False,
                              mixed_precision="no", validation_steps=0)
    batches = [_batch(f=2, h=32, seed=s) for s in range(3)]
    m = _micro(seed=9)
    history = train(settings, m, batches[:2], max_steps=2, device="cpu",
                    save_dir=str(tmp_path))
    assert [h["step"] for h in history] == [0, 1]
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["checkpoint-2"]
    trained = {k: p.detach().clone() for k, p in m.denoising_unet.named_parameters()
               if ".motion_modules." in k}

    fresh = _micro(seed=9)
    settings.resume_from_checkpoint = "latest"
    history = train(settings, fresh, batches[2:], max_steps=3, device="cpu",
                    save_dir=str(tmp_path))
    assert [h["step"] for h in history] == [2]
    assert ckpt.latest_step(str(tmp_path / "checkpoints")) == 3
    moved = {k: p for k, p in fresh.denoising_unet.named_parameters() if k in trained}
    assert all(not torch.equal(p.detach(), trained[k]) for k, p in moved.items())
    settings.lr_scheduler = "cosine"
    with pytest.raises(NotImplementedError, match="cosine"):
        train(settings, fresh, batches, device="cpu")


# ---------------------------------------------------------------- (c) CLI
def _manifest(root, n=8, size=64):
    cv2 = pytest.importorskip("cv2")
    rs = np.random.RandomState(0)
    frames, lmks = [], []
    os.makedirs(root / "vid", exist_ok=True)
    for i in range(n):
        fp, lp = root / "vid" / f"{i:04d}.png", root / "vid" / f"{i:04d}_lmks.npy"
        cv2.imwrite(str(fp), rs.randint(0, 255, (size, size, 3), np.uint8))
        np.save(lp, (rs.rand(478, 3) * 0.6 + 0.2).astype(np.float32))
        frames.append(str(fp))
        lmks.append(str(lp))
    import json

    path = root / "train.json"
    path.write_text(json.dumps({"vid": {"video_clip_num": 1, "clip_data_list": [
        {"frame_path_list": frames, "lmks_list": lmks}]}}))
    return path


def _cli_config(tmp_path, stage, **top):
    import yaml

    cfg = yaml.safe_load((ROOT / f"configs/train/stage{stage}.yaml").read_text())
    cfg["data"].update(json_path=str(_manifest(tmp_path)), sample_size=[64, 64],
                       sample_n_frames=4)
    cfg["solver"].update(mixed_precision="no")
    cfg.update(output_dir=str(tmp_path / "out"), train_bs=1, **top)
    path = tmp_path / f"stage{stage}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_training_clis_chain_into_the_loader(tmp_path, capsys):
    """Stage 1 (random weights, one step) writes the reference's state
    dicts; stage 2 loads them, the VAE, CLIP and an AnimateDiff-style
    ``mm_path`` through the loader's rules, trains two steps (a checkpoint
    each, validation grids at the second) and writes the motion modules,
    which ``load_pipeline`` reads back as ``motion_module_path`` beside the
    stage-1 files."""
    import chip_smoke
    from aniportrait_tpu_torch.config import Config
    from aniportrait_tpu_torch.scripts import loader, train_stage_1, train_stage_2

    files = factory.build_models("micro", "cpu", seed=1,
                                 unet_overrides=factory.INFERENCE_V2_UNET)
    paths = chip_smoke.write_checkpoints(files, str(tmp_path / "weights"))
    micro = ["--size", "micro", "--device", "cpu"]
    train_stage_1.main(["--config", _cli_config(tmp_path, 1, val={"validation_steps": 0}),
                        "--random-init", "--max-steps", "1", *micro])
    s1 = tmp_path / "out" / "stage1"
    assert sorted(p.name for p in s1.glob("*.pth")) == [
        "denoising_unet-1.pth", "pose_guider-1.pth", "reference_unet-1.pth"]

    argv = ["--config", _cli_config(
        tmp_path, 2, val={"validation_steps": 2}, checkpointing_steps=1,
        inference_config=str(ROOT / "configs/inference/inference_v2.yaml"),
        vae_model_path=paths["pretrained_vae_path"],
        image_encoder_path=paths["image_encoder_path"], mm_path=paths["motion_module_path"],
        stage1_ckpt_dir=str(s1), stage1_ckpt_step=1), "--max-steps", "2", "--size", "micro"]
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            train_stage_2.main(argv)
    train_stage_2.main(argv + ["--device", "cpu"])
    out = tmp_path / "out" / "stage2"
    mm_path = out / "motion_module-2.pth"
    assert mm_path.exists() and "saved to" in capsys.readouterr().out
    assert sorted(os.listdir(out / "checkpoints")) == ["checkpoint-2"]
    assert len(os.listdir(out / "validation")) == 2
    assert (out / "train_log.jsonl").read_text().count("loss") == 1

    # two AdamW steps from the mm_path weights: each weight moves by at most
    # lr (1 + weight_decay |w|) a step
    motion = torch.load(mm_path, weights_only=True)
    start = torch.load(paths["motion_module_path"], weights_only=True)
    assert motion.keys() == start.keys() and all(".motion_modules." in k for k in motion)
    moved = 0
    for k, v in motion.items():
        assert (v - start[k]).abs().max() <= 2 * LR * (1 + 1e-2 * start[k].abs().max()) + 1e-7
        moved += int(not torch.equal(v, start[k]))
    assert moved > len(motion) // 2
    config = Config({**chip_smoke.ENTRY_CONFIG, **paths, "motion_module_path": str(mm_path),
                     **{f"{name}_path": str(s1 / f"{name}-1.pth")
                        for name in ("reference_unet", "denoising_unet", "pose_guider")}})
    pipe = loader.load_pipeline(config, dtype=torch.float32, size="micro", device="cpu")
    own = pipe.m.denoising_unet.state_dict()
    for k, v in motion.items():
        assert torch.equal(own[k], v), k
    stage1_ref = torch.load(s1 / "reference_unet-1.pth", weights_only=True)
    for k, v in pipe.m.reference_unet.state_dict().items():
        assert torch.equal(v, stage1_ref[k]), k


# -------------------------------------------------------------- (d) reckoning
def test_stage2_reckoning_counts_the_kernel_routes(monkeypatch):
    """``chip_smoke.stage2_reckoning``, which the card's stage-2 phase holds
    its launch counters to, counts the kernel wrappers one micro stage-2
    step calls with checkpointing on (256 px, 2 frames: every route of the
    full-size step is taken, and the micro VAE's small head takes K4)."""
    import chip_smoke
    from aniportrait_tpu_torch.ops.kernels import flash, temporal

    calls = {}
    for mod, name, kid in ((flash, "tok_flash", "K2"), (temporal, "nat_temporal", "K3"),
                           (flash, "flash_attention", "K4"),
                           (flash, "flash_attention_fwd_lse", "K5a"),
                           (flash, "flash_attention_bwd", "K5b")):
        def counted(*args, _fn=getattr(mod, name), _kid=kid, **kwargs):
            calls[_kid] = calls.get(_kid, 0) + 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(mod, name, counted)
    frames, res = 2, 256
    m = _micro(seed=11, gradient_checkpointing=True)
    trainable = port_train.apply_freeze(m, stage=2)
    port_train.train_step(m, port_train.make_optimizer(trainable),
                          _torch_batch(_batch(f=frames, h=res, seed=11)),
                          draws=_seeded_draws(11, f=frames, h=res))
    want = chip_smoke.stage2_reckoning(m, res, res, frames, checkpointing=True)
    assert all(want.values()), want
    assert calls == want
