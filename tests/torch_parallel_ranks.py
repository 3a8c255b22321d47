"""What the ranks of tests/test_torch_parallel*.py run, each in its own
process started by ``aniportrait_tpu_torch.parallel.launch.spawn`` over gloo
on the CPU.  This module imports no JAX (nor do the ranks): the tests hand
the ranks numpy inputs and port weights and compare what they return.

Each function takes the rank's mesh first and returns numpy results."""

from __future__ import annotations

import numpy as np
import torch

from aniportrait_tpu_torch import factory

RES = 64  # pipeline cases: 64x64 px, 1 DDIM step, CFG 3.5, decode chunks of 2


def micro_models(state_path: str | None = None, seed: int = 0):
    """The micro inference models, with the weights saved at ``state_path``
    (``{model name: state dict}``) or drawn from ``seed``."""
    pm = factory.build_models("micro", "cpu", torch.float32, seed=seed)
    if state_path is not None:
        states = torch.load(state_path, weights_only=True)
        for name, model in pm.models().items():
            model.load_state_dict(states[name])
    return pm


def pipeline_cases(mesh, state_path: str | None, cases: list) -> dict:
    """``{name: video (frames, H, W, 3) float32}`` of each case (a dict with
    ``name``, ``kw`` (pipeline options), ``ref``, ``poses``, ``seed`` and
    optional ``latents`` (the initial noise), ``steps`` (default 1) and
    ``call`` (more arguments of the call)) through
    ``Pose2VideoPipeline(mesh=mesh)`` over the micro models (the weights at
    ``state_path``, else seed 0's)."""
    from aniportrait_tpu_torch.pipelines import Pose2VideoPipeline

    pm = micro_models(state_path)
    out = {}
    for c in cases:
        pipe = Pose2VideoPipeline(pm, mesh=mesh, **c["kw"])
        if c.get("latents") is not None:
            lat = torch.from_numpy(c["latents"].copy())
            pipe._initial_latents = lambda seed, shape: lat
        out[c["name"]] = pipe(c["ref"], c["poses"], None, RES, RES, len(c["poses"]),
                              num_inference_steps=c.get("steps", 1), guidance_scale=3.5,
                              seed=c["seed"], decode_chunk=2, **c.get("call", {}))
    return out


def motion_module(mesh, x: np.ndarray, windows, seed: int = 0) -> np.ndarray:
    """A float32 ``TemporalTransformer3D`` (64 channels, 4 heads; weights
    from ``seed``) on ``x`` (b, f, c, h, w): the whole clip on one rank
    (world 1), else this rank's frame block with the frame shard over the
    world; returns the rank's output frames."""
    from aniportrait_tpu_torch.models.motion_module import TemporalTransformer3D
    from aniportrait_tpu_torch.parallel.mesh import FrameShard, frame_sizes

    torch.manual_seed(seed)
    mm = TemporalTransformer3D(x.shape[2], heads=4, norm_groups=8).eval()
    with torch.no_grad():
        for p in mm.parameters():  # proj_out is not zero: the blocks count
            p.normal_(0, 0.1)
        b, f = x.shape[:2]
        shard = block = None
        if mesh.size > 1:
            shard = FrameShard(mesh.world, frame_sizes(f, mesh.size))
            block = shard.block
        xs = torch.from_numpy(x)[:, block] if block is not None else torch.from_numpy(x)
        fl = xs.shape[1]
        out = mm(xs.reshape(b * fl, *x.shape[2:]), fl, windows, shard)
        return out.reshape(b, fl, *x.shape[2:]).numpy()


def pose_guider_stats(mesh, pose: np.ndarray) -> dict:
    """The micro PoseGuider in train mode with its BatchNorm synchronised
    over the world, on this rank's rows of ``pose`` (b, f, 3, H, W): its
    output rows, the running statistics after the step and the gradient of
    the global mean output with respect to the weights (summed over
    ranks)."""
    from aniportrait_tpu_torch.models.pose_guider import sync_batch_norm
    from aniportrait_tpu_torch.parallel.mesh import all_reduce_mean_, shard_rows

    pg = micro_models(seed=3).pose_guider.float().train().requires_grad_(True)
    sync_batch_norm(pg, mesh.world)
    rows = shard_rows(pose.shape[0], mesh.size, mesh.rank)
    fea = pg(torch.from_numpy(pose[rows]))
    # the global batch's mean of the last feature: each rank's share of it
    (fea[-1].sum() / (fea[-1].numel() * mesh.size)).backward()
    grads = [p.grad for p in pg.parameters()]
    all_reduce_mean_(grads, mesh.world)
    return dict(out=fea[-1].detach().numpy(),
                stats={k: v.numpy() for k, v in pg.state_dict().items()
                       if k.endswith(("running_mean", "running_var"))},
                grads={n: (p.grad * mesh.size).numpy() for n, p in pg.named_parameters()})


def dp_step(mesh, batch: dict, adam_8bit: bool, seed: int) -> dict:
    """One float32 stage-1 step of the micro models through
    ``train.stage1.train`` on this rank's rows of the global ``batch``
    (ranks build their models from different seeds: the trainer replicates
    rank 0's).  Returns the loss, the gradient norm before the clip, the
    trainables as built (rank 0's are the step's start) and after the step,
    their gradients as the optimizer
    took them (averaged over the ranks, clipped), the PoseGuider's running
    statistics, this rank's optimizer state bytes and the largest
    parameter's."""
    from aniportrait_tpu_torch.parallel.mesh import shard_batch
    from aniportrait_tpu_torch.train import optim8bit
    from aniportrait_tpu_torch.train.stage1 import Stage1Settings, train
    from aniportrait_tpu_torch.train.train_step import apply_freeze, make_optimizer
    from aniportrait_tpu_torch.parallel.zero import adamw_state_nbytes

    settings = Stage1Settings(mixed_precision="no", use_8bit_adam=adam_8bit)
    m = factory.build_training_models("micro", "cpu", seed=seed + mesh.rank,
                                      frozen_dtype=torch.float32,
                                      scheduler_kwargs=settings.scheduler_kwargs())
    trainable = apply_freeze(m)
    opt = make_optimizer(trainable, settings.learning_rate, settings.adam_weight_decay,
                         adam_8bit=adam_8bit, mesh=mesh)
    local = shard_batch(batch, mesh) if mesh.size > 1 else batch
    before = {k: p.detach().numpy().copy() for k, p in trainable.items()}
    history = train(settings, m, [local], max_steps=1, device="cpu", optimizer=opt,
                    mesh=mesh)
    cost = optim8bit.state_nbytes if adam_8bit else adamw_state_nbytes
    return dict(loss=history[0]["loss"], grad_norm=history[0]["grad_norm"], before=before,
                params={k: p.detach().numpy().copy() for k, p in trainable.items()},
                grads={k: p.grad.numpy().copy() for k, p in trainable.items()},
                stats={k: v.numpy() for k, v in m.pose_guider.state_dict().items()
                       if k.endswith(("running_mean", "running_var"))},
                state_bytes=optim8bit.state_bytes(opt),
                largest=max(cost(p) for p in trainable.values()))


# ---------------------------------------------- tests/test_torch_parallel.py
# a window table over 10 frames (window fusion's motion windows): 6-frame
# windows overlapping by 2
WINDOWS = np.array([[0, 1, 2, 3, 4, 5], [4, 5, 6, 7, 8, 9]])


def mm_input():
    return np.random.RandomState(0).randn(1, 10, 64, 5, 6).astype(np.float32)


def dp_batch():
    rs = np.random.RandomState(0)
    img = factory.MICRO["clip"]["image_size"]
    b, h = 4, 32
    return {
        "pixel_values": rs.uniform(-1, 1, (b, 1, h, h, 3)).astype(np.float32),
        "pixel_values_pose": rs.uniform(-1, 1, (b, 1, h, h, 3)).astype(np.float32),
        "pixel_values_ref_img": rs.uniform(-1, 1, (b, h, h, 3)).astype(np.float32),
        "clip_ref_image": rs.randn(b, img, img, 3).astype(np.float32),
    }


def pose_input():
    return np.random.RandomState(1).uniform(-1, 1, (4, 1, 3, 32, 32)).astype(np.float32)


def option_cases() -> list:
    """The sampler's options under a mesh (the port's own noise): context
    rotation and the encoder cache on the exact windowed path, the encoder
    cache and latent interpolation on window fusion."""
    rs = np.random.RandomState(4)
    ref = rs.randint(0, 255, (70, 70, 3), np.uint8)
    poses = [rs.randint(0, 255, (70, 70, 3), np.uint8) for _ in range(8)]
    ctx = dict(context_frames=4, context_overlap=2)
    return [
        dict(name="rotate", kw=dict(ctx, window_batch=2, context_rotate=True),
             ref=ref, poses=poses[:6], seed=1, steps=3),
        dict(name="cache", kw=dict(ctx, window_batch=2, encoder_cache_interval=2),
             ref=ref, poses=poses[:6], seed=2, steps=3),
        dict(name="fused_cache_interp",
             kw=dict(ctx, window_fusion=True, encoder_cache_interval=2),
             ref=ref, poses=poses, seed=3, steps=3, call=dict(interpolation_factor=2)),
    ]


def world2(mesh):
    """Every case of tests/test_torch_parallel.py at 2 ranks (or, on a
    one-rank mesh, the single process's)."""
    x = mm_input()
    return dict(
        mm=motion_module(mesh, x, None),
        mm_win=motion_module(mesh, x, WINDOWS),
        options=pipeline_cases(mesh, None, option_cases()),
        bn=pose_guider_stats(mesh, pose_input()),
        dp={eight: dp_step(mesh, dp_batch(), eight, seed=0) for eight in (False, True)},
    )


def world4(mesh):
    x = mm_input()
    return dict(mm=motion_module(mesh, x, None), mm_win=motion_module(mesh, x, WINDOWS),
                options=pipeline_cases(mesh, None, option_cases()))
