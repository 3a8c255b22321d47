"""Training cells: stage-2 (motion-module) optimizer steps back to back
through the port's trainer, ``train.stage1.train`` with the stage-2
settings.

Set-up builds one object, the training step with its models and optimizer
state (``factory.build_training_models``, filled with the benchmark's
weights from ``--seed``; ``make_optimizer``), and a pool of seeded batches
on the device.  It drives that object through its first ``check_steps``
steps by the trainer's own call and feed, on pool batches that all differ,
and keeps what the comparison needs: each step's loss, the first gradient
by leaf (from AdamW's first moment after one step: m = (1 - b1) g), and
each leaf's change over the steps.  The window hands the same object to the
trainer again, its feed cycling the pool; the trainer pulls a batch when
the previous step has ended (each step ends in a synchronising
``float(loss)``), and the feed stops when the next step would not fit.
After it: with ``--trace 1`` a traced call of ``trace_steps`` steps; then
the program is freed and the plain reference (float32, TF32 off) follows
the first steps from the same weights, batches and random draws.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from harness import check, common, trace, weights
from reference import train as ref_train
from reference.ddim import DDIMScheduler
from reference.models import set_precision
from reference.precision import FP32, no_tf32

K3_BACKWARD_RANGE = "K3 plain backward"  # the port's profiler range of K3's backward


def settings_of(cfg: dict, seed: int):
    from aniportrait_tpu_torch.train.stage2 import Stage2Settings

    t = cfg["training"]
    return Stage2Settings(seed=common.sub_seed(seed, 5), train_bs=t["train_bs"],
                          sample_n_frames=t["frames"], sample_size=tuple(t["sample_size"]),
                          mixed_precision=t["mixed_precision"],
                          gradient_checkpointing=t["gradient_checkpointing"],
                          learning_rate=t["learning_rate"], max_grad_norm=t["max_grad_norm"],
                          noise_offset=t["noise_offset"], snr_gamma=t["snr_gamma"],
                          uncond_ratio=t["uncond_ratio"])


def build_program(cfg: dict, seed: int, device):
    from aniportrait_tpu_torch import factory
    from aniportrait_tpu_torch.train.train_step import apply_freeze, make_optimizer

    prog = cfg["program"]
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = bool(prog["tf32"])
        torch.backends.cudnn.allow_tf32 = bool(prog["tf32"])
    settings = settings_of(cfg, seed)
    modules = factory.build_training_models(
        prog["size"], device, seed=0, frozen_dtype=getattr(torch, prog["frozen_dtype"]),
        stage=2, gradient_checkpointing=settings.gradient_checkpointing,
        scheduler_kwargs=settings.scheduler_kwargs())
    for role, state in weights.iter_state_dicts(cfg["models"], seed, device):
        weights.load_into(getattr(modules, role), state)
    trainable = apply_freeze(modules, stage=2)
    opt = make_optimizer(trainable, settings.learning_rate, settings.adam_weight_decay,
                         (settings.adam_beta1, settings.adam_beta2), settings.adam_epsilon)
    return settings, modules, trainable, opt


def batch_pool(cfg: dict, traffic: dict, seed: int, device, clip_size: int) -> list:
    """``traffic['pool']`` batches in the trainer's contract (channels-last
    float32 in [-1, 1]; the CLIP image a standard normal, as normalised),
    made on the device from the seed."""
    t = cfg["training"]
    b, f, (h, w) = t["train_bs"], t["frames"], t["sample_size"]
    gen = torch.Generator(device=device).manual_seed(common.sub_seed(seed, 4))
    uni = lambda *s: torch.rand(s, generator=gen, device=device).mul_(2).sub_(1)
    return [{"pixel_values": uni(b, f, h, w, 3), "pixel_values_pose": uni(b, f, h, w, 3),
             "pixel_values_ref_img": uni(b, h, w, 3),
             "clip_ref_image": torch.randn(b, clip_size, clip_size, 3, generator=gen,
                                           device=device)}
            for _ in range(int(traffic["pool"]))]


def first_steps(settings, modules, trainable, opt, pool, steps: int, device) -> dict:
    """Drive the program's trainer through its first ``steps`` steps on
    pool batches 0 .. steps-1; returns its losses, first gradient by leaf
    and change by leaf."""
    from aniportrait_tpu_torch.train.stage2 import train

    b1 = settings.adam_beta1
    theta0 = {k: p.detach().clone() for k, p in trainable.items()}
    grads = {}

    def feed():
        for k in range(steps):
            if k == 1:  # no first moment: the optimizer took no gradient
                grads.update({n: float(torch.linalg.vector_norm(m)) / (1 - b1)
                              if (m := opt.state[p].get("exp_avg")) is not None else 0.0
                              for n, p in trainable.items()})
            yield pool[k]

    history = train(settings, modules, feed(), max_steps=steps, device=device, optimizer=opt)
    change = {n: float(torch.linalg.vector_norm(p.detach() - theta0[n]))
              for n, p in trainable.items()}
    del theta0
    common.free(device)
    return dict(losses=[h["loss"] for h in history], grads=grads, change=change,
                seconds=[h["seconds"] for h in history])


def reference_steps(cfg: dict, settings, seed: int, pool, names, steps: int, device,
                    prec=FP32) -> dict:
    """The plain reference through the same first steps: float32 weights
    from the seed, the same batches and the trainer's draws."""
    no_tf32()
    models = weights.reference_models(cfg["models"], seed, device)
    for m in models.values():
        set_precision(m, prec)
    unet = models["denoising_unet"]
    unet.checkpointing = True
    named = {f"denoising_unet.{n}": p for n, p in unet.named_parameters()}
    params = [named[n].requires_grad_(True) for n in names]
    models["pose_guider"].train()
    opt = ref_train.AdamW(params, settings.learning_rate, (settings.adam_beta1,
                                                           settings.adam_beta2),
                          settings.adam_epsilon, settings.adam_weight_decay)
    theta0 = [p.detach().clone() for p in params]
    sched = DDIMScheduler(**settings.scheduler_kwargs())
    gen = torch.Generator(device=device).manual_seed(settings.seed)
    t = cfg["training"]
    h, w = t["sample_size"][0] // 8, t["sample_size"][1] // 8
    losses, grads = [], None
    for k in range(steps):
        d = ref_train.draws(gen, t["train_bs"], t["frames"], h, w, settings.uncond_ratio,
                            sched.num_train_timesteps)
        loss, norms = ref_train.step(models, sched, opt, pool[k], d,
                                     max_grad_norm=settings.max_grad_norm,
                                     snr_gamma=settings.snr_gamma,
                                     noise_offset=settings.noise_offset)
        losses.append(loss)
        grads = norms if grads is None else grads
    change = [float(torch.linalg.vector_norm(p.detach() - p0)) for p, p0 in zip(params, theta0)]
    del models, params, opt, theta0, named, unet
    common.free(device)
    return dict(losses=losses, grad_norms=grads, change_norms=change)


def optimizer_state_bytes(opt) -> int:
    """Bytes of the tensors that the optimizer keeps between steps."""
    return sum(t.numel() * t.element_size() for state in opt.state.values()
               for t in state.values() if torch.is_tensor(t))


def dropout_flags(settings, cfg: dict, steps: int, device) -> list:
    """The trainer's CFG-dropout flag of its first ``steps`` steps."""
    t = cfg["training"]
    gen = torch.Generator(device=device).manual_seed(settings.seed)
    h, w = t["sample_size"][0] // 8, t["sample_size"][1] // 8
    n_t = DDIMScheduler(**settings.scheduler_kwargs()).num_train_timesteps
    return [ref_train.draws(gen, t["train_bs"], t["frames"], h, w, settings.uncond_ratio,
                            n_t).uncond for _ in range(steps)]


def run(ctx):
    from aniportrait_tpu_torch.train.stage2 import train

    cfg, traffic, args, dev = ctx.config, ctx.traffic, ctx.args, ctx.device
    seed = args.seed
    settings, modules, trainable, opt = build_program(cfg, seed, dev)
    pool = batch_pool(cfg, traffic, seed, dev, modules.clip.image_size)
    n_check = int(traffic["check_steps"])
    prog = first_steps(settings, modules, trainable, opt, pool, n_check, dev)
    estimate = float(np.median(prog["seconds"][1:]))
    common.sync(dev)
    setup_s = time.perf_counter() - ctx.t_start
    ctx.log(f"set-up {setup_s:.3f} s; first steps {prog['seconds']} s, losses "
            f"{prog['losses']}")

    common.reset_peak(dev)
    clock = {"t0": None, "done": []}

    def feed():
        i = n_check
        while True:
            now = time.perf_counter()
            if clock["t0"] is None:
                clock["t0"] = now
            else:
                clock["done"].append(now)
                if now + estimate > clock["t0"] + args.seconds:
                    return
            yield pool[i % len(pool)]
            i += 1

    with common.HostWatch() as host:
        history = train(settings, modules, feed(), max_steps=1 << 30, device=dev,
                        optimizer=opt)
    steps, done = len(clock["done"]), clock["done"]
    window_s = done[-1] - clock["t0"]
    peak = common.peak_bytes(dev)
    t = cfg["training"]
    frames = steps * t["train_bs"] * t["frames"]
    failed = sum(1 for h in history if not np.isfinite(h["loss"]))
    ctx.log(f"window {window_s:.4f} s: {steps} steps, seconds "
            f"{', '.join(f'{h['seconds']:.4f}' for h in history)}; peak {peak / 2**30:.3f} GiB; "
            f"{host.line()}")

    summary, launches, n_trace = None, None, int(traffic["trace_steps"])
    if args.trace and torch.device(dev).type == "cuda":
        from aniportrait_tpu_torch.ops import kernels

        kernels.reset_launch_counts()
        with trace.Traced(host=True) as tr:  # K3's backward is found by its host range
            train(settings, modules, (pool[i % len(pool)] for i in range(n_trace)),
                  max_steps=n_trace, device=dev, optimizer=opt)
        launches = kernels.launch_counts()
        t = time.perf_counter()
        summary = trace.reduce(tr.prof, tr.window_s, attention_ranges=(K3_BACKWARD_RANGE,))
        del tr
        ctx.log(f"trace read in {time.perf_counter() - t:.1f} s")
        ctx.log(f"traced {n_trace} steps: {summary.window_s:.4f} s (untraced "
                f"{window_s / steps * n_trace:.4f} s in the window), busy {summary.busy_s:.4f} "
                f"s, {summary.kernels} device operations; families {summary.families}; "
                f"launches {launches}")

    names = list(trainable)
    state_bytes = optimizer_state_bytes(opt)
    del modules, trainable, opt
    common.free(dev)
    t0 = time.perf_counter()
    ref = reference_steps(cfg, settings, seed, pool, names, n_check, dev)
    g = np.asarray(ref["grad_norms"])
    ctx.log(f"reference steps: {time.perf_counter() - t0:.1f} s, losses {ref['losses']}; "
            f"{len(g)} leaves, {int((g < check.ZERO_GRAD * np.median(g)).sum())} left out "
            f"of change_gap")
    numbers = check.train_numbers(
        dict(losses=prog["losses"], grad_norms=[prog["grads"][n] for n in names],
             change_norms=[prog["change"][n] for n in names]), ref)
    correct, checks = check.verdict(numbers, traffic["limits"])
    layer = SimpleNamespace(kind="train", cfg=cfg, traffic=traffic, steps=steps,
                            window_s=window_s, trace=summary, launches=launches,
                            trace_steps=n_trace, optimizer_state_bytes=state_bytes,
                            dropout=(dropout_flags(settings, cfg, n_trace, dev)
                                     if summary is not None else None))
    return common.outcome(
        end_to_end={"train_frames_per_s": frames / window_s, "peak_mem_gib": peak / 2**30,
                    "setup_s": setup_s},
        layer=layer, correct=correct and failed == 0, checks=checks, attempted=steps,
        failed=failed, memory_peak_bytes=peak, trace=summary)
