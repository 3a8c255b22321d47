"""The work of a request or a training step, counted by the benchmark from
the configuration's shapes (never from the program's routes), and the
card's peaks.

* Model FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the plain
  reference run on ``meta`` tensors at the cell's shapes (matrix products,
  convolutions and attention's two products; a training step counts its
  forward and backward once, without the recompute of checkpointing).
* Attention: every attention call the reference makes, from which
  :func:`attention_least_seconds` gives the least time the card could take
  (the larger of matrix FLOPs at the bf16 peak and bytes at the HBM peak;
  each input read once, each output written once).  Calls over a single
  key (the cross attention on CLIP's one token, whose softmax is 1) are
  no attention work and are left out.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense: 989 TFLOP/s bf16,
3.35 TB/s HBM3 (at the full 700 W; the run prints the card's limit).
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from reference import attention as ref_attention
from reference.context import uniform_context_windows
from reference.models import make_models

PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES = 3.35e12
BWD_FLOPS = 2.5  # the flash backward's matrix FLOPs over the forward's


def attention_least_seconds(calls, nbytes: int = 2) -> float:
    """Sum over calls of max(FLOPs / peak, bytes / peak): forward, plus the
    backward where the call needs one (dq, dk, dv from q, k, v, o, do)."""
    total = 0.0
    for c in calls:
        if c["skv"] == 1:
            continue
        rhd = c["rows"] * c["heads"] * c["d"]
        flops = 4.0 * rhd * c["sq"] * c["skv"]
        moved = (2 * c["sq"] + 2 * c["skv"]) * rhd * nbytes
        total += max(flops / PEAK_FLOPS_BF16, moved / PEAK_BYTES)
        if c["backward"]:
            moved = (4 * c["sq"] + 4 * c["skv"]) * rhd * nbytes
            total += max(BWD_FLOPS * flops / PEAK_FLOPS_BF16, moved / PEAK_BYTES)
    return total


def _counted(fn):
    calls = []
    with ref_attention.recording(calls), FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops()), calls


def request_work(sizes: dict, sampler: dict, frames: int, height: int, width: int) -> dict:
    """FLOPs and attention calls of one pose2vid request (CFG: every UNet
    call on an unconditional and a conditional row), by the reference's own
    model calls: CLIP, the VAE encode, the ReferenceNet, the PoseGuider, the
    denoising UNet on each context window at each step, the VAE decode."""
    with torch.device("meta"):
        m = make_models(sizes)
    h, w = height // 8, width // 8
    s = m["clip"].image_size
    meta = lambda *shape: torch.zeros(shape, device="meta")
    t2 = torch.zeros(2, dtype=torch.long, device="meta")
    cf = int(sampler["context_frames"])
    n_win = (len(uniform_context_windows(0, frames, cf, int(sampler["context_stride"]),
                                         int(sampler["context_overlap"])))
             if frames > cf else 1)
    win = min(frames, cf)
    calls_per_request = int(sampler["steps"]) * n_win
    parts = {}
    with torch.no_grad():
        ctx = meta(2, 1, sizes["unet"]["cross_attention_dim"])
        parts["clip"] = _counted(lambda: m["clip"](meta(1, 3, s, s)))
        parts["vae_encode"] = _counted(lambda: m["vae"].encode(meta(1, 3, height, width)))
        banks = {}

        def refnet():
            banks.update(m["reference_unet"](meta(2, 1, 4, h, w), t2, ctx)[1])
        parts["reference_unet"] = _counted(refnet)
        fea = []
        parts["pose_guider"] = _counted(
            lambda: fea.extend(m["pose_guider"](meta(1, frames, 3, height, width))))
        pw = [meta(2, win, *f.shape[2:]) for f in fea]
        parts["denoising_unet"] = _counted(lambda: m["denoising_unet"](
            meta(2, win, 4, h, w), t2, ctx, pw, banks, bank_rows=[False, True]))
        parts["vae_decode"] = _counted(lambda: m["vae"].decode(meta(frames, 4, h, w)))
    flops, calls = 0.0, []
    for name, (f, c) in parts.items():
        times = calls_per_request if name == "denoising_unet" else 1
        flops += f * times
        calls += c * times
    return dict(flops=flops, attention_calls=calls)


def train_step_work(sizes: dict, frames: int, height: int, width: int, batch: int,
                    uncond: bool) -> dict:
    """FLOPs and attention calls of one stage-2 training step: the frozen
    encoders' forwards, then the denoising UNet's forward and the backward
    into its motion modules (the step's CFG dropout decides whether the
    self attention reads the bank)."""
    from reference import train as ref_train
    from reference.ddim import DDIMScheduler

    with torch.device("meta"):
        m = make_models(sizes)
    for name, p in m["denoising_unet"].named_parameters():
        p.requires_grad_(".motion_modules." in name)
    m["pose_guider"].train()
    h, w = height // 8, width // 8
    s = m["clip"].image_size
    meta = lambda *shape: torch.zeros(shape, device="meta")
    batch_in = dict(pixel_values=meta(batch, frames, height, width, 3),
                    pixel_values_pose=meta(batch, frames, height, width, 3),
                    pixel_values_ref_img=meta(batch, height, width, 3),
                    clip_ref_image=meta(batch, s, s, 3))
    d = ref_train.Draws(eps_target=meta(batch * frames, 4, h, w), eps_ref=meta(batch, 4, h, w),
                        uncond=uncond, noise=meta(batch, frames, 4, h, w),
                        offset=meta(batch, 1, 4, 1, 1),
                        t=torch.zeros(batch, dtype=torch.long, device="meta"))
    flops, calls = _counted(
        lambda: ref_train.loss(m, DDIMScheduler(), batch_in, d).backward())
    return dict(flops=flops, attention_calls=calls)
