"""Stage-2 training steps in plain PyTorch (the reference's counterpart of
the port's ``train.train_step``; AniPortrait's ``train_stage_2.py``):

* target frames and reference image VAE-encoded to sampled latents x 0.18215;
* one CFG-dropout flag a step: it zeroes the CLIP image, and no row reads
  the ReferenceNet's banks;
* noise offset per (row, channel), v-prediction target on the zero-SNR
  schedule, Min-SNR-gamma weights (+1 for v);
* the backward through the frozen UNet into the motion modules, the
  gradient clipped by its global norm, AdamW.

The step's random draws are made by :func:`draws` from a
``torch.Generator`` on the training device, in the order and shapes the
trainer draws them (``eps_target``, ``eps_ref``, the dropout flag, the
noise, its offset, the timesteps).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .ddim import DDIMScheduler, compute_snr

VAE_SCALE = 0.18215


@dataclass
class Draws:
    eps_target: torch.Tensor
    eps_ref: torch.Tensor
    uncond: bool
    noise: torch.Tensor
    offset: torch.Tensor
    t: torch.Tensor


def draws(generator: torch.Generator, b: int, f: int, h: int, w: int, uncond_ratio: float,
          num_train_timesteps: int) -> Draws:
    dev = generator.device
    randn = lambda *s: torch.randn(*s, generator=generator, device=dev)
    eps_target, eps_ref = randn(b * f, 4, h, w), randn(b, 4, h, w)
    uncond = torch.rand((), generator=generator, device=dev) < uncond_ratio
    noise, offset = randn(b, f, 4, h, w), randn(b, 1, 4, 1, 1)
    t = torch.randint(0, num_train_timesteps, (b,), generator=generator, device=dev)
    return Draws(eps_target, eps_ref, bool(uncond), noise, offset, t)


def _nchw(x):
    return x.movedim(-1, -3).contiguous()


def loss(models: dict, scheduler: DDIMScheduler, batch: dict, d: Draws, *,
         snr_gamma: float = 5.0, noise_offset: float = 0.05) -> torch.Tensor:
    """The v-prediction loss of one batch (channels-last float32 images in
    [-1, 1], as the trainer takes them); the PoseGuider in train mode."""
    vae = models["vae"]
    px = batch["pixel_values"]
    b, f = px.shape[:2]
    with torch.no_grad():
        mean, logvar = vae.encode(_nchw(px.reshape(b * f, *px.shape[2:])))
        latents = (mean + torch.exp(0.5 * logvar) * d.eps_target) * VAE_SCALE
        latents = latents.reshape(b, f, *latents.shape[1:])
        mean, logvar = vae.encode(_nchw(batch["pixel_values_ref_img"]))
        ref_latents = (mean + torch.exp(0.5 * logvar) * d.eps_ref) * VAE_SCALE
        keep = 0.0 if d.uncond else 1.0
        ctx = models["clip"](_nchw(batch["clip_ref_image"]) * keep)[:, None, :]
        pose_fea = models["pose_guider"](_nchw(batch["pixel_values_pose"]))
        _, banks = models["reference_unet"](ref_latents[:, None], torch.zeros_like(d.t), ctx)
    noise = d.noise + noise_offset * d.offset if noise_offset > 0 else d.noise
    noisy = scheduler.add_noise(latents, noise, d.t)
    target = scheduler.get_velocity(latents, noise, d.t)
    pred, _ = models["denoising_unet"](noisy, d.t, ctx, pose_fea, banks,
                                       bank_rows=[not d.uncond] * b)
    err = (pred - target) ** 2
    snr = compute_snr(scheduler.alphas_cumprod, d.t) + 1.0
    weights = torch.clamp(snr, max=snr_gamma) / snr
    return (err.reshape(b, -1).mean(1) * weights).mean()


@torch.no_grad()
def clip_by_global_norm(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients by ``max / max(|g|, max)``; returns the norm."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(p.grad)
                                                 for p in params]))
    scale = max_norm / torch.clamp(norm, min=max_norm)
    for p in params:
        p.grad.mul_(scale)
    return norm


class AdamW:
    """AdamW with decoupled weight decay on the old weight (PyTorch's and
    optax's update), float32 moments."""

    def __init__(self, params, lr=1e-5, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2):
        self.params = list(params)
        self.lr, self.betas, self.eps, self.wd = lr, betas, eps, weight_decay
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            m.mul_(b1).add_(p.grad, alpha=1 - b1)
            v.mul_(b2).addcmul_(p.grad, p.grad, value=1 - b2)
            p.mul_(1 - self.lr * self.wd)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))


def step(models: dict, scheduler: DDIMScheduler, opt: AdamW, batch: dict, d: Draws, *,
         max_grad_norm: float = 1.0, **loss_kwargs):
    """One optimizer step over ``opt.params``.  Returns (the loss, each
    parameter's gradient norm as the optimizer takes it, after the clip)."""
    for p in opt.params:
        p.grad = None
    value = loss(models, scheduler, batch, d, **loss_kwargs)
    value.backward()
    for p in opt.params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    clip_by_global_norm(opt.params, max_grad_norm)
    norms = torch.stack([torch.linalg.vector_norm(p.grad) for p in opt.params]).cpu()
    opt.step()
    return float(value.detach()), norms.tolist()
