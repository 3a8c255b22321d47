"""Stage-1 training step (port of ``aniportrait_tpu/train/train_step.py``).

The math of the JAX ``make_train_step`` (its lines 186-265), which follows
the reference ``train_stage_1.py``:

* target and reference images VAE-encoded to sampled latents x 0.18215;
* one CFG-dropout flag per step (the reference draws a single
  ``random.random()``): it zeroes the CLIP image and makes every row ignore
  the reference bank (``drop_mode='traced'``);
* noise offset per (batch row, channel), ``t ~ U[0, 1000)`` per row;
* epsilon or v-prediction target, Min-SNR-gamma weights (+1 for v);
* AdamW over the trainable set only, after clipping by the global norm.

Stage 1 trains the ReferenceNet (less ``up_blocks.3``), the denoising UNet
and the PoseGuider; VAE and CLIP are frozen and get no gradients.

``loss_fn`` takes its random draws as explicit tensors (:class:`Draws`), so a
test can hand it the JAX draws; without them it draws from a
``torch.Generator``.  Batches follow the JAX contract, channels last, images
in [-1, 1]:

* ``pixel_values``: (b, f, H, W, 3), ``pixel_values_pose``: (b, f, H, W, 3)
* ``pixel_values_ref_img``: (b, H, W, 3)
* ``clip_ref_image``: (b, S, S, 3), CLIP-normalised
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from aniportrait_tpu_torch.factory import PipelineModules
from aniportrait_tpu_torch.schedulers import compute_snr

VAE_SCALE = 0.18215
TRAINED = ("reference_unet", "denoising_unet", "pose_guider")


def freeze_mask_stage1(modules: PipelineModules) -> Dict[str, bool]:
    """``{'model.param': frozen}`` for every parameter of the five models:
    VAE, CLIP and ReferenceNet ``up_blocks.3`` frozen (the reference freezes
    ``reference_unet.up_blocks.3``, train_stage_1.py:304-317; the JAX
    package's ``up_3_*``/``attn_up_3_*``), everything else trained."""
    mask = {}
    for model, module in modules.models().items():
        for name, _ in module.named_parameters():
            frozen = model not in TRAINED or (
                model == "reference_unet" and name.startswith("up_blocks.3."))
            mask[f"{model}.{name}"] = frozen
    return mask


def apply_freeze(modules: PipelineModules) -> Dict[str, torch.nn.Parameter]:
    """Set ``requires_grad`` by :func:`freeze_mask_stage1`; return the
    trainable parameters by qualified name."""
    mask = freeze_mask_stage1(modules)
    trainable = {}
    for model, module in modules.models().items():
        for name, p in module.named_parameters():
            key = f"{model}.{name}"
            p.requires_grad_(not mask[key])
            if not mask[key]:
                trainable[key] = p
    return trainable


@dataclass
class Draws:
    """The random draws of one step, channels first:

    eps_target (b * f, 4, h, w) and eps_ref (b, 4, h, w): the VAE samples'
    normal noise; uncond: bool scalar, the step's CFG-dropout flag; noise
    (b, f, 4, h, w); offset (b, 1, 4, 1, 1), scaled by ``noise_offset``;
    t (b,) integer timesteps."""

    eps_target: torch.Tensor
    eps_ref: torch.Tensor
    uncond: torch.Tensor
    noise: torch.Tensor
    offset: torch.Tensor
    t: torch.Tensor

    @staticmethod
    def sample(b: int, f: int, h: int, w: int, uncond_ratio: float,
               num_train_timesteps: int, generator: torch.Generator) -> "Draws":
        dev = generator.device
        randn = lambda *s: torch.randn(*s, generator=generator, device=dev)
        return Draws(
            eps_target=randn(b * f, 4, h, w),
            eps_ref=randn(b, 4, h, w),
            uncond=torch.rand((), generator=generator, device=dev) < uncond_ratio,
            noise=randn(b, f, 4, h, w),
            offset=randn(b, 1, 4, 1, 1),
            t=torch.randint(0, num_train_timesteps, (b,), generator=generator,
                            device=dev),
        )


def _nchw(x):
    """(..., H, W, C) channels-last -> (..., C, H, W)."""
    return x.movedim(-1, -3)


@torch.no_grad()
def vae_sample(vae, img, eps):
    """Sampled latents x 0.18215 of ``img`` (N, 3, H, W), float32."""
    mean, logvar = vae.encode(img.to(next(vae.parameters()).dtype))
    return (mean.float() + torch.exp(0.5 * logvar.float()) * eps) * VAE_SCALE


def loss_fn(modules: PipelineModules, batch: Dict[str, torch.Tensor], *,
            prediction_type: str = "v_prediction", snr_gamma: float = 5.0,
            noise_offset: float = 0.05, uncond_ratio: float = 0.1,
            draws: Optional[Draws] = None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The stage-1 loss of one batch.  The PoseGuider runs in train mode
    (its BatchNorm statistics update in place); the caller picks the compute
    dtype (``torch.autocast``).  ``draws``: the step's random draws, else
    drawn from ``generator``."""
    m = modules
    px = batch["pixel_values"]
    b, f = px.shape[:2]
    clip_dtype = next(m.clip.parameters()).dtype
    if draws is None:
        hl, wl = px.shape[2] // 8, px.shape[3] // 8
        draws = Draws.sample(b, f, hl, wl, uncond_ratio,
                             m.scheduler.num_train_timesteps, generator)

    latents = vae_sample(m.vae, _nchw(px.reshape(b * f, *px.shape[2:])),
                         draws.eps_target)
    latents = latents.reshape(b, f, *latents.shape[1:])
    ref_latents = vae_sample(m.vae, _nchw(batch["pixel_values_ref_img"]),
                             draws.eps_ref)

    keep = (~draws.uncond).to(torch.float32)
    with torch.no_grad():
        clip_img = _nchw(batch["clip_ref_image"]) * keep
        ctx = m.clip(clip_img.to(clip_dtype)).float()[:, None, :]

    noise = draws.noise
    if noise_offset > 0:
        noise = noise + noise_offset * draws.offset
    t = draws.t
    noisy = m.scheduler.add_noise(latents, noise, t)
    if prediction_type == "epsilon":
        target = noise
    elif prediction_type == "v_prediction":
        target = m.scheduler.get_velocity(latents, noise, t)
    else:
        raise ValueError(prediction_type)

    pose_fea = m.pose_guider(_nchw(batch["pixel_values_pose"]))
    _, banks = m.reference_unet(ref_latents[:, None], torch.zeros_like(t), ctx,
                                capture_banks=True)
    pred, _ = m.denoising_unet(noisy, t, ctx, pose_cond_fea=pose_fea,
                               ref_banks=banks, drop_mode="traced",
                               drop_ref=draws.uncond.expand(b))

    err = (pred.float() - target.float()) ** 2
    if snr_gamma and snr_gamma > 0:
        snr = compute_snr(m.scheduler.alphas_cumprod, t)
        if prediction_type == "v_prediction":
            snr = snr + 1.0
        weights = torch.clamp(snr, max=snr_gamma) / snr
        return (err.reshape(b, -1).mean(1) * weights).mean()
    return err.mean()


def make_optimizer(trainable: Dict[str, torch.nn.Parameter],
                   learning_rate: float = 1e-5, weight_decay: float = 1e-2,
                   betas=(0.9, 0.999), eps: float = 1e-8) -> torch.optim.AdamW:
    """AdamW over the trainable set only, float32 states (the JAX package's
    fp32 path, ``optax.adamw``: decoupled decay on the old weight, the same
    bias-corrected update)."""
    return torch.optim.AdamW(list(trainable.values()), lr=learning_rate,
                             betas=betas, eps=eps, weight_decay=weight_decay)


@torch.no_grad()
def clip_by_global_norm(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients by ``max / max(|g|, max)`` (optax's
    ``clip_by_global_norm``; ``clip_grad_norm_`` adds 1e-6 to the norm).
    Returns the norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = max_norm / torch.clamp(norm, min=max_norm)
    torch._foreach_mul_(grads, scale)
    return norm


def train_step(modules: PipelineModules, optimizer: torch.optim.Optimizer,
               batch: Dict[str, torch.Tensor], *,
               compute_dtype: torch.dtype = torch.float32,
               max_grad_norm: float = 1.0, draws: Optional[Draws] = None,
               generator: Optional[torch.Generator] = None,
               **loss_kwargs) -> Dict[str, torch.Tensor]:
    """One optimisation step: loss, backward, clip, AdamW.  Float32 master
    weights; with ``compute_dtype=torch.bfloat16`` the forward and backward
    run under ``torch.autocast``.  Returns the loss and the gradient norm
    (tensors on the device, not synchronised)."""
    dev = batch["pixel_values"].device.type
    autocast = (torch.autocast(dev, dtype=compute_dtype)
                if compute_dtype != torch.float32 else nullcontext())
    modules.pose_guider.train()
    optimizer.zero_grad(set_to_none=True)
    with autocast:
        loss = loss_fn(modules, batch, draws=draws, generator=generator,
                       **loss_kwargs)
    loss.backward()
    params = [p for group in optimizer.param_groups for p in group["params"]]
    for p in params:
        # a weight the loss does not reach (the last transformer block of the
        # ReferenceNet past its bank capture) gets a zero gradient, so AdamW
        # still decays it, as optax does; torch would skip it
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    norm = clip_by_global_norm(params, max_grad_norm)
    optimizer.step()
    return {"loss": loss.detach(), "grad_norm": norm}
