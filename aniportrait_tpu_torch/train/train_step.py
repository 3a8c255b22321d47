"""Training step of stage 1 and stage 2 (port of
``aniportrait_tpu/train/train_step.py``).

The math of the JAX ``make_train_step`` (its lines 186-265), which follows
the reference ``train_stage_1.py``:

* target and reference images VAE-encoded to sampled latents x 0.18215;
* one CFG-dropout flag per step (the reference draws a single
  ``random.random()``): it zeroes the CLIP image and makes every row ignore
  the reference bank (``drop_mode='traced'``);
* noise offset per (batch row, channel), ``t ~ U[0, 1000)`` per row;
* epsilon or v-prediction target, Min-SNR-gamma weights (+1 for v);
* AdamW over the trainable set only, after clipping by the global norm.

Data-parallel (``mesh``, a ``parallel.Mesh`` of more than one rank): each
rank holds ``b / ranks`` rows of the global batch.  Every rank draws the
global batch's random draws from the same seeded generator and keeps its
own rows, as the single-process step and the JAX package's jitted global
step draw them; the gradients are averaged by ``all_reduce`` before the
clip, so the clip sees the global gradient; the PoseGuider's BatchNorm
takes the global batch's statistics (``models/pose_guider.py:
sync_batch_norm``); and the optimizer state is sharded by whole parameters
(``parallel/zero.py``, ZeRO-1).

Stage 1 trains the ReferenceNet (less ``up_blocks.3``), the denoising UNet
and the PoseGuider; VAE and CLIP are frozen and get no gradients.  Stage 2
trains the denoising UNet's motion modules only (``freeze_mask_stage2``).
A model none of whose weights train (stage 2's ReferenceNet and PoseGuider)
runs without recording gradients; the PoseGuider still runs in train mode,
so its BatchNorm statistics update at both stages, as in the JAX step.

With ``accumulation_steps`` k > 1 each call is one micro-step: its loss's
gradient, divided by k, adds into the trainables' ``.grad``, and only the
k-th micro-step clips and steps the optimizer, which applies the mean
gradient of the k batches, as ``optax.MultiSteps`` does.

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
from aniportrait_tpu_torch.parallel.mesh import all_reduce_mean_
from aniportrait_tpu_torch.schedulers import compute_snr
from aniportrait_tpu_torch.utils.profiling import span

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


def freeze_mask_stage2(modules: PipelineModules) -> Dict[str, bool]:
    """``{'model.param': frozen}``: only the denoising UNet's motion modules
    train (the JAX ``_freeze_mask_stage2``, train_step.py:62-75; the
    reference's train_stage_2.py:345-356)."""
    return {f"{model}.{name}": not (model == "denoising_unet"
                                    and ".motion_modules." in name)
            for model, module in modules.models().items()
            for name, _ in module.named_parameters()}


def freeze_mask(modules: PipelineModules, stage: int) -> Dict[str, bool]:
    if stage not in (1, 2):
        raise ValueError(f"stage={stage}")
    return (freeze_mask_stage1 if stage == 1 else freeze_mask_stage2)(modules)


def apply_freeze(modules: PipelineModules, stage: int = 1
                 ) -> Dict[str, torch.nn.Parameter]:
    """Set ``requires_grad`` by the stage's freeze mask; return the
    trainable parameters by qualified name."""
    mask = freeze_mask(modules, stage)
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

    def rows(self, lo: int, hi: int) -> "Draws":
        """The draws of batch rows ``[lo, hi)`` (the step's dropout flag is
        shared)."""
        f = self.noise.shape[1]
        return Draws(eps_target=self.eps_target[lo * f:hi * f], eps_ref=self.eps_ref[lo:hi],
                     uncond=self.uncond, noise=self.noise[lo:hi],
                     offset=self.offset[lo:hi], t=self.t[lo:hi])

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
    """(..., H, W, C) channels-last -> contiguous (..., C, H, W).  A
    channels-last-strided view would carry the convolutions' channels-last
    layout into every activation, and PyTorch 2.13's CPU backward of the
    denoising UNet with motion modules crashes on that layout."""
    return x.movedim(-1, -3).contiguous()


@torch.no_grad()
def vae_sample(vae, img, eps):
    """Sampled latents x 0.18215 of ``img`` (N, 3, H, W), float32."""
    mean, logvar = vae.encode(img.to(next(vae.parameters()).dtype))
    return (mean.float() + torch.exp(0.5 * logvar.float()) * eps) * VAE_SCALE


def _trains(model: torch.nn.Module) -> bool:
    return torch.is_grad_enabled() and any(p.requires_grad for p in model.parameters())


def loss_fn(modules: PipelineModules, batch: Dict[str, torch.Tensor], *,
            prediction_type: str = "v_prediction", snr_gamma: float = 5.0,
            noise_offset: float = 0.05, uncond_ratio: float = 0.1,
            draws: Optional[Draws] = None,
            generator: Optional[torch.Generator] = None, mesh=None) -> torch.Tensor:
    """The loss of one batch (either stage).  The PoseGuider runs in train mode
    (its BatchNorm statistics update in place); the caller picks the compute
    dtype (``torch.autocast``).  ``draws``: the step's random draws, else
    drawn from ``generator`` (under ``mesh``, the global batch's, of which
    this rank keeps its rows)."""
    m = modules
    px = batch["pixel_values"]
    b, f = px.shape[:2]
    clip_dtype = next(m.clip.parameters()).dtype
    if draws is None:
        hl, wl = px.shape[2] // 8, px.shape[3] // 8
        ranks = 1 if mesh is None else mesh.size
        draws = Draws.sample(b * ranks, f, hl, wl, uncond_ratio,
                             m.scheduler.num_train_timesteps, generator)
        if ranks > 1:
            draws = draws.rows(mesh.rank * b, (mesh.rank + 1) * b)

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

    with torch.set_grad_enabled(_trains(m.pose_guider)):
        pose_fea = m.pose_guider(_nchw(batch["pixel_values_pose"]))
    with torch.set_grad_enabled(_trains(m.reference_unet)):
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
                   betas=(0.9, 0.999), eps: float = 1e-8,
                   adam_8bit: bool = False, mesh=None) -> torch.optim.Optimizer:
    """AdamW over the trainable set only (the JAX ``make_optimizer``): with
    float32 states, ``optax.adamw``'s math (decoupled decay on the old
    weight, the same bias-corrected update); with ``adam_8bit`` the
    block-quantised int8 moments of ``train/optim8bit.py``.  With a
    ``mesh`` of more than one rank the state is sharded by whole parameters
    (``parallel.Zero1``, ZeRO-1)."""
    from aniportrait_tpu_torch.parallel.zero import Zero1, adamw_state_nbytes
    from aniportrait_tpu_torch.train.optim8bit import AdamW8bit, state_nbytes

    def build(params):
        if adam_8bit:
            return AdamW8bit(params, lr=learning_rate, betas=betas, eps=eps,
                             weight_decay=weight_decay)
        return torch.optim.AdamW(params, lr=learning_rate, betas=betas, eps=eps,
                                 weight_decay=weight_decay)

    params = list(trainable.values())
    if mesh is None or mesh.size == 1:
        return build(params)
    return Zero1(params, build, mesh,
                 state_nbytes if adam_8bit else adamw_state_nbytes)


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
               accumulation_steps: int = 1, micro_step: int = 0, mesh=None,
               **loss_kwargs) -> Dict[str, torch.Tensor]:
    """One micro-step: loss and backward; on the last of
    ``accumulation_steps`` micro-steps (``micro_step`` counts from 0) also
    clip and step the optimizer.  Float32 master weights; with
    ``compute_dtype=torch.bfloat16`` the forward and backward run under
    ``torch.autocast``.  Returns the loss, the gradient norm (None on a
    micro-step that does not step) and whether the weights moved (tensors on
    the device, not synchronised).  Under ``mesh`` the batch is this rank's
    rows and the loss returned is the global batch's."""
    dev = batch["pixel_values"].device.type
    autocast = (torch.autocast(dev, dtype=compute_dtype)
                if compute_dtype != torch.float32 else nullcontext())
    modules.pose_guider.train()
    if micro_step == 0:
        optimizer.zero_grad(set_to_none=True)
    with autocast, span("forward"):
        loss = loss_fn(modules, batch, draws=draws, generator=generator,
                       mesh=mesh, **loss_kwargs)
    with span("backward"):
        (loss / accumulation_steps if accumulation_steps > 1 else loss).backward()
    loss = loss.detach()
    if mesh is not None:
        loss = mesh.world.all_reduce_(loss.float().clone()) / mesh.size
    if micro_step < accumulation_steps - 1:
        return {"loss": loss, "grad_norm": None, "stepped": False}
    params = [p for group in optimizer.param_groups for p in group["params"]]
    for p in params:
        # a weight the loss does not reach (the last transformer block of the
        # ReferenceNet past its bank capture) gets a zero gradient, so AdamW
        # still decays it, as optax does; torch would skip it
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if mesh is not None:
        all_reduce_mean_([p.grad for p in params], mesh.world)
    with span("clip"):
        norm = clip_by_global_norm(params, max_grad_norm)
    with span("optimizer"):
        optimizer.step()
    return {"loss": loss, "grad_norm": norm, "stepped": True}
