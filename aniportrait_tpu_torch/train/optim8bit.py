"""Block-wise 8-bit AdamW (port of ``aniportrait_tpu/train/optim8bit.py``).

The reference trains with bitsandbytes' 8-bit Adam when its solver sets
``use_8bit_adam`` (train_stage_1.py:366-376).  As in the JAX package, Adam's
two moments are stored as int8 with one float32 absmax scale per block of
``block_size`` contiguous elements (the flattened parameter, zero-padded to
whole blocks), about 2 bytes of state per parameter instead of 8.  Each step
dequantises, runs exact float32 AdamW math (bias correction, eps, decoupled
weight decay on the old weight) and requantises, in plain tensor ops.

    opt = AdamW8bit(params, lr=1e-5, betas=(0.9, 0.999), eps=1e-8,
                    weight_decay=1e-2)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def padded_len(n: int, block: int) -> int:
    return -(-n // block) * block


def quantize(x: torch.Tensor, block: int):
    """float32 (padded length,) -> (int8 codes, float32 scale per block):
    ``round(x / scale)`` clipped to [-127, 127], ``scale = absmax / 127``
    (1 for an all-zero block)."""
    blocks = x.reshape(-1, block)
    absmax = blocks.abs().amax(dim=1)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127).to(torch.int8)
    return q.reshape(-1), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, block: int) -> torch.Tensor:
    return (q.reshape(-1, block).float() * scale[:, None]).reshape(-1)


class AdamW8bit(torch.optim.Optimizer):
    """AdamW with int8 block-quantised moments.  State per parameter:
    ``step`` (a float32 count), ``m``/``v`` (int8, padded length) and
    ``m_scale``/``v_scale`` (float32, one per block)."""

    def __init__(self, params, lr: float = 1e-5, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2, block_size: int = 256):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay, block_size=block_size))

    def _init_state(self, p: torch.Tensor, block: int) -> dict:
        n = padded_len(p.numel(), block)
        ones = lambda: torch.ones(n // block, device=p.device, dtype=torch.float32)
        zeros = lambda: torch.zeros(n, device=p.device, dtype=torch.int8)
        return dict(step=torch.zeros((), dtype=torch.float32), m=zeros(), m_scale=ones(),
                    v=zeros(), v_scale=ones())

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps, wd, block = (group["lr"], group["eps"], group["weight_decay"],
                                  group["block_size"])
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state.update(self._init_state(p, block))
                state["step"] += 1
                # the bias corrections in float32 on the host, as exact floats
                c1, c2 = (float(1.0 - torch.pow(torch.tensor(b), state["step"]))
                          for b in (b1, b2))
                n = p.numel()
                g = F.pad(p.grad.reshape(-1).float(), (0, state["m"].numel() - n))
                m = b1 * dequantize(state["m"], state["m_scale"], block) + (1.0 - b1) * g
                v = b2 * dequantize(state["v"], state["v_scale"], block) + (1.0 - b2) * g * g
                upd = (m / c1) / (torch.sqrt(v / c2) + eps)
                upd = upd[:n].reshape(p.shape) + wd * p.float()
                p.add_((-lr * upd).to(p.dtype))
                state["m"], state["m_scale"] = quantize(m, block)
                state["v"], state["v_scale"] = quantize(v, block)
        return loss


def state_bytes(optimizer: torch.optim.Optimizer) -> int:
    """Bytes of the optimizer's tensor state on the device (the step counts
    included)."""
    return sum(t.numel() * t.element_size() for s in optimizer.state.values()
               for t in s.values() if torch.is_tensor(t))
