"""Block-wise 8-bit AdamW (port of ``aniportrait_tpu/train/optim8bit.py``).

The reference trains with bitsandbytes' 8-bit Adam when its solver sets
``use_8bit_adam`` (train_stage_1.py:366-376).  Adam's two moments are
stored as 8-bit codes with one float32 scale per block of ``block_size``
contiguous elements (the flattened parameter, zero-padded to whole blocks),
about 2 bytes of state per parameter instead of 8.  Each step dequantises,
runs exact float32 AdamW math (bias correction, eps, decoupled weight decay
on the old weight) and requantises, in plain tensor ops.

The first moment ``m`` is linear int8 with an absmax scale, as in the JAX
package.  The second moment ``v`` is by default a log2 code (``v_code=
"log2"``): ``code = round(-8 * log2(v / blockmax))`` clipped to [0, 254],
255 for exactly 0, so one code step is 1/8 octave and the code spans 31.75
octaves below the block's largest ``v``.  The JAX package stores ``v`` as
linear int8 too (``v_code="linear"``, kept for the parity test): any ``v``
below 1/254 of its block's largest then becomes 0, and the next step
divides a surviving ``m`` by ``sqrt((1 - b2) g^2) + eps``, a step thousands
of times ``lr`` where gradient scales in a block spread over a decade or
more (ROADMAP F10, P3).

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


LOG2_STEPS = 8  # codes per octave of the log2 code
LOG2_ZERO = 255  # the log2 code of exactly 0


def quantize_log2(x: torch.Tensor, block: int):
    """float32 (padded length,) >= 0 -> (uint8 codes, float32 block max):
    ``round(-8 * log2(x / max))`` clipped to [0, 254], 255 where x is 0
    (the max is 1 for an all-zero block)."""
    blocks = x.reshape(-1, block)
    vmax = blocks.amax(dim=1)
    scale = torch.where(vmax > 0, vmax, torch.ones_like(vmax))
    ratio = blocks / scale[:, None]
    code = torch.clamp(torch.round(-LOG2_STEPS * torch.log2(ratio)), 0, LOG2_ZERO - 1)
    code = torch.where(blocks > 0, code, torch.full_like(code, LOG2_ZERO))
    return code.to(torch.uint8).reshape(-1), scale


def dequantize_log2(q: torch.Tensor, scale: torch.Tensor, block: int) -> torch.Tensor:
    code = q.reshape(-1, block).float()
    x = scale[:, None] * torch.exp2(code / -LOG2_STEPS)
    return torch.where(code == LOG2_ZERO, torch.zeros_like(x), x).reshape(-1)


V_CODES = {"log2": (quantize_log2, dequantize_log2), "linear": (quantize, dequantize)}


class AdamW8bit(torch.optim.Optimizer):
    """AdamW with 8-bit block-quantised moments.  State per parameter:
    ``step`` (a float32 count), ``m`` (int8, padded length), ``v`` (uint8
    log2 codes, or int8 with ``v_code="linear"``) and ``m_scale``/``v_scale``
    (float32, one per block)."""

    def __init__(self, params, lr: float = 1e-5, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2, block_size: int = 256, v_code: str = "log2"):
        if v_code not in V_CODES:
            raise ValueError(f"v_code must be one of {sorted(V_CODES)}, not {v_code!r}")
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay, block_size=block_size,
                                      v_code=v_code))

    def _init_state(self, p: torch.Tensor, block: int, v_code: str) -> dict:
        n = padded_len(p.numel(), block)
        ones = lambda: torch.ones(n // block, device=p.device, dtype=torch.float32)
        m = torch.zeros(n, device=p.device, dtype=torch.int8)
        v = (torch.full((n,), LOG2_ZERO, device=p.device, dtype=torch.uint8)
             if v_code == "log2" else torch.zeros(n, device=p.device, dtype=torch.int8))
        return dict(step=torch.zeros((), dtype=torch.float32), m=m, m_scale=ones(),
                    v=v, v_scale=ones())

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
            v_quantize, v_dequantize = V_CODES[group["v_code"]]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state.update(self._init_state(p, block, group["v_code"]))
                state["step"] += 1
                # the bias corrections in float32 on the host, as exact floats
                c1, c2 = (float(1.0 - torch.pow(torch.tensor(b), state["step"]))
                          for b in (b1, b2))
                n = p.numel()
                g = F.pad(p.grad.reshape(-1).float(), (0, state["m"].numel() - n))
                m = b1 * dequantize(state["m"], state["m_scale"], block) + (1.0 - b1) * g
                v = b2 * v_dequantize(state["v"], state["v_scale"], block) + (1.0 - b2) * g * g
                upd = (m / c1) / (torch.sqrt(v / c2) + eps)
                upd = upd[:n].reshape(p.shape) + wd * p.float()
                p.add_((-lr * upd).to(p.dtype))
                state["m"], state["m_scale"] = quantize(m, block)
                state["v"], state["v_scale"] = v_quantize(v, block)
        return loss


def state_nbytes(p: torch.Tensor, block: int = 256) -> int:
    """:class:`AdamW8bit`'s state of ``p``: the m and v codes over the padded
    length, a float32 scale of each per block and a float32 step."""
    n = padded_len(p.numel(), block)
    return 2 * n + 8 * (n // block) + 4


def state_bytes(optimizer: torch.optim.Optimizer) -> int:
    """Bytes of the optimizer's tensor state on the device (the step counts
    included)."""
    return sum(t.numel() * t.element_size() for s in optimizer.state.values()
               for t in s.values() if torch.is_tensor(t))
