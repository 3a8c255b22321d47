"""DDIM scheduler (port of ``aniportrait_tpu/schedulers/ddim.py``): numpy
tables, v-prediction, zero-terminal-SNR beta rescale, trailing / leading /
linspace spacing.  ``step`` runs in float32 on the device of its inputs; the
training helpers (``add_noise``, ``get_velocity``, :func:`compute_snr`) take
a tensor of integer timesteps, one per batch row."""

from __future__ import annotations

import numpy as np
import torch

from aniportrait_tpu_torch.utils.profiling import count


def _at_timesteps(table: np.ndarray, t: torch.Tensor) -> torch.Tensor:
    """float32 ``table[t]`` on ``t``'s device.  The table goes over from
    pageable host memory: on a GPU a blocking copy, which waits for the
    stream, so it counts as one of the host's ``host_syncs``."""
    if t.device.type != "cpu":
        count("host_syncs")
    return torch.from_numpy(np.asarray(table, np.float32)).to(t.device)[t.long()]


def make_betas(num_train_timesteps: int, beta_start: float, beta_end: float,
               beta_schedule: str) -> np.ndarray:
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    if beta_schedule == "scaled_linear":
        return np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train_timesteps,
                           dtype=np.float64) ** 2
    raise ValueError(f"unknown beta_schedule: {beta_schedule}")


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Rescale betas so the last step has zero SNR (Lin et al. 2023)."""
    alphas_bar_sqrt = np.sqrt(np.cumprod(1.0 - betas))
    first, last = alphas_bar_sqrt[0].copy(), alphas_bar_sqrt[-1].copy()
    alphas_bar_sqrt -= last
    alphas_bar_sqrt *= first / (first - last)
    alphas_bar = alphas_bar_sqrt ** 2
    alphas = np.concatenate([alphas_bar[:1], alphas_bar[1:] / alphas_bar[:-1]])
    return 1.0 - alphas


class DDIMScheduler:
    def __init__(self, num_train_timesteps: int = 1000, beta_start: float = 0.00085,
                 beta_end: float = 0.012, beta_schedule: str = "linear",
                 clip_sample: bool = False, set_alpha_to_one: bool = True,
                 steps_offset: int = 1, prediction_type: str = "v_prediction",
                 timestep_spacing: str = "trailing",
                 rescale_betas_zero_snr: bool = True):
        self.num_train_timesteps = num_train_timesteps
        self.prediction_type = prediction_type
        self.clip_sample = clip_sample
        self.steps_offset = steps_offset
        self.timestep_spacing = timestep_spacing
        betas = make_betas(num_train_timesteps, beta_start, beta_end, beta_schedule)
        if rescale_betas_zero_snr:
            betas = rescale_zero_terminal_snr(betas)
        acp = np.cumprod(1.0 - betas)
        self.betas = betas.astype(np.float32)
        self.alphas_cumprod = acp.astype(np.float32)
        self.final_alpha_cumprod = np.float32(1.0 if set_alpha_to_one else acp[0])
        self.init_noise_sigma = 1.0

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        """Descending int timesteps for the given step count."""
        T, S = self.num_train_timesteps, num_inference_steps
        if self.timestep_spacing == "trailing":
            ts = np.round(np.arange(T, 0, -T / S)).astype(np.int64) - 1
        elif self.timestep_spacing == "leading":
            ts = (np.arange(0, S) * (T // S)).round()[::-1].astype(np.int64)
            ts = ts + self.steps_offset
        elif self.timestep_spacing == "linspace":
            ts = np.linspace(0, T - 1, S).round()[::-1].astype(np.int64)
        else:
            raise ValueError(f"unknown timestep_spacing: {self.timestep_spacing}")
        return ts.astype(np.int32)

    def step(self, model_output: torch.Tensor, t: int, sample: torch.Tensor,
             num_inference_steps: int) -> torch.Tensor:
        """One deterministic (eta = 0) DDIM update from timestep ``t``."""
        out = model_output.float()
        x = sample.float()
        prev_t = int(t) - self.num_train_timesteps // num_inference_steps
        a_t = self.alphas_cumprod[int(t)]
        a_prev = self.alphas_cumprod[prev_t] if prev_t >= 0 else self.final_alpha_cumprod
        # float32 table values, square roots taken in float32 as in JAX
        sqrt_a = float(np.sqrt(a_t))
        sqrt_b = float(np.sqrt(np.float32(1.0) - a_t))
        if self.prediction_type == "epsilon":
            pred_x0 = (x - sqrt_b * out) / sqrt_a
            pred_eps = out
        elif self.prediction_type == "v_prediction":
            pred_x0 = sqrt_a * x - sqrt_b * out
            pred_eps = sqrt_a * out + sqrt_b * x
        elif self.prediction_type == "sample":
            pred_x0 = out
            pred_eps = (x - sqrt_a * pred_x0) / sqrt_b
        else:
            raise ValueError(f"unknown prediction_type: {self.prediction_type}")
        if self.clip_sample:
            pred_x0 = pred_x0.clamp(-1.0, 1.0)
            pred_eps = (x - sqrt_a * pred_x0) / sqrt_b
        prev = (float(np.sqrt(a_prev)) * pred_x0
                + float(np.sqrt(np.float32(1.0) - a_prev)) * pred_eps)
        return prev.to(sample.dtype)

    # ------------------------------------------------------------- training
    def _coefficients(self, sample: torch.Tensor, t: torch.Tensor):
        """sqrt(acp[t]) and sqrt(1 - acp[t]), float32 square roots, shaped
        to broadcast over ``sample``'s batch axis, in its dtype."""
        acp = _at_timesteps(self.alphas_cumprod, t)
        shape = (-1,) + (1,) * (sample.ndim - 1)
        sa = torch.sqrt(acp).reshape(shape).to(sample.dtype)
        sb = torch.sqrt(1.0 - acp).reshape(shape).to(sample.dtype)
        return sa, sb

    def add_noise(self, sample: torch.Tensor, noise: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
        sa, sb = self._coefficients(sample, t)
        return sa * sample + sb * noise

    def get_velocity(self, sample: torch.Tensor, noise: torch.Tensor,
                     t: torch.Tensor) -> torch.Tensor:
        """The v-prediction target sqrt(acp) * noise - sqrt(1 - acp) * x0."""
        sa, sb = self._coefficients(sample, t)
        return sa * noise - sb * sample


def compute_snr(alphas_cumprod: np.ndarray, t: torch.Tensor) -> torch.Tensor:
    """Signal-to-noise ratio acp / (1 - acp) per timestep, float32, for
    Min-SNR loss weighting (reference ``train_stage_1.py:101-128``)."""
    acp = _at_timesteps(alphas_cumprod, t)
    return acp / (1.0 - acp)
