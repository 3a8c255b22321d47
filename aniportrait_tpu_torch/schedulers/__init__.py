from .ddim import DDIMScheduler, compute_snr

__all__ = ["DDIMScheduler", "compute_snr"]
