from .ddim import DDIMScheduler

__all__ = ["DDIMScheduler"]
