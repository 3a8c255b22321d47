"""What both drivers share: the run's seeds, the closed-loop window, device
memory and synchronisation that also work on the CPU (for the rehearsals in
``tests/``)."""

from __future__ import annotations

import gc
import os
import resource
import time
from types import SimpleNamespace

import numpy as np
import torch


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed derived from the run's ``--seed`` (any size) and a path."""
    state = np.random.SeedSequence([int(seed) & ((1 << 64) - 1), int(seed) >> 64, *path])
    return int(state.generate_state(2, np.uint32).view(np.uint64)[0] >> 1)


def rng(seed: int, *path: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *path))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def closed_loop(issue, seconds: float, estimate: float, clock=time.perf_counter):
    """One client: ``issue(i)`` back to back from the window's start; a next
    one only while ``estimate`` (a request's time in warm-up) still fits
    before ``seconds``.  Returns (start, [completion times])."""
    t0 = clock()
    done = []
    while not done or clock() + estimate <= t0 + seconds:
        issue(len(done))
        done.append(clock())
    return t0, done


def outcome(**kw) -> SimpleNamespace:
    """What a driver returns to the CLI: ``end_to_end`` {metric: value},
    ``layer`` (what the per-layer readers read), ``correct``, ``checks``,
    ``attempted``, ``failed``, ``memory_peak_bytes``, ``trace``."""
    return SimpleNamespace(**kw)


class HostWatch:
    """What the host did during a block, for the log: the process's CPU
    seconds (all threads), the seconds spent in the garbage collector, and
    the load average at the end."""

    def __enter__(self):
        self.gc_s, self._t = 0.0, None
        gc.callbacks.append(self._gc)
        self.cpu0 = _cpu()
        return self

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s += time.perf_counter() - self._t

    def __exit__(self, *exc):
        gc.callbacks.remove(self._gc)
        self.cpu_s = _cpu() - self.cpu0
        self.load = os.getloadavg()[0]
        return False

    def line(self) -> str:
        return (f"host: process CPU {self.cpu_s:.2f} s, garbage collection {self.gc_s:.3f} s, "
                f"load {self.load:.2f}")


def _cpu() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime
