"""Per-phase wall-clock accounting (port of the ``PhaseTimer`` of
``aniportrait_tpu/utils/profiling.py``).  On a GPU the caller synchronises
inside the phase so that the time covers the device work."""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict


class PhaseTimer:
    """Accumulates wall-clock per named phase."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": round(v, 4), "count": self.counts[k]}
            for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
        }

    def report(self) -> str:
        return json.dumps(self.summary())
