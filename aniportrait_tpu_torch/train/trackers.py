"""The port's copy of ``aniportrait_tpu/train/trackers.py`` (JAX-free; held
to the original by ``tests/test_torch_copies.py``).

Experiment trackers for the training CLIs.

Parity target: the reference initialises an Accelerate tracker group named
by the experiment and logs ``train_loss`` per step
(``train_stage_1.py:434-438,630``; backend unconfigured there).  Here the
always-on backend is a jsonl file (greppable, no deps); a TensorBoard
writer is added when tensorflow is importable (this image ships it for the
landmarker), giving the same scalars under ``<save_dir>/tb/``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class Tracker:
    def __init__(self, save_dir: str, exp_name: str, enable_tb: bool = True):
        self.t0 = time.time()
        self.jsonl_path = os.path.join(save_dir, "train_log.jsonl")
        os.makedirs(save_dir, exist_ok=True)
        self._tb = None
        if enable_tb:
            try:
                import tensorflow as tf

                self._tb = tf.summary.create_file_writer(
                    os.path.join(save_dir, "tb", exp_name)
                )
            except ImportError:
                pass

    def log(self, step: int, scalars: Dict[str, float]) -> dict:
        rec = {"step": step, **{k: float(v) for k, v in scalars.items()},
               "elapsed_s": round(time.time() - self.t0, 1)}
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            import tensorflow as tf

            with self._tb.as_default():
                for k, v in scalars.items():
                    tf.summary.scalar(k, float(v), step=step)
        return rec

    def close(self):
        if self._tb is not None:
            self._tb.close()
