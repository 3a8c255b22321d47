"""Micro-size configurations of the two cells' kinds, for the CPU
rehearsals: the port's ``micro`` models (``factory.MICRO``) at 64x64, in
float32, a few DDIM steps."""

import copy
from types import SimpleNamespace

from harness import manifest as mf

MODELS = {
    "unet": {"block_out_channels": [32, 32], "layers_per_block": 1, "attention_heads": 4,
             "cross_attention_dim": 16},
    "motion_module": {},
    "vae": {"block_out_channels": [32, 32, 32, 32]},
    "clip": {"hidden": 32, "layers": 1, "heads": 4, "intermediate": 64, "patch": 8,
             "image_size": 32, "projection_dim": 16},
    "pose_guider": {"noise_latent_channels": 32, "attn_heads": 4, "attn_dim_head": 8,
                    "num_stages": 2},
}


def gen_config(steps: int = 3, size: int = 64) -> dict:
    cfg = mf.config(mf.load_manifest(), "aniportrait-v1-pose2vid-512")
    cfg = copy.deepcopy(cfg)
    cfg["models"] = copy.deepcopy(MODELS)
    cfg["sampler"].update(width=size, height=size, steps=steps)
    cfg["program"] = {"size": "micro", "dtype": "float32", "tf32": False}
    return cfg


def train_config(size: int = 64, frames: int = 8) -> dict:
    cfg = copy.deepcopy(mf.config(mf.load_manifest(), "aniportrait-v1-stage2-train-512"))
    cfg["models"] = copy.deepcopy(MODELS)
    cfg["training"].update(sample_size=[size, size], frames=frames, mixed_precision="no")
    cfg["program"] = {"size": "micro", "frozen_dtype": "float32", "tf32": False}
    return cfg


def traffic(name: str, **over) -> dict:
    t = copy.deepcopy(mf.traffic(name))
    t.update(over)
    return t


def context(cfg, traffic, seed=2**31 + 11, seconds=0.5, trace=0, logs=None):
    import time

    logs = [] if logs is None else logs
    return SimpleNamespace(args=SimpleNamespace(seed=seed, seconds=seconds, trace=trace),
                           cell={"name": "micro", "chips": 1}, config=cfg, traffic=traffic,
                           t_start=time.perf_counter(), device="cpu", log=logs.append)
