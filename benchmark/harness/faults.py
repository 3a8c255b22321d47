"""Faults planted under the timed path, to show that the comparison which
decides ``correct`` catches each fault a cell can have (the tests at micro
size on the CPU; ``readings.py`` at the cell's size on the card).  Each is
a context manager that patches the program while it is open.

Generation: ``step_unchanged`` (each DDIM update returns its input),
``half_batch`` (the UNet's second half of rows, the conditional ones,
replaced by the first half's), ``answer_altered`` (the first frame of each
request inverted where the decode produces it).

Training: ``step_unchanged`` (the optimizer's step leaves the weights as
they are), ``half_batch`` (the loss taken over the first half of the clip's
frames), ``answer_altered`` (the first frame's noise prediction shifted
where the UNet produces it).
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

GEN = ("step_unchanged", "half_batch", "answer_altered")
TRAIN = ("step_unchanged", "half_batch", "answer_altered")


def _unet_patch(edit):
    from aniportrait_tpu_torch.models.unet import AniUNet

    real = AniUNet.forward

    def forward(self, *args, **kwargs):
        out, banks = real(self, *args, **kwargs)
        if torch.is_tensor(out):
            out = edit(out)
        return out, banks

    return mock.patch.object(AniUNet, "forward", forward)


@contextlib.contextmanager
def gen_fault(name: str):
    from aniportrait_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline
    from aniportrait_tpu_torch.schedulers.ddim import DDIMScheduler

    if name == "step_unchanged":
        patch = mock.patch.object(DDIMScheduler, "step",
                                  lambda self, out, t, sample, n: sample)
    elif name == "half_batch":
        def edit(out):
            half = out.shape[0] // 2
            return torch.cat([out[:half], out[:half]]) if half else out
        patch = _unet_patch(edit)
    elif name == "answer_altered":
        real = Pose2VideoPipeline._decode

        def decode(self, *args, **kwargs):
            video = real(self, *args, **kwargs)
            video[0] = 255 - video[0]
            return video
        patch = mock.patch.object(Pose2VideoPipeline, "_decode", decode)
    else:
        raise KeyError(name)
    with patch:
        yield


@contextlib.contextmanager
def train_fault(name: str):
    from aniportrait_tpu_torch.train import train_step

    if name == "step_unchanged":
        patch = mock.patch.object(torch.optim.AdamW, "step", lambda self, closure=None: None)
    elif name == "half_batch":
        real = train_step.loss_fn

        def loss_fn(modules, batch, **kwargs):
            f = batch["pixel_values"].shape[1]
            return real(modules, {k: v[:, :f // 2] if v.ndim == 5 else v
                                  for k, v in batch.items()}, **kwargs)
        patch = mock.patch.object(train_step, "loss_fn", loss_fn)
    elif name == "answer_altered":
        def edit(out):
            out = out.clone()
            out[:, 0] += 1.0
            return out
        patch = _unet_patch(edit)
    else:
        raise KeyError(name)
    with patch:
        yield
