"""Trainable-only training checkpoints and resume (port of
``aniportrait_tpu/train/checkpoint.py:45-180``), written as torch files.

A checkpoint holds only what training changes: the trainable weights, the
optimizer state, the PoseGuider's BatchNorm statistics and the step.  The
frozen weights come from the models the trainer was built with; their
shapes and dtypes are recorded, and a restore onto models whose frozen
weights differ from the record raises.  ``resume_from_checkpoint: 'latest'``
resumes from :func:`latest_step`.

Layout: ``<ckpt_dir>/checkpoint-<step>/state.pt``, written under a
temporary name and renamed when complete; the newest ``keep`` are kept (the
reference's ``checkpoint-*`` folders, train_stage_1.py:462-478, 632-636).
A save copies the state to the host on the caller's thread and, with
``block=False``, writes the file on a thread: the caller joins it through
:func:`finish_async_save` before the next save and before it exits.

    save = save_train_checkpoint(ckpt_dir, modules, optimizer, trainable,
                                 step, stage=2, block=False)

Data-parallel training (a ``parallel.Zero1`` optimizer) gathers the sharded
optimizer state to rank 0 at a save, and only rank 0 writes (every rank
calls the save); a restore runs on every rank, each loading the state of the
parameters it owns.
    ...
    finish_async_save(save)
    step = restore_train_checkpoint(ckpt_dir, modules, optimizer, trainable,
                                    stage=2, step=latest_step(ckpt_dir))
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Dict, Optional

import torch

STATE_FILE = "state.pt"
_CKPT = re.compile(r"checkpoint-(\d+)")


def _steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(ckpt_dir)
                  if (m := _CKPT.fullmatch(name))
                  and os.path.exists(os.path.join(ckpt_dir, name, STATE_FILE)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest complete checkpoint's step, or None."""
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def _stats(modules) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in modules.pose_guider.state_dict().items()
            if k.endswith(("running_mean", "running_var", "num_batches_tracked"))}


def frozen_meta(modules, trainable: Dict[str, torch.nn.Parameter]) -> Dict[str, list]:
    """``{'model.param': [shape, dtype]}`` of every parameter not in
    ``trainable``."""
    return {f"{model}.{name}": [list(p.shape), str(p.dtype)]
            for model, module in modules.models().items()
            for name, p in module.named_parameters()
            if f"{model}.{name}" not in trainable}


def snapshot(modules, optimizer: torch.optim.Optimizer,
             trainable: Dict[str, torch.nn.Parameter], step: int, stage: int) -> dict:
    """Host copies of everything a checkpoint holds."""
    host = lambda v: v.detach().to("cpu", copy=True) if torch.is_tensor(v) else v
    names = {p: name for name, p in trainable.items()}
    gather = getattr(optimizer, "gather_state", None)
    opt_state = gather() if gather is not None else optimizer.state
    return {
        "step": int(step),
        "stage": int(stage),
        "trainable": {name: host(p) for name, p in trainable.items()},
        "optimizer": {names[p]: {k: host(v) for k, v in st.items()}
                      for p, st in opt_state.items()},
        "batch_stats": {k: host(v) for k, v in _stats(modules).items()},
        "frozen": frozen_meta(modules, trainable),
    }


def _write(ckpt_dir: str, state: dict, keep: int) -> None:
    final = os.path.join(ckpt_dir, f"checkpoint-{state['step']}")
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state, os.path.join(tmp, STATE_FILE))
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    for old in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"checkpoint-{old}"), ignore_errors=True)


class AsyncSave:
    """A checkpoint write on its own thread; :meth:`join` waits for it and
    raises what it raised."""

    def __init__(self, fn):
        self.error: Optional[BaseException] = None

        def run():
            try:
                fn()
            except BaseException as e:  # re-raised by join()
                self.error = e

        self.thread = threading.Thread(target=run, name="checkpoint-save")
        self.thread.start()

    def join(self) -> None:
        self.thread.join()
        if self.error is not None:
            raise self.error


def save_train_checkpoint(ckpt_dir: str, modules, optimizer: torch.optim.Optimizer,
                          trainable: Dict[str, torch.nn.Parameter], step: int,
                          stage: int, keep: int = 1, block: bool = True,
                          write: bool = True) -> Optional[AsyncSave]:
    """Save a trainable-only checkpoint at ``step``; with ``block=False``
    return the :class:`AsyncSave` writing it.  ``write=False``: take part
    in the snapshot's gather only (a data-parallel rank other than 0)."""
    state = snapshot(modules, optimizer, trainable, step, stage)
    if not write:
        return None
    os.makedirs(ckpt_dir, exist_ok=True)
    if block:
        _write(ckpt_dir, state, keep)
        return None
    return AsyncSave(lambda: _write(ckpt_dir, state, keep))


def finish_async_save(save: Optional[AsyncSave]) -> None:
    if save is not None:
        save.join()


@torch.no_grad()
def restore_train_checkpoint(ckpt_dir: str, modules, optimizer: torch.optim.Optimizer,
                             trainable: Dict[str, torch.nn.Parameter], stage: int,
                             step: Optional[int] = None) -> int:
    """Load the checkpoint at ``step`` (default the latest) into the
    trainable weights, ``optimizer`` and the PoseGuider's statistics, in
    place; returns its step.  Raises where the checkpoint is of another
    stage, names other trainables, or records frozen weights of other
    shapes or dtypes than the models'."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"checkpoint-{step}", STATE_FILE)
    state = torch.load(path, map_location="cpu", weights_only=True)
    if state["stage"] != stage:
        raise ValueError(f"{path} is a stage-{state['stage']} checkpoint, "
                         f"not stage {stage}")
    if set(state["trainable"]) != set(trainable):
        diff = sorted(set(state["trainable"]) ^ set(trainable))
        raise ValueError(f"{path}: trainable weights differ: {diff[:8]}")
    own = frozen_meta(modules, trainable)
    bad = sorted(k for k in set(own) | set(state["frozen"])
                 if own.get(k) != state["frozen"].get(k))
    if bad:
        k = bad[0]
        raise ValueError(f"{path}: {len(bad)} frozen weights differ from the models, "
                         f"e.g. {k}: models {own.get(k)} vs checkpoint "
                         f"{state['frozen'].get(k)}")
    for name, p in trainable.items():
        p.copy_(state["trainable"][name])
    optimizer.state.clear()
    owns = getattr(optimizer, "owns", lambda p: True)
    for name, st in state["optimizer"].items():
        p = trainable[name]
        if owns(p):
            optimizer.state[p] = {k: v if k == "step" else v.to(p.device)
                                  for k, v in st.items()}
    stats = _stats(modules)
    for k, v in state["batch_stats"].items():
        stats[k].copy_(v)
    return step
