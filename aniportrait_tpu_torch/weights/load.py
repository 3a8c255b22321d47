"""Reading the reference's checkpoint files into the port's models.

The port's module names are the reference torch checkpoint names, so a
checkpoint enters a model through ``load_state_dict``.  Which keys of a file
are taken follows the JAX package's conversion (``aniportrait_tpu/weights/
convert.py``, whose rules ``weights/convert.py`` copies): a key a rule
converts is loaded; a key a rule marks ``skip`` (the motion modules' ``pe``
tables, which the model computes, BatchNorm's ``num_batches_tracked``,
``time_proj``, the ReferenceNet's output head) is not, and the model keeps
its own value; a key no rule matches is returned as unused, as the JAX
conversion reports it.  Nothing else is dropped: a converted key the model
lacks, or a model key the file does not give, raises.

:func:`load_torch_state_dict` and :func:`find_weights` are the port's copies
of ``aniportrait_tpu/weights/convert.py:load_torch_state_dict`` and
``scripts/loader.py:_find_weights``.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from aniportrait_tpu_torch.weights import convert as cv

# the files a HF-style model folder may hold, in the order they are tried
HF_WEIGHT_FILES = (
    "diffusion_pytorch_model.safetensors",
    "diffusion_pytorch_model.bin",
    "model.safetensors",
    "pytorch_model.bin",
)


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Load a .pth/.pt/.ckpt/.bin/.safetensors file into a flat dict of CPU
    tensors (a ``{"state_dict": ...}`` wrapper is unwrapped)."""
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError(f"reading {path} needs the safetensors package") from e
        return load_file(path, device="cpu")
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return obj


def find_weights(dir_or_file: str, subfolder: Optional[str] = None) -> str:
    """A weight file: ``dir_or_file`` itself, or in a folder (and its
    ``subfolder``) the first of :data:`HF_WEIGHT_FILES` present."""
    path = dir_or_file
    if subfolder:
        path = os.path.join(path, subfolder)
    if os.path.isdir(path):
        for name in HF_WEIGHT_FILES:
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                return cand
        raise FileNotFoundError(f"no weight file found in {path}")
    return path


def unet_rules(has_output_head: bool = True) -> List[cv.Rule]:
    """The UNet rules; without an output head (the ReferenceNet) the head's
    keys are skipped, as ``convert_unet(has_output_head=False)`` does."""
    head = [] if has_output_head else [(r"conv_norm_out\..*", "skip", cv.t_none),
                                       (r"conv_out\..*", "skip", cv.t_none)]
    return head + cv.unet_rules()


def classify(keys, rules: List[cv.Rule]) -> Tuple[List[str], List[str], List[str]]:
    """Split ``keys`` as ``convert.apply_rules`` does, by the first rule that
    matches each: (converted, skipped, unused)."""
    compiled = [(re.compile(pat), tmpl) for pat, tmpl, _ in rules]
    out: Tuple[List[str], List[str], List[str]] = ([], [], [])
    for key in keys:
        tmpl = next((t for creg, t in compiled if creg.fullmatch(key)), None)
        out[2 if tmpl is None else 1 if tmpl == "skip" else 0].append(key)
    return out


def load_into(model: nn.Module, state: Mapping[str, torch.Tensor],
              rules: List[cv.Rule], source: str = "checkpoint") -> List[str]:
    """Load the converted keys of ``state`` into ``model`` (values cast to
    each parameter's dtype); returns the unused keys."""
    converted, _, unused = classify(state.keys(), rules)
    own = model.state_dict()
    extra = sorted(set(converted) - set(own))
    if extra:
        raise ValueError(f"{source}: {len(extra)} keys have no place in "
                         f"{type(model).__name__}: {extra[:8]}")
    _, own_skipped, _ = classify(own.keys(), rules)
    missing = sorted(set(own) - set(converted) - set(own_skipped))
    if missing:
        raise KeyError(f"{source}: {len(missing)} keys of {type(model).__name__} "
                       f"missing: {missing[:8]}")
    model.load_state_dict({k: torch.as_tensor(state[k]) for k in converted}, strict=False)
    return unused
