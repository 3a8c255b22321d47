"""JAX parameter trees -> the port's ``state_dict``.

Walks the port module's own keys (the reference torch checkpoint names),
finds each key's rule in ``weights/convert.py`` (the port's copy of the JAX
package's torch <-> flax naming rules) and applies the inverse of the rule's
layout transform.  Keys a rule marks ``skip`` (the motion modules' ``pe``
tables, BatchNorm's ``num_batches_tracked``) keep the module's own value.
Transforms are looked up by name, so rule lists built by either package's
``convert.py`` apply.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from aniportrait_tpu_torch.weights import convert as cv

# inverse layout transforms (flax -> torch) of convert.py's rules, by name
INVERSE = {
    "t_none": lambda w: w,
    "t_linear": lambda w: w.T,
    "t_conv2d": lambda w: w.transpose(3, 2, 0, 1),
    "t_conv1x1_dense": lambda w: w.T[:, :, None, None],
    "t_conv1d": lambda w: w.transpose(2, 1, 0),
}


def _lookup(tree: Dict[str, Any], path: str) -> np.ndarray:
    node = tree
    for part in path.split("/"):
        node = node[part]
    return np.asarray(node)


def state_dict_from_jax(module: nn.Module, rules: List[cv.Rule],
                        params: Dict[str, Any],
                        batch_stats: Optional[Dict[str, Any]] = None
                        ) -> Dict[str, torch.Tensor]:
    """Build ``module``'s state dict from a flax ``params`` tree (and
    ``batch_stats`` for BatchNorm statistics) through convert.py ``rules``."""
    compiled = [(re.compile(pat), tmpl, tf) for pat, tmpl, tf in rules]
    out = {}
    for key, current in module.state_dict().items():
        for creg, tmpl, tf in compiled:
            m = creg.fullmatch(key)
            if m is None:
                continue
            if tmpl == "skip":
                out[key] = current.clone()
            else:
                path = m.expand(tmpl)
                if path.startswith("stats:"):
                    arr = _lookup(batch_stats, path[len("stats:"):])
                else:
                    arr = _lookup(params, path)
                arr = np.array(INVERSE[tf.__name__](arr), order="C")  # writable copy
                if arr.shape != tuple(current.shape):
                    raise ValueError(
                        f"{key}: converted shape {arr.shape} != {tuple(current.shape)}"
                    )
                out[key] = torch.from_numpy(arr).to(current.dtype)
            break
        else:
            raise KeyError(f"no convert.py rule for {key}")
    return out


def unet_from_jax(module: nn.Module, params: Dict[str, Any]):
    return state_dict_from_jax(module, cv.unet_rules(), params)


def vae_from_jax(module: nn.Module, params: Dict[str, Any]):
    return state_dict_from_jax(module, cv.vae_rules(), params)


def clip_from_jax(module: nn.Module, params: Dict[str, Any]):
    return state_dict_from_jax(module, cv.clip_vision_rules(), params)


def pose_guider_from_jax(module: nn.Module, variables: Dict[str, Any]):
    return state_dict_from_jax(module, cv.pose_guider_rules(), variables["params"],
                               variables["batch_stats"])
