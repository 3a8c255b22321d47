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
from aniportrait_tpu_torch.weights import load

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


def wav2vec2_from_jax(module: nn.Module, params: Dict[str, Any]):
    return state_dict_from_jax(module, load.wav2vec2_rules(), params)


def audio2mesh_from_jax(module: nn.Module, params: Dict[str, Any]):
    return state_dict_from_jax(module, load.audio2mesh_rules(), params)


def audio2pose_from_jax(module: nn.Module, params: Dict[str, Any]):
    """The decoder's packed ``in_proj`` from the JAX package's separate
    projections: ``self_q | self_k | self_v``, and ``cross_v`` behind the
    module's own (unused) cross-attention q and k."""
    decoder = dict(params["decoder"])
    own = module.state_dict()
    for name, lp in params["decoder"].items():
        if not name.startswith("layer_"):
            continue
        own_w = own[f"transformer_decoder.layers.{name[6:]}.multihead_attn.in_proj_weight"]
        own_b = own[f"transformer_decoder.layers.{name[6:]}.multihead_attn.in_proj_bias"]
        d = own_w.shape[1]
        packed = lambda *ps: {
            "kernel": np.concatenate([np.asarray(p["kernel"]) for p in ps], axis=1),
            "bias": np.concatenate([np.asarray(p["bias"]) for p in ps])}
        unused_qk = {"kernel": own_w[: 2 * d].T.numpy(), "bias": own_b[: 2 * d].numpy()}
        decoder[name] = dict(lp, self_in_proj=packed(lp["self_q"], lp["self_k"], lp["self_v"]),
                             cross_in_proj=packed(unused_qk, lp["cross_v"]))
    return state_dict_from_jax(module, load.audio2pose_rules(), {**params, "decoder": decoder})
