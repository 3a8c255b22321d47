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

The audio models' rule lists (:func:`wav2vec2_rules`,
:func:`audio2mesh_rules`, :func:`audio2pose_rules`) name the flax paths of
the JAX package's parameter trees, for ``weights/from_jax.py``; the files
themselves are read by ``scripts/loader.py:load_audio_models``.
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


def wav2vec2_rules(prefix: str = "", into: str = "") -> List[cv.Rule]:
    """The wav2vec2 rules of ``convert_wav2vec2`` (the positional conv's
    kernel merged from its weight norm), for keys under ``prefix``; the flax
    paths under ``into``."""
    rules = cv.wav2vec2_rules(prefix) + [
        (re.escape(prefix) + r"encoder\.pos_conv_embed\.conv\.weight", "pos_conv/kernel",
         cv.t_conv1d),
    ]
    return [(pat, tmpl if tmpl == "skip" or not into else f"{into}/{tmpl}", tf)
            for pat, tmpl, tf in rules]


def _head_rules(*names: str, into: str = "") -> List[cv.Rule]:
    return [rule for name in names for rule in (
        (rf"{name}\.weight", f"{into}{name}/kernel", cv.t_linear),
        (rf"{name}\.bias", f"{into}{name}/bias", cv.t_none))]


def audio2mesh_rules() -> List[cv.Rule]:
    """``convert_audio2mesh``'s rules: the encoder under ``audio_encoder.``
    and the two heads."""
    return wav2vec2_rules("audio_encoder.", "audio_encoder") + _head_rules("in_fn", "out_fn")


def audio2pose_rules() -> List[cv.Rule]:
    """``convert_audio2pose``'s rules.  The position table ``PPE.pe`` and
    ``biased_mask`` are skipped (the model computes both).  The attentions'
    packed ``in_proj`` has no single flax path: the JAX package keeps the
    self attention's q, k, v apart (``self_q``/``self_k``/``self_v``) and of
    the cross attention only the value (``cross_v``); ``from_jax`` packs
    them under the paths ``self_in_proj`` and ``cross_in_proj`` named here."""
    layer = r"transformer_decoder\.layers\.(\d+)\."
    out = r"decoder/layer_\1/"
    rules = wav2vec2_rules("audio_encoder.", "audio_encoder") + _head_rules("in_fn") + [
        *_head_rules("pose_map", "pose_map_r", into="decoder/"),
        (r"id_embed\.weight", "id_embed/embedding", cv.t_none),
        (r"biased_mask", "skip", cv.t_none),
        (r"PPE\.pe", "skip", cv.t_none),
    ]
    for attn, name in (("self_attn", "self"), ("multihead_attn", "cross")):
        rules += [
            (layer + attn + r"\.in_proj_weight", out + name + "_in_proj/kernel", cv.t_linear),
            (layer + attn + r"\.in_proj_bias", out + name + "_in_proj/bias", cv.t_none),
            (layer + attn + r"\.out_proj\.weight", out + name + "_out/kernel", cv.t_linear),
            (layer + attn + r"\.out_proj\.bias", out + name + "_out/bias", cv.t_none),
        ]
    for lin in ("linear1", "linear2"):
        rules += [(layer + lin + r"\.weight", out + lin + "/kernel", cv.t_linear),
                  (layer + lin + r"\.bias", out + lin + "/bias", cv.t_none)]
    for norm in ("norm1", "norm2", "norm3"):
        rules += [(layer + norm + r"\.weight", out + norm + "/scale", cv.t_none),
                  (layer + norm + r"\.bias", out + norm + "/bias", cv.t_none)]
    return rules
