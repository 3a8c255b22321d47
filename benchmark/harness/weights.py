"""Seeded random weights, made by the benchmark and handed to both sides.

The rule is the port's ``factory.init_weights`` (the JAX package's fill):
biases 0, norm scales and the PoseGuider's ``scale`` 1, every other
parameter N(0, 0.02); buffers as the model constructs them (BatchNorm
statistics 0 and 1, the motion modules' sinusoidal table).  Each model's
draws are one ``torch.randn`` on the device from a ``torch.Generator``
seeded from (seed, model), in float32, laid out over the parameters in the
reference model's order.  The same seed gives the same weights to the
program (copied into its parameters, which cast them to its own dtypes) and
to the reference (float32).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from harness import common
from reference.models import NORMS, make_models, sinusoidal_positional_encoding

ROLES = ("vae", "clip", "reference_unet", "denoising_unet", "pose_guider")
STD = 0.02
WEIGHTS = 6  # the weights' branch of the run's seeds (``common.sub_seed``)


def _rule(model: nn.Module):
    """(name, shape, kind) of every parameter, kind 'zero', 'one' or
    'normal', in the model's order."""
    out = []
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if pname == "bias":
                kind = "zero"
            elif isinstance(mod, NORMS) or pname == "scale":
                kind = "one"
            else:
                kind = "normal"
            out.append((name, tuple(p.shape), kind))
    return out


def iter_state_dicts(sizes: dict, seed: int, device, roles=ROLES):
    """(role, state dict), float32 on ``device``, one role at a time: one
    draw each."""
    device = torch.device(device)
    with torch.device("meta"):
        shapes = make_models(sizes)
    for role in roles:
        model = shapes[role]
        rule = _rule(model)
        n = sum(int(np.prod(s)) for _, s, k in rule if k == "normal")
        gen = torch.Generator(device=device).manual_seed(
            common.sub_seed(seed, WEIGHTS, ROLES.index(role)))
        flat = torch.randn(n, generator=gen, device=device, dtype=torch.float32).mul_(STD)
        state, off = {}, 0
        for name, shape, kind in rule:
            if kind == "normal":
                size = int(np.prod(shape))
                state[name] = flat[off:off + size].view(shape)
                off += size
            else:
                state[name] = torch.full(shape, 1.0 if kind == "one" else 0.0, device=device)
        state.update(_buffers(model, device))
        yield role, state
        del flat, state


def _buffers(model: nn.Module, device) -> dict:
    """The model's buffers as its constructor makes them (on ``device``)."""
    out = {}
    for mname, mod in model.named_modules():
        for bname, buf in mod.named_buffers(recurse=False):
            name = f"{mname}.{bname}" if mname else bname
            if bname == "running_mean":
                out[name] = torch.zeros(buf.shape, device=device)
            elif bname == "running_var":
                out[name] = torch.ones(buf.shape, device=device)
            elif bname == "num_batches_tracked":
                out[name] = torch.zeros((), dtype=torch.long, device=device)
            elif bname == "pe":
                out[name] = torch.from_numpy(
                    sinusoidal_positional_encoding(buf.shape[1], buf.shape[2])).to(device)
            else:
                raise KeyError(f"no rule for the buffer {name}")
    return out


def load_into(model: nn.Module, state: dict) -> None:
    """Copy ``state`` into ``model`` (its own dtypes); every name must
    match both ways."""
    with torch.no_grad():
        missing, unexpected = model.load_state_dict(state, strict=False)
    if missing or unexpected:
        raise KeyError(f"weights do not match the model: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")


def reference_models(sizes: dict, seed: int, device, roles=ROLES) -> Dict[str, nn.Module]:
    """The plain reference's models, float32 on ``device``, from ``seed``."""
    with torch.device("meta"):
        models = make_models(sizes)
    out = {}
    for role, state in iter_state_dicts(sizes, seed, device, roles):
        model = models[role].to_empty(device=device)
        load_into(model, state)
        out[role] = model.eval().requires_grad_(False)
    return out
