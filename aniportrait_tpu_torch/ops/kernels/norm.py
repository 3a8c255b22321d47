"""Wrappers of the normalisation CUDA kernels (``csrc/norm_sm90.cu``) and
their plain PyTorch versions.

:func:`group_norm` (N1) and :func:`layer_norm` (N2) replace no TPU kernel:
the JAX package's GroupNorm and LayerNorm are XLA's, which fuses the float32
casts around them.  The plain versions are the port's composition (the
input cast to float32, the ATen norm, the output cast back, then the call
site's SiLU or positional-encoding add in the activation dtype); each
kernel reads the bf16 activation once and writes it once, with float32
statistics and affine map and the same rounding points, so it differs from
its plain version only in the order the statistics are summed.

:func:`engages` is the models' choice between the two: a CUDA bf16 call that
autograd will not record.  Float32 calls (the audio models, the float32
reference phases), CPU calls and calls that autograd records (training's
trainable modules and what follows them) take the plain version.  For a CUDA
tensor the wrappers launch the kernel or raise; they never fall back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aniportrait_tpu_torch.ops.kernels import build


def engages(x, *params) -> bool:
    """Whether a norm of ``x`` with ``params`` (its weight and bias) takes
    the kernel: a CUDA bf16 input, and autograd recording nothing."""
    if not (x.is_cuda and x.dtype == torch.bfloat16):
        return False
    return not (torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)))


def plain_group_norm(x, num_groups: int, weight, bias, eps: float, frames: int = 1,
                     silu: bool = False):
    """GroupNorm with float32 statistics on frames-folded ``(b * f, c, h,
    w)``, output in the input's dtype, then ``F.silu`` in that dtype if
    ``silu``.  ``frames`` > 1 takes the statistics over each sample's
    ``frames`` consecutive rows (a plain GroupNorm on ``(b, c, f, h, w)``)."""
    xf = x.float()
    if frames > 1:
        bf, c, h, w = x.shape
        xf = xf.reshape(bf // frames, frames, c, h, w).transpose(1, 2)
    y = F.group_norm(xf, num_groups, weight.float(), bias.float(), eps)
    if frames > 1:
        y = y.transpose(1, 2).reshape(bf, c, h, w)
    y = y.to(x.dtype)
    return F.silu(y) if silu else y


def plain_layer_norm(x, weight, bias, eps: float, pe=None):
    """LayerNorm over the last dim with float32 statistics, output in the
    input's dtype; with ``pe`` ``(f, c)`` on natural ``(b, f, s, c)`` input,
    plus ``pe`` in that dtype (the motion module's ``norm(x) + pe``)."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(),
                     eps).to(x.dtype)
    return y if pe is None else y + pe[:, None, :].to(x.dtype)


def _param_code(name, x, weight, bias, channels: int) -> int:
    if (weight is None or bias is None or weight.dtype != bias.dtype
            or weight.dtype not in build.DTYPE_CODES
            or weight.numel() != channels or bias.numel() != channels
            or not (weight.is_contiguous() and bias.is_contiguous())
            or weight.get_device() != x.get_device() or bias.get_device() != x.get_device()):
        raise ValueError(f"{name}: weight and bias must be contiguous ({channels},) "
                         "tensors of one dtype, bf16 or float32, on the input's device")
    return build.DTYPE_CODES[weight.dtype]


def _check_input(name, x, ndim: int | None = None):
    if not x.is_cuda:
        raise RuntimeError(f"{name}: tensor on {x.device}, expected CPU or CUDA")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (the kernel is bf16; "
                        "other dtypes take the plain version)")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    if ndim is not None and x.ndim != ndim:
        raise ValueError(f"{name}: input of shape {tuple(x.shape)}, expected {ndim} dims")


def group_norm(x, num_groups: int, weight, bias, eps: float, frames: int = 1,
               silu: bool = False):
    """N1: :func:`plain_group_norm` of a contiguous bf16 ``(b * f, c, h, w)``
    tensor in one kernel, the SiLU fused in."""
    if x.device.type == "cpu":
        return plain_group_norm(x, num_groups, weight, bias, eps, frames, silu)
    _check_input("group_norm", x, 4)
    rows, c, h, w = x.shape
    if c % num_groups or frames < 1 or rows % frames:
        raise ValueError(f"group_norm: shape {tuple(x.shape)}, {num_groups} groups, "
                         f"{frames} frames a sample")
    code = _param_code("group_norm", x, weight, bias, c)
    out = torch.empty_like(x)
    if x.numel():
        err = build.library().aniportrait_group_norm_fwd(
            x.data_ptr(), out.data_ptr(), weight.data_ptr(), bias.data_ptr(), code,
            rows // frames, frames, c, num_groups, h * w, float(eps), int(silu),
            build.stream_handle())
        build.check(err, "group_norm")
        group_norm.launches += 1
    return out


def layer_norm(x, weight, bias, eps: float, pe=None):
    """N2: :func:`plain_layer_norm` of a contiguous bf16 tensor in one
    kernel, the positional-encoding add fused in."""
    if x.device.type == "cpu":
        return plain_layer_norm(x, weight, bias, eps, pe)
    _check_input("layer_norm", x)
    c = x.shape[-1]
    code = _param_code("layer_norm", x, weight, bias, c)
    pe_ptr, pe_code, frames, positions = None, 0, 0, 0
    if pe is not None:
        if x.ndim != 4 or pe.shape != (x.shape[1], c) or not pe.is_contiguous() \
                or pe.device != x.device or pe.dtype not in build.DTYPE_CODES:
            raise ValueError(f"layer_norm: pe {tuple(pe.shape)} {pe.dtype} on input "
                             f"{tuple(x.shape)}; expected a contiguous (f, c) bf16 or "
                             "float32 tensor on (b, f, s, c) input")
        pe_ptr, pe_code = pe.data_ptr(), build.DTYPE_CODES[pe.dtype]
        frames, positions = x.shape[1], x.shape[2]
    out = torch.empty_like(x)
    rows = x.numel() // c if c else 0
    if rows:
        err = build.library().aniportrait_layer_norm_fwd(
            x.data_ptr(), out.data_ptr(), weight.data_ptr(), bias.data_ptr(), code, rows, c,
            float(eps), pe_ptr, pe_code, frames, positions, build.stream_handle())
        build.check(err, "layer_norm")
        layer_norm.launches += 1
    return out


group_norm.launches = 0
layer_norm.launches = 0
