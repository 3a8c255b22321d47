"""Wrappers of the flash-attention CUDA kernels (``csrc/flash_attn.cu``,
``csrc/flash_attn_sm90.cu``, ``csrc/flash_attn_tf32x3_sm90.cu``,
``csrc/flash_bwd.cu``, ``csrc/flash_bwd_sm90.cu``) and their plain PyTorch
versions.

Five entry points, one per Pallas kernel they replace
(``aniportrait_tpu/ops/pallas_attention.py``); the first four share the
forward kernel:

* :func:`tok_flash_banked` (K1, ``_tok_flash_banked_impl``): token layout
  ``(B, S, C)`` attention over the row's own keys followed by a reference
  bank ``(B // rep, S_bank, C)`` that row ``r`` reads at bank row ``r // rep``.
* :func:`tok_flash` (K2, ``flash_attention_tokens_unshifted`` and its
  running-max fallback ``flash_attention_tokens``): token layout self
  attention, heads sliced from ``C``.
* :func:`flash_attention` (K4, ``_flash_nopad``): ``(B, S, H, D)`` attention;
  rows flagged in ``drop_tail`` ignore keys at or past ``kv_split``.
* :func:`flash_attention_fwd_lse` (K5a, ``_flash_fwd_impl``): K4 that also
  returns the float32 log-sum-exp ``(B, H, Sq)`` of every row and head.
* :func:`flash_attention_bwd` (K5b, ``_flash_bwd_kernels``): dq, dk, dv of
  K4's function from K5a's output and LSE.

The gradients reach these through ``ops/kernels/autograd.py``.

Three more entry points run the forward kernel in a fixed-shift softmax mode
(the token-kernel A/B, ``aniportrait_tpu_torch/scripts/bench_tok_kernel.py``),
each with its Pallas caller's overflow guard and the fallback to the running
max that the guard selects:

* :func:`tok_flash_noshift` (K7, ``flash_attention_tokens_noshift``);
* :func:`tok_flash_bounded` (K8, ``flash_attention_tokens_bounded``);
* :func:`tok_flash_unshifted` (K2u: K2's TPU form,
  ``flash_attention_tokens_unshifted``).

Each returns what :func:`tok_flash` returns and keeps the guard's int32 flag
(0: the fast path's output stands; 1: it tripped and the running-max result
replaced it) in ``.last_guard``.

The forward has three forms, chosen by dtype and head dim
(:func:`forward_form`): bf16 runs the tensor-core kernel
(``csrc/flash_attn_sm90.cu``: wgmma, TMA loads), float32 with d <= 128 the
tensor-core kernel in 3xTF32 (``csrc/flash_attn_tf32x3_sm90.cu``: mma.sync,
each operand split into two TF32 parts, three products; its arithmetic in
torch is :func:`plain_attention_tf32x3`), float32 above 128 the FMA kernel
(``csrc/flash_attn.cu``).  The backward has
two forms too (:func:`backward_form`): bf16 with d <= 128 runs the
tensor-core kernel (``csrc/flash_bwd_sm90.cu``: one kernel over key tiles,
dq summed into a float32 workspace by bulk reductions), float32 and bf16 above
128 the FMA kernels (``csrc/flash_bwd.cu``).  There is no retry on the
other form.

On a CPU tensor each wrapper returns its plain version; on a CUDA tensor it
launches the kernel or raises.  Each counts its launches in ``.launches``;
``tensor_core_launches`` counts the forward calls that took the bf16
tensor-core form, ``tf32x3_launches`` those that took the float32 one,
``tensor_core_bwd_launches`` the backward calls.
"""

from __future__ import annotations

import ctypes
import math

import torch

from aniportrait_tpu_torch.ops.kernels import build

MAX_HEAD_DIM = 256
BWD_WGMMA_MAX_HEAD_DIM = 128
TF32X3_MAX_HEAD_DIM = 128
LOG2E = math.log2(math.e)
tensor_core_launches = 0
tf32x3_launches = 0
tensor_core_bwd_launches = 0


def forward_form(dtype, d: int) -> str:
    """The form of the flash forward a CUDA call with operands of ``dtype``
    and head dim ``d`` takes: ``"wgmma"`` (bf16: tensor cores,
    ``csrc/flash_attn_sm90.cu``), ``"tf32x3"`` (float32 with d <= 128:
    tensor cores in 3xTF32, ``csrc/flash_attn_tf32x3_sm90.cu``) or ``"fma"``
    (float32 above 128: FMA units, ``csrc/flash_attn.cu``).  The C entry
    points choose the same way."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} unsupported (1 ... {MAX_HEAD_DIM})")
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "tf32x3" if d <= TF32X3_MAX_HEAD_DIM else "fma"
    raise TypeError(f"dtype {dtype} not supported (bf16 or float32)")


def backward_form(dtype, d: int) -> str:
    """The form of the flash backward a CUDA call with operands of ``dtype``
    and head dim ``d`` takes: ``"wgmma"`` (bf16 with d <= 128: tensor
    cores, ``csrc/flash_bwd_sm90.cu``) or ``"fma"`` (float32, and bf16 above
    128: FMA units, ``csrc/flash_bwd.cu``).  The C entry point chooses the
    same way."""
    forward_form(dtype, d)  # raises on what no form takes
    if dtype == torch.bfloat16 and d <= BWD_WGMMA_MAX_HEAD_DIM:
        return "wgmma"
    return "fma"


def wgmma_block_kv(d: int) -> int:
    """Keys per online-softmax step of the tensor-core form at head dim
    ``d`` (``Tile<DP>::BKV`` in ``csrc/flash_attn_sm90.cu``): the tile
    :func:`plain_attention_tiled` takes to round as that kernel does: 128
    up to a head tile (d rounded up to 16) of 80, 64 above, where two tiles
    of 128 keys and O no longer share the registers."""
    return 128 if d <= 80 else 64


def wgmma_shape(d: int) -> dict:
    """The block the bf16 tensor-core forward launches at head dim ``d``,
    as its source reports it without launching: ``dp`` (the head tile),
    ``block_kv``, ``stages`` (of the K/V ring), ``smem_bytes``, ``threads``
    and ``blocks_per_sm`` (CUDA's occupancy API: registers and shared
    memory).  Builds the kernels; needs the card."""
    shape = (ctypes.c_int * 6)()
    build.check(build.library().aniportrait_flash_sm90_shape(d, shape), "wgmma_shape")
    keys = ("dp", "block_kv", "stages", "smem_bytes", "threads", "blocks_per_sm")
    return dict(zip(keys, shape))


def tf32x3_block_kv(d: int) -> int:
    """Keys per online-softmax step of the float32 tensor-core form at head
    dim ``d`` (``Tf32Tile<DP>::BKV`` in ``csrc/flash_attn_tf32x3_sm90.cu``:
    64 up to the 64-column head tile, 32 above): the tile
    :func:`plain_attention_tf32x3` takes to sum as that kernel does.
    ``tests/test_torch_cuda.py`` holds it to :func:`tf32x3_shape`."""
    return 64 if d <= 64 else 32


def tf32x3_shape(d: int, mode: int = 0, lse: bool = False) -> dict:
    """The block the float32 tensor-core form launches at head dim ``d`` in
    softmax ``mode`` (0: running max, with the LSE where ``lse``), as its
    source reports it without launching: ``dp`` (the head tile),
    ``block_kv``, ``threads``, ``smem_bytes`` (dynamic shared memory) and
    ``blocks_per_sm`` (CUDA's occupancy API: registers and shared memory).
    Builds the kernels; needs the card."""
    shape = (ctypes.c_int * 5)()
    build.check(build.library().aniportrait_flash_tf32x3_shape(d, mode, int(lse), shape),
                "tf32x3_shape")
    return dict(zip(("dp", "block_kv", "threads", "smem_bytes", "blocks_per_sm"), shape))


def _count_form(q, d):
    global tensor_core_launches, tf32x3_launches
    form = forward_form(q.dtype, d)
    if form == "wgmma":
        tensor_core_launches += 1
    elif form == "tf32x3":
        tf32x3_launches += 1


# ------------------------------------------------------------ plain versions
def _logits(q, k, drop_tail, kv_split):
    """float32 ``(B, H, Sq, Skv)`` logits ``q k^T / sqrt(d)``; keys at or past
    ``kv_split`` are -inf for the rows flagged in ``drop_tail``."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
    if drop_tail is not None:
        cols = torch.arange(k.shape[1], device=q.device) >= kv_split
        mask = drop_tail.to(device=q.device, dtype=torch.bool)[:, None, None, None] & cols
        logits = logits.masked_fill(mask, float("-inf"))
    return logits


def plain_attention_bshd(q, k, v, drop_tail=None, kv_split=None):
    """Reference math of the forward entry points: explicit einsum and a
    float32 softmax over ``(B, S, H, D)`` operands, optional drop mask."""
    probs = torch.softmax(_logits(q, k, drop_tail, kv_split), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def plain_attention_fwd_lse(q, k, v, drop_tail=None, kv_split=None):
    """K5a's function: ``(out, lse)`` with ``lse`` float32 ``(B, H, Sq)``; a
    fully masked row gets output 0 and LSE 0 (the TPU kernel's contract)."""
    logits = _logits(q, k, drop_tail, kv_split)
    lse = torch.logsumexp(logits, dim=-1)
    lse = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    probs = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)
    return out, lse


def plain_attention_tiled(q, k, v, block_kv, drop_tail=None, kv_split=None):
    """The tensor-core forward's rounding contract, step by step: the online
    softmax over KV tiles of ``block_kv`` keys in the order of the Pallas
    body (``pallas_attention.py:79-97``): logits = (q k^T in float32) x
    scale, running max and sum in float32, l summing the unrounded p, and p
    rounded to v's dtype before the PV product.  ``(B, S, H, D)`` operands;
    masked logits are -1e30 as in the Pallas kernel.  Nothing on the main
    path calls it."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((b, h, sq, 1), -1e30, device=q.device)
    l = torch.zeros((b, h, sq, 1), device=q.device)
    acc = torch.zeros((b, h, sq, d), device=q.device)
    for k0 in range(0, skv, block_kv):
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, k0:k0 + block_kv]) * d ** -0.5
        if drop_tail is not None:
            cols = torch.arange(k0, k0 + logits.shape[-1], device=q.device) >= kv_split
            mask = drop_tail.to(device=q.device, dtype=torch.bool)[:, None, None, None] & cols
            logits = logits.masked_fill(mask, -1e30)
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), vf[:, k0:k0 + block_kv])
        acc = acc * alpha + pv
        m = m_new
    out = acc / torch.where(l == 0, torch.ones_like(l), l)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def round_tf32(x):
    """``cvt.rna.tf32.f32`` in torch bit operations: float32 ``x`` rounded
    to TF32's 10 stored significand bits, to nearest with ties away from
    zero.  The magnitude's bit pattern gets half the weight of the 13 bits
    dropped (0x1000) added, then those bits are cleared; a carry moves into
    the exponent, so subnormals round on the same grid and a value past the
    largest TF32 number (the largest finite float32 among them) becomes Inf,
    as IEEE rounding overflows.  Inf and NaN pass through unchanged, as cvt
    passes them (a NaN stays a NaN; its payload is not a contract).
    Returns float32 with the low 13 bits of every finite value zero.  The
    kernel rounds the same way by the same add, leaving the low bits for the
    tensor cores to ignore."""
    if x.dtype != torch.float32:
        raise TypeError(f"round_tf32: float32 only, got {x.dtype}")
    bits = x.view(torch.int32)
    # on the int32 view the sign bit stays out of the sum: a finite
    # magnitude is at most 0x7f7fffff, so + 0x1000 cannot reach bit 31
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def split_tf32(x):
    """``(big, small)`` as the kernel splits a float32 operand: ``big =
    round_tf32(x)``, ``small = x - big`` (exact in float32) truncated to
    TF32, as the tensor cores read it (its low 13 bits cleared); ``|x - big
    - small| < 2^-21 |x|`` for normal ``x``.  An Inf or NaN ``x`` is its own
    ``big`` here (the kernel's add may turn a NaN's into any value) and has
    a NaN ``small`` in both, so every product it enters is NaN."""
    big = round_tf32(x)
    r = x - big
    truncated = (r.view(torch.int32) & -0x2000).view(torch.float32)
    return big, torch.where(torch.isfinite(r), truncated, r)


def _product_tf32(a, b, eq, terms):
    """einsum ``eq`` of float32 ``a`` and ``b`` as the tensor cores take it:
    ``terms=3``: small*big + big*small, then + big*big (each product of two
    TF32 values is exact in float32, the sums round); ``terms=1``: big*big
    alone, one TF32 product."""
    ab, as_ = split_tf32(a)
    bb, bs = split_tf32(b)
    if terms == 1:
        return torch.einsum(eq, ab, bb)
    if terms != 3:
        raise ValueError(f"terms must be 1 or 3, got {terms}")
    return (torch.einsum(eq, as_, bb) + torch.einsum(eq, ab, bs)) + torch.einsum(eq, ab, bb)


def plain_attention_tf32x3(q, k, v, drop_tail=None, kv_split=None, *, terms=3):
    """The float32 tensor-core forward's arithmetic
    (``csrc/flash_attn_tf32x3_sm90.cu``), step by step in its order, on
    float32 ``(B, S, H, D)`` operands: q times ``scale * log2(e)`` (both
    rounded to float32 first, as the C entry point takes them), logits
    q k^T in base 2 as :func:`_product_tf32` sums them, the online softmax
    over tiles of ``tf32x3_block_kv(d)`` keys (running max, ``exp2``,
    l summing the unrounded p), p split for the PV product the same way,
    output ``acc / l`` (0 where ``l`` is 0).  Keys at or past ``kv_split``
    are -inf for the rows flagged in ``drop_tail``.  ``terms=1`` takes one
    TF32 product (big*big) in both products instead of three.  The sums
    inside each product run in torch's order, not the tensor cores'.
    Nothing on the main path calls it."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    bkv = tf32x3_block_kv(d)
    scale = torch.tensor(d ** -0.5, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    qs = q.float() * scale.to(q.device)
    kf, vf = k.float(), v.float()
    m = torch.full((b, h, sq, 1), float("-inf"), device=q.device)
    l = torch.zeros((b, h, sq, 1), device=q.device)
    acc = torch.zeros((b, h, sq, d), device=q.device)
    for k0 in range(0, skv, bkv):
        s = _product_tf32(qs, kf[:, k0:k0 + bkv], "bqhd,bkhd->bhqk", terms)
        if drop_tail is not None:
            cols = torch.arange(k0, k0 + s.shape[-1], device=q.device) >= kv_split
            mask = drop_tail.to(device=q.device, dtype=torch.bool)[:, None, None, None] & cols
            s = s.masked_fill(mask, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))  # finite: key 0 is seen
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _product_tf32(p, vf[:, k0:k0 + bkv], "bhqk,bkhd->bhqd", terms)
        m = m_new
    out = acc * torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
    return out.permute(0, 2, 1, 3).to(q.dtype)


def plain_attention_bwd(q, k, v, out, lse, do, drop_tail=None, kv_split=None):
    """K5b's function, step by step as the kernels compute it: ``(dq, dk,
    dv)`` in q's dtype.  ``p`` and ``ds`` are rounded to the operand dtype
    before the products that take them, as the TPU kernels round them."""
    dtype = q.dtype
    scale = q.shape[-1] ** -0.5
    do = do.to(dtype).float()
    delta = (do * out.float()).sum(-1).permute(0, 2, 1)  # (B, H, Sq)
    p = torch.exp(_logits(q, k, drop_tail, kv_split) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float())
    ds = p * (dp - delta[..., None]) * scale
    p, ds = p.to(dtype).float(), ds.to(dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def _heads(x, heads):
    b, s, c = x.shape
    return x.reshape(b, s, heads, c // heads)


def plain_tok_flash(q, k, v, heads):
    b, sq, c = q.shape
    out = plain_attention_bshd(_heads(q, heads), _heads(k, heads), _heads(v, heads))
    return out.reshape(b, sq, c)


def plain_tok_flash_banked(q, k, v, kb, vb, heads, rep):
    kc = torch.cat([k, kb.repeat_interleave(rep, dim=0)], dim=1)
    vc = torch.cat([v, vb.repeat_interleave(rep, dim=0)], dim=1)
    return plain_tok_flash(q, kc, vc, heads)


# Softmax modes of the forward kernel (csrc/flash_attn.cu)
NOSHIFT_E, BOUNDED_2, UNSHIFTED_2 = 1, 2, 3
GUARD_MIN_L = 1e-30  # the Pallas callers' least softmax denominator


def scaled_in_dtype(x, scale: float):
    """``x * scale`` in x's dtype, the scale rounded to it first (JAX's
    ``x * jnp.asarray(scale, x.dtype)``)."""
    return x * torch.tensor(scale, dtype=x.dtype, device=x.device)


def cauchy_schwarz_bound(q, k, heads: int, scale: float = 1.0):
    """K8's per-(batch, row, head) logit bound ``scale * |q_h| * max_kv
    |k_h|``, float32 ``(B, Sq, heads)`` (``_bounds_cauchy_schwarz``, without
    the TPU's 128-lane padding).  Torch reductions, as it is XLA outside the
    Pallas call."""
    b, sq, c = q.shape
    d = c // heads
    qn2 = q.float().square().reshape(b, sq, heads, d).sum(-1)
    kn = k.float().square().reshape(b, -1, heads, d).sum(-1).amax(1).sqrt()
    return (scale * qn2.sqrt() * kn[:, None, :]).contiguous()


def _fixed_shift(q, k, v, heads, mode, bound=None):
    """The fast path of one fixed-shift mode, step by step as its Pallas
    body computes it; ``q`` arrives scaled as the mode reads it.  Returns
    ``(out, bad)``: out in q's dtype and the guard's verdict."""
    b, sq, c = q.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", _heads(q, heads).float(),
                          _heads(k, heads).float())
    if mode == NOSHIFT_E:
        p = torch.exp(logits).to(v.dtype).float()  # l sums the rounded p
        l = p.sum(-1)
    else:
        if mode == BOUNDED_2:
            logits = logits - bound.permute(0, 2, 1)[..., None]
        p = torch.exp2(logits)
        l = p.sum(-1)  # the unrounded p
        p = p.to(v.dtype).float()
    safe = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bkhd->bqhd", p, _heads(v, heads).float())
    out = out / safe.permute(0, 2, 1)[..., None]
    stored = out.to(q.dtype)
    bad = ~(l > GUARD_MIN_L)
    if mode != BOUNDED_2:
        # K7 tests the stored output, K2 the float32 one
        checked = stored.float() if mode == NOSHIFT_E else out
        bad = bad | ~torch.isfinite(l) | ~torch.isfinite(checked).all(-1).permute(0, 2, 1)
    return stored.reshape(b, sq, c), bool(bad.any())


def _guarded(q, k, v, heads, out, bad):
    """The Pallas callers' ``lax.cond``: the running-max result where the
    guard tripped.  Returns ``(out, flag)``, flag an int32 ``(1,)``."""
    flag = torch.tensor([int(bad)], dtype=torch.int32, device=q.device)
    return (plain_tok_flash(q, k, v, heads) if bad else out), flag


def plain_tok_flash_noshift(q, k, v, heads):
    """K7: q times 1/sqrt(d) in its dtype, ``p = exp(logit)`` unshifted and
    rounded to v's dtype, ``l`` the sum of the rounded p, out ``acc / l``.
    Returns ``(out, flag)``."""
    d = q.shape[-1] // heads
    qs = scaled_in_dtype(q, 1.0 / math.sqrt(d))
    return _guarded(q, k, v, heads, *_fixed_shift(qs, k, v, heads, NOSHIFT_E))


def plain_tok_flash_bounded(q, k, v, heads):
    """K8: q times log2(e)/sqrt(d) in its dtype, ``p = exp2(logit -
    bound)`` with the Cauchy-Schwarz bound, ``l`` the sum of the unrounded
    p.  Returns ``(out, flag)``."""
    d = q.shape[-1] // heads
    qs = scaled_in_dtype(q, math.log2(math.e) / math.sqrt(d))
    bound = cauchy_schwarz_bound(qs, k, heads)
    return _guarded(q, k, v, heads, *_fixed_shift(qs, k, v, heads, BOUNDED_2, bound))


def plain_tok_flash_unshifted(q, k, v, heads):
    """K2's TPU form: q times log2(e)/sqrt(d) in its dtype, ``p =
    exp2(logit)`` unshifted, ``l`` the sum of the unrounded p.  Returns
    ``(out, flag)``."""
    d = q.shape[-1] // heads
    qs = scaled_in_dtype(q, math.log2(math.e) / math.sqrt(d))
    return _guarded(q, k, v, heads, *_fixed_shift(qs, k, v, heads, UNSHIFTED_2))


# ------------------------------------------------------------------ checks
def check_operands(name, tensors, head_dim):
    """Raise unless the operands are what the CUDA kernel takes."""
    dtype, device = tensors[0].dtype, tensors[0].device
    if not tensors[0].is_cuda:
        raise RuntimeError(f"{name}: tensor on {device}, expected CPU or CUDA")
    if dtype not in build.DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} not supported (bf16 or float32)")
    for t in tensors:
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"{name}: operands must share device and dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if not 1 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {head_dim} unsupported (1 ... 256)")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(name, q, k, v, kb, vb, drop, out, batch, sq, skv, sbank, heads,
            d, rep, kv_split, lse=None):
    err = build.library().aniportrait_flash_fwd(
        build.DTYPE_CODES[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(kb),
        _ptr(vb), _ptr(drop), _ptr(out), _ptr(lse), batch, sq, skv, sbank,
        heads, d, rep, kv_split, float(d) ** -0.5, build.stream_handle(),
    )
    build.check(err, name)
    _count_form(q, d)


def _check_bshd(name, q, k, v, drop_tail, kv_split):
    """Shape checks of the ``(B, S, H, D)`` entries; returns the kernel's
    int32 drop flags (or None)."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if k.shape != (b, skv, h, d) or v.shape != k.shape:
        raise ValueError(f"{name}: shapes {q.shape} {k.shape} {v.shape}")
    check_operands(name, (q, k, v), d)
    if drop_tail is None:
        return None
    if kv_split is None or not 1 <= kv_split <= skv or drop_tail.shape != (b,):
        raise ValueError(f"{name}: drop_tail needs 1 <= kv_split <= Skv")
    return drop_tail.to(device=q.device, dtype=torch.int32).contiguous()


# ---------------------------------------------------------------- wrappers
def tok_flash(q, k, v, heads: int):
    """K2: softmax(q k^T / sqrt(d)) v per head over token layout tensors.
    q: (B, Sq, C), k/v: (B, Skv, C), C = heads * d.  Returns (B, Sq, C)."""
    if q.device.type == "cpu":
        return plain_tok_flash(q, k, v, heads)
    _check_tok("tok_flash", q, k, v, heads)
    b, sq, c = q.shape
    skv = k.shape[1]
    out = torch.empty_like(q)
    _launch("tok_flash", q, k, v, None, None, None, out, b, sq, skv, 0,
            heads, c // heads, 1, 0)
    tok_flash.launches += 1
    return out


def _check_tok(name, q, k, v, heads):
    b, sq, c = q.shape
    skv = k.shape[1]
    if c % heads or k.shape != (b, skv, c) or v.shape != k.shape:
        raise ValueError(f"{name}: shapes {q.shape} {k.shape} {v.shape}")
    check_operands(name, (q, k, v), c // heads)


def _tok_mode(name, mode, q, k, v, heads, qs, bound, q_scale):
    """One fixed-shift launch and its predicated running-max fallback;
    returns ``(out, flag)``."""
    b, sq, c = q.shape
    d = c // heads
    out = torch.empty_like(q)
    flag = torch.zeros(1, dtype=torch.int32, device=q.device)
    err = build.library().aniportrait_tok_flash_fwd(
        build.DTYPE_CODES[q.dtype], mode, _ptr(q), _ptr(qs), _ptr(k), _ptr(v),
        _ptr(bound), _ptr(out), _ptr(flag), b, sq, k.shape[1], heads, d,
        float(d) ** -0.5, q_scale, build.stream_handle(),
    )
    build.check(err, name)
    _count_form(q, d)
    return out, flag


def tok_flash_noshift(q, k, v, heads: int):
    """K7: :func:`tok_flash`'s function through the no-shift base-e
    softmax, guarded.  q/k/v: (B, S, C); returns (B, Sq, C)."""
    if q.device.type == "cpu":
        out, tok_flash_noshift.last_guard = plain_tok_flash_noshift(q, k, v, heads)
        return out
    _check_tok("tok_flash_noshift", q, k, v, heads)
    qs = scaled_in_dtype(q, 1.0 / math.sqrt(q.shape[-1] // heads))
    out, tok_flash_noshift.last_guard = _tok_mode(
        "tok_flash_noshift", NOSHIFT_E, q, k, v, heads, qs, None, 1.0)
    tok_flash_noshift.launches += 1
    return out


def tok_flash_bounded(q, k, v, heads: int):
    """K8: :func:`tok_flash`'s function through the base-2 softmax shifted
    by the Cauchy-Schwarz bound (torch reductions here), guarded."""
    if q.device.type == "cpu":
        out, tok_flash_bounded.last_guard = plain_tok_flash_bounded(q, k, v, heads)
        return out
    _check_tok("tok_flash_bounded", q, k, v, heads)
    qs = scaled_in_dtype(q, math.log2(math.e) / math.sqrt(q.shape[-1] // heads))
    bound = cauchy_schwarz_bound(qs, k, heads)
    out, tok_flash_bounded.last_guard = _tok_mode(
        "tok_flash_bounded", BOUNDED_2, q, k, v, heads, qs, bound, 1.0)
    tok_flash_bounded.launches += 1
    return out


def tok_flash_unshifted(q, k, v, heads: int):
    """K2u, K2's TPU form: :func:`tok_flash`'s function through the
    unshifted base-2 softmax (q scaled in the kernel), guarded."""
    if q.device.type == "cpu":
        out, tok_flash_unshifted.last_guard = plain_tok_flash_unshifted(q, k, v, heads)
        return out
    _check_tok("tok_flash_unshifted", q, k, v, heads)
    scale2 = math.log2(math.e) / math.sqrt(q.shape[-1] // heads)
    q_scale = torch.tensor(scale2, dtype=q.dtype).item()  # rounded as in JAX
    out, tok_flash_unshifted.last_guard = _tok_mode(
        "tok_flash_unshifted", UNSHIFTED_2, q, k, v, heads, q, None, q_scale)
    tok_flash_unshifted.launches += 1
    return out


def tok_flash_banked(q, k, v, kb, vb, heads: int, rep: int):
    """K1: attention of q over ``[k | repeat(kb, rep)]`` without building the
    concat.  q/k/v: (B, S, C); kb/vb: (B // rep, S_bank, C)."""
    if q.device.type == "cpu":
        return plain_tok_flash_banked(q, k, v, kb, vb, heads, rep)
    b, sq, c = q.shape
    skv, sbank = k.shape[1], kb.shape[1]
    if (c % heads or k.shape != (b, skv, c) or v.shape != k.shape
            or kb.shape != (b // rep, sbank, c) or vb.shape != kb.shape
            or kb.shape[0] * rep != b):
        raise ValueError(
            f"tok_flash_banked: shapes q {q.shape} k {k.shape} kb {kb.shape} "
            f"rep {rep}"
        )
    check_operands("tok_flash_banked", (q, k, v, kb, vb), c // heads)
    out = torch.empty_like(q)
    _launch("tok_flash_banked", q, k, v, kb, vb, None, out, b, sq, skv,
            sbank, heads, c // heads, rep, 0)
    tok_flash_banked.launches += 1
    return out


def flash_attention(q, k, v, drop_tail=None, kv_split=None):
    """K4: (B, Sq, H, D) attention over (B, Skv, H, D) keys/values; rows with
    ``drop_tail`` set attend to keys ``[0, kv_split)`` only."""
    if q.device.type == "cpu":
        return plain_attention_bshd(q, k, v, drop_tail, kv_split)
    drop = _check_bshd("flash_attention", q, k, v, drop_tail, kv_split)
    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    _launch("flash_attention", q, k, v, None, None, drop, out, b, sq,
            k.shape[1], 0, h, d, 1, kv_split or 0)
    flash_attention.launches += 1
    return out


def flash_attention_fwd_lse(q, k, v, drop_tail=None, kv_split=None):
    """K5a: :func:`flash_attention` that also returns the float32
    log-sum-exp ``(B, H, Sq)`` of the scaled logits, the backward's
    residual.  Returns ``(out, lse)``."""
    if q.device.type == "cpu":
        return plain_attention_fwd_lse(q, k, v, drop_tail, kv_split)
    drop = _check_bshd("flash_attention_fwd_lse", q, k, v, drop_tail, kv_split)
    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
    _launch("flash_attention_fwd_lse", q, k, v, None, None, drop, out, b, sq,
            k.shape[1], 0, h, d, 1, kv_split or 0, lse)
    flash_attention_fwd_lse.launches += 1
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, do, drop_tail=None, kv_split=None):
    """K5b: gradients ``(dq, dk, dv)`` of :func:`flash_attention` at
    ``(q, k, v)`` for the output gradient ``do``, from K5a's ``out`` and
    ``lse``.  ``delta = rowsum(do * out)`` is a torch reduction here, as it
    is XLA outside the kernels on the TPU."""
    if q.device.type == "cpu":
        return plain_attention_bwd(q, k, v, out, lse, do, drop_tail, kv_split)
    drop = _check_bshd("flash_attention_bwd", q, k, v, drop_tail, kv_split)
    b, sq, h, d = q.shape
    do, out = do.to(q.dtype).contiguous(), out.contiguous()
    if out.shape != q.shape or do.shape != q.shape or lse.shape != (b, h, sq):
        raise ValueError(
            f"flash_attention_bwd: out {out.shape} do {do.shape} lse {lse.shape}"
        )
    check_operands("flash_attention_bwd", (q, out, do), d)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("flash_attention_bwd: lse must be contiguous float32")
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    wgmma = backward_form(q.dtype, d) == "wgmma"
    # the tensor-core form sums dq's partials into a float32 workspace whose
    # rows are the head tile DP = round_up(d, 16)
    ws = (torch.zeros((b, h, sq, (d + 15) // 16 * 16), device=q.device,
                      dtype=torch.float32) if wgmma else None)
    err = build.library().aniportrait_flash_bwd(
        build.DTYPE_CODES[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(do),
        _ptr(lse), _ptr(delta), _ptr(drop), _ptr(dq), _ptr(dk), _ptr(dv),
        _ptr(ws), b, sq, k.shape[1], h, d, kv_split or 0, float(d) ** -0.5,
        build.stream_handle(),
    )
    build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    if wgmma:
        global tensor_core_bwd_launches
        tensor_core_bwd_launches += 1
    return dq, dk, dv


tok_flash.launches = 0
tok_flash_banked.launches = 0
flash_attention.launches = 0
flash_attention_fwd_lse.launches = 0
flash_attention_bwd.launches = 0
for _fn in (tok_flash_noshift, tok_flash_bounded, tok_flash_unshifted):
    _fn.launches = 0
    _fn.last_guard = None
