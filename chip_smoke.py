#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``aniportrait_tpu_torch``) on one GPU.

    python3 chip_smoke.py                    # all phases (what CI runs)
    python3 chip_smoke.py --phase kernels    # only the kernel phase
    python3 chip_smoke.py --phase long-clip  # kernels, references, long clips
    python3 chip_smoke.py --phase train      # only the training phases (stages 1 and 2)
    python3 chip_smoke.py --phase tok-ab     # guards, token-kernel A/B, K9 path
    python3 chip_smoke.py --phase entry      # the loader, pose2vid CLI and bench entries
    python3 chip_smoke.py --phase audio      # the audio-driven path and its serving core
    python3 chip_smoke.py --phase quality    # LPIPS, FiLM, -acc bench, weight validation, gates
    python3 chip_smoke.py --phase multi      # sharded sampler, data-parallel training, 2 ranks

Phases, each of which fails the run (nonzero exit) on any error:

1. kernels: build the CUDA kernels from ``aniportrait_tpu_torch/csrc`` and
   hold each of K1-K9 (and K2u, K2's TPU form) against its plain PyTorch
   version at the main paths' widths, in bf16 and float32, with the
   tolerances below; time the kernel, the plain version and the one PyTorch
   call that computes the same function (``F.scaled_dot_product_attention``,
   forward and backward for K5b), and compute the card's bound for the same
   work.  The guards of K7, K8 and K2u must hold on these random inputs.
   The flash forward (K1, K2, K2u, K4, K5a, K7, K8) has three forms: every
   bf16 case must run the tensor-core kernel (``flash_attn_sm90.cu``, its
   launch counter moves), every float32 case at d <= 128 the 3xTF32
   tensor-core kernel (``flash_attn_tf32x3_sm90.cu``, its own counter
   moves) and float32 above 128 the FMA kernel; each bf16 case also prints
   its error against ``flash.plain_attention_tiled``, the tensor-core
   kernel's rounding contract, each 3xTF32 case against
   ``flash.plain_attention_tf32x3`` (its arithmetic, on the first batch
   row's first 256 queries) and both bounds (3xTF32 and FMA), and each
   float32 flash case the library call's own error against the plain
   version.  The flash backward (K5b) and the
   temporal kernel (K3) have two forms too: bf16 must run the tensor-core
   kernel (``flash_bwd_sm90.cu``, ``temporal_attn_sm90.cu``; their counters
   move) and float32 the FMA kernel; bf16 K3 is held to the Pallas rounding
   contract (``temporal.plain_nat_temporal_rounded``) and also prints its
   error against the exact softmax.  So do the short-sequence kernels K6 and
   K9: bf16 must run ``small_seq_attn_sm90.cu`` (mma.sync) and float32 the
   FMA kernel.  The build's time and the tensor-core kernels' registers,
   spills and shared memory per instantiation are printed (the 3xTF32
   forward's with the blocks an SM they allow); the backward, the 3xTF32
   forward and the short-sequence kernels (K3, K6, K9) must not spill.
   The normalisation kernels N1 (GroupNorm, the SiLU fused, per frame and
   pooled) and N2 (LayerNorm, the positional encoding fused), bf16 only,
   run at the shapes of ``NORM_GROUP_SHAPES`` and ``NORM_LAYER_SHAPES``
   against their plain versions (the float32 composition), with ATen's
   norm on the bf16 tensor as the library call.
2. reference: the micro model through the pipeline on the GPU (kernels) and
   on the CPU (plain versions) from the same weights and latents, float32,
   2 steps: at 256 px, 8 frames, exact windowed sampler; and at 112x80 px
   (a 14x10 latent that K3 cannot pack), 12 frames, window fusion over the
   8/2 context table (one window wraps around), encoder cache 2.  The final
   latents must agree; K1-K3, and K6 in the second run, must launch.
3. pipeline: the full-size model (random bf16 weights from a seed) through
   ``Pose2VideoPipeline`` at 512x512, 16 frames, 25 DDIM steps, CFG 3.5:
   two requests with different inputs and seeds.  K1-K4 must have launched
   during this phase as often as ``attention_reckoning`` counts from the
   models, N1 and N2 as ``norm_reckoning`` counts, and the tensor-core
   flash forward and temporal kernel.
4. long clips: the same model at 576x768 (a 72x96 latent whose 9x12 level
   K3 cannot pack), 28 frames, 25 steps, CFG 3.5, each request through
   ``run_cases`` on its own pipeline over one set of modules: A, the exact
   windowed path (context 16, overlap 4, window batch 3); B, window fusion
   over the same table with the encoder cache at 2 and latent
   interpolation x2 (55 frames out).  K1-K4, K6 and the tensor-core flash
   forward must launch in A, and K6 in B as often as the model's structure
   and the cache schedule say, every one of them on the tensor cores.
5. training reference: one stage-1 step of the micro model at 256 px,
   float32, on the GPU (kernels) and on the CPU (plain versions) from the
   same weights, batch and random draws; the loss and every trainable
   gradient must agree, and K5a and K5b must have launched.
6. training: the stage-1 trainer at SD-1.5 widths (random weights from seed
   0), 512x512, train_bs 2, bf16 compute, float32 AdamW, on seeded random
   batches for six steps, the last one profiled.  Losses must be finite,
   trained weights move, frozen ones (ReferenceNet up_blocks.3, VAE, CLIP)
   stay bit for bit, the PoseGuider's running statistics change, and K2,
   K5a, K5b and the tensor-core flash forward and backward must have
   launched during the trainer's steps.
7. token-kernel A/B (``tok-ab``): the guards of K7, K8 and K2u on the
   crafted inputs of tests/test_pallas_attention.py (set exactly where the
   JAX guard falls back, and then the output is the running max's); the A/B
   entry ``aniportrait_tpu_torch.scripts.bench_tok_kernel.run`` at its four
   full shapes, where every guard must hold and every variant meet
   ``runmax`` within the bf16 tolerance, and K7, K8, K2u must launch; then
   the head-folded short-sequence path (``small_seq_attention_folded``, K9)
   forward (K9 on the tensor cores) and backward at the 512x512 request's
   top-level motion-module width, against the library forward, and its
   float32 gradients on the card against the CPU's at a cut batch.
8. entry points (``entry``, run after the pipeline phase): ``load_pipeline``
   (``aniportrait_tpu_torch/scripts/loader.py``) from the settings of
   configs/prompts/animation.yaml and configs/inference/inference_v2.yaml
   (``ENTRY_CONFIG``), random weights, full size, bf16; the pose2vid CLI's
   ``generate`` at 512x512, 16 frames, 25 steps, CFG 3.5 on a seeded
   reference image and the pose maps of tests/fixtures/landmark_golden.npz:
   the grid the CLI would write must have its shape, finite results, and
   K1-K4 must launch exactly as ``attention_reckoning`` counts from the
   models; the bench entry (``aniportrait_tpu_torch/scripts/bench.py``) in
   its own process at its default config and at ``vid2vid24``, each printing
   one JSON line; and the loader's weight path: tiny bf16 models written as
   the reference's files (``write_checkpoints``) and read back onto the card
   bit for bit.
9. audio (``audio``, run after the entry points): K4 at wav2vec2-base's
   self-attention (B=1, 12 heads, d=64, 1024 and 1800 frames) in float32
   (the 3xTF32 form the audio models take) and bf16, held to its plain version
   and timed as in phase 1; Audio2Mesh and Audio2Pose at full size (random
   weights from seed 0), float32 with TF32 off, on the card against the CPU
   on a 2.5-s seeded WAV read back through ``prepare_audio_feature``
   (``AUDIO_REL_TOL``); a 40-s clip through Audio2Mesh, where K4 must
   launch exactly once per encoder layer (12), all on the 3xTF32 form, on
   the card against the CPU;
   ``generate_head_pose`` on a 10.0-s clip, timed; one serving request
   through ``serving_core.animate`` with the models of
   ``load_serving_models`` (``AUDIO_CONFIG``, random weights, full size):
   48 frames at 512x512, 25 steps, CFG 3.5, bf16, on the fixture's pose maps
   (the card cannot draw), K1-K4 held to ``attention_reckoning`` over the
   window table; the bench in its own process at ``audio2mesh`` and
   ``audio2vid --pose-maps fixture``; and tiny audio models written as the
   reference's ``.pt`` files (weight norm un-merged, packed in_proj) and
   read back onto the card bit for bit.

10. stage 2 (``train2``, run after the stage-1 training phases and in
   ``--phase train``): one stage-2 step of the micro model at 256 px, 8
   frames, float32, gradient checkpointing on, on the card against the CPU
   from the same weights, batch and draws (the loss and every motion-module
   gradient; K2-K5b launched as ``stage2_reckoning`` counts); then the
   stage-2 trainer of configs/train/stage2.yaml at SD-1.5 widths with the
   motion modules of inference_v2.yaml (random weights from seed 0),
   512x512, 16 frames, train_bs 1, bf16 compute with the frozen weights in
   bf16, gradient checkpointing, float32 AdamW over the motion modules, on
   seeded random batches: TRAIN2_STEPS steps and a profiled one (step
   seconds, peak memory, idle share, device time by family with K3's plain
   backward apart).  Losses must be finite, every motion-module tensor
   move, every frozen weight stay bit for bit, and K2, K3, K4, K5a and K5b
   launch exactly as ``stage2_reckoning`` counts (checkpointing runs K3 and
   K5a twice); then two steps with 8-bit AdamW, whose state bytes are
   printed against float32 AdamW's.  The kernel phase times K5a and K5b at
   this path's 16 rows (``K5a.stage2``, ``K5b.stage2``).
11. quality (``quality``, run after the audio phase): LPIPS (random float32
   weights from a seed) on the card against the CPU on 8 frames at 512 px
   (``LPIPS_REL_TOL``, TF32 off), timed; FiLM at full width in float32 on
   the card against the CPU on one 128x128 pair (``FILM_TOL`` of the largest
   output, TF32 off), and in bf16 at 512x512, batch 4: ms a midpoint frame
   and peak memory; the bench at ``audio2vid_acc --pose-maps fixture`` in its
   own process (16 of 48 frames diffused, FiLM fills 46); full-size
   checkpoint files written as the entry phase writes them, with the audio
   checkpoints and a traced random FiLM blob, through
   ``scripts/validate_weights.py`` (0), and with one key dropped (1, naming
   it); and ``scripts/quality_speed_gate.py --check`` at full size (25
   steps, 16 and 24 frames): the approximations' PSNR / SSIM against the
   exact path, held to ``docs/quality_gate*.json``, and ``compare_videos``
   (LPIPS on the card) on its exact and encoder-cache clips.
12. multi (``multi``, run last): the port's ``parallel`` paths at
   ``MULTI_RANKS`` ranks, which share the one card over gloo (NCCL refuses
   two ranks on one device; gloo moves card tensors through the host), or
   run over NCCL with a card each where there are enough, spawned by
   ``parallel.launch.spawn`` after this process has built the kernels,
   each rank's work held to this process's single-process run of the same
   work: micro float32 samplers (exact windowed and fused, 256 px) within
   ``MULTI_MICRO_ATOL``; (a) long clip A's exact windowed path and (b) the
   bench's default config's whole-clip path with the CFG halves split, full size,
   bf16, ``MULTI_STEPS`` steps: the frames' PSNR at least ``MULTI_PSNR_DB``,
   every rank returning the same video, and each rank's K3 and K6 launches
   as the model reckons them for its share; the full-width motion module's
   all-to-all (frames to positions) against the unsharded module, float32
   and bf16, K3 on half the positions a rank; (c) the data-parallel stage-1
   trainer at full width, train_bs 2 (one row a rank), bf16 compute,
   ``MULTI_STEPS`` steps with float32 AdamW under ZeRO-1 and as many with
   8-bit AdamW: step-1 loss against the single-process train_bs 2 step
   (``MULTI_LOSS_RTOL``) and its gradient norm before the clip
   (``MULTI_GRAD_NORM_RTOL``), optimizer state per rank about half the
   total, peak memory per rank, the full-size float32 ZeRO-1 state gathered
   to rank 0 as a checkpoint takes it (seconds, peak memory, every owner's
   bytes), and a micro float32 data-parallel step on the card against the
   single process on the card (the averaged gradients within
   ``MULTI_GRAD_RTOL`` of the largest, the norm before the clip, each
   clear-gradient weight's move) and on the CPU (loss and weights); the
   collectives' GB/s, over gloo beside the same with pinned host staging
   done in the script.  A failure in any rank fails the phase.  The ranks' times are printed with the card's name and power
   limit; where they share one card, they are no scaling numbers.

The last line of standard output is the device summary JSON; the line before
it lists the kernels.  Without a CUDA device the script exits nonzero.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import re
import subprocess
import sys
import time

# (max abs error, relative L2 error) allowed against the plain version.
# float32: both sides accumulate in float32 and differ only in summation
# order.  bf16: both sides compute in float32 from the same bf16 inputs and
# round the output to bf16 (8 significant bits: the step is 2^-7 of the
# binade, up to 2^-7 of the largest output); a difference in the last
# float32 place can flip that rounding by one step, so the max abs error is
# bounded by 2^-6 (two steps) of the largest |plain output|.
TOLERANCE = {"float32": (1e-4, 1e-5), "bfloat16": (2.0 ** -6, 5e-3)}
REF_LATENT_ATOL = 1e-3  # phase 2: float32 pipeline, GPU kernels vs CPU plain
# phase 4: float32 train step, GPU kernels vs CPU plain.  The loss to 1e-4
# relative; every gradient entry to 1e-3 of the step's largest gradient (some
# gradients are zero but for rounding, e.g. a conv bias ahead of a GroupNorm,
# so each is held to the step's scale, not its own).
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 1e-4, 1e-3
TRAIN_STEPS = 5  # phase 5: trainer steps before the profiled one (>= 4)
# The card's bound for a kernel's work: the larger of its matrix-product
# FLOPs at the peak rate of the units its form runs on and the bytes it must
# move (each input read once, each output written once) at the memory rate
# (H100 SXM, NVIDIA's data sheet, at the 700 W limit).  bf16: the dense
# tensor cores; float32 on the FMA units: 67 TFLOP/s; float32 in 3xTF32
# (the flash forward at d <= 128): three TF32 products per float32 product
# at the tensor cores' 495 TFLOP/s.  A float32 flash row prints both.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 495e12}
FLOP_FACTOR = {"tf32x3": 3}  # products the form computes per matrix FLOP
PEAK_BYTES = 3.35e12

SOURCES = {
    "K1": ("tok_flash_banked", "aniportrait_tpu_torch/csrc/flash_attn_sm90.cu",
           "aniportrait_tpu/ops/pallas_attention.py:1493"),
    "K2": ("tok_flash", "aniportrait_tpu_torch/csrc/flash_attn_sm90.cu",
           "aniportrait_tpu/ops/pallas_attention.py:1043"),
    "K3": ("nat_temporal", "aniportrait_tpu_torch/csrc/temporal_attn_sm90.cu",
           "aniportrait_tpu/ops/pallas_attention.py:2018"),
    "K4": ("flash_attention", "aniportrait_tpu_torch/csrc/flash_attn_sm90.cu",
           "aniportrait_tpu/ops/pallas_attention.py:294"),
    "K5a": ("flash_attention_fwd_lse", "aniportrait_tpu_torch/csrc/flash_attn_sm90.cu",
            "aniportrait_tpu/ops/pallas_attention.py:370"),
    "K5b": ("flash_attention_bwd", "aniportrait_tpu_torch/csrc/flash_bwd_sm90.cu",
            "aniportrait_tpu/ops/pallas_attention.py:468"),
    "K6": ("ctg_packed", "aniportrait_tpu_torch/csrc/small_seq_attn_sm90.cu",
           "aniportrait_tpu/ops/pallas_attention.py:1918"),
    "K2u": ("tok_flash_unshifted", "aniportrait_tpu_torch/csrc/flash_attn_sm90.cu",
            "aniportrait_tpu/ops/pallas_attention.py:1043"),
    "K7": ("tok_flash_noshift", "aniportrait_tpu_torch/csrc/flash_attn_sm90.cu",
           "aniportrait_tpu/ops/pallas_attention.py:863"),
    "K8": ("tok_flash_bounded", "aniportrait_tpu_torch/csrc/flash_attn_sm90.cu",
           "aniportrait_tpu/ops/pallas_attention.py:1251"),
    "K9": ("ssa_packed", "aniportrait_tpu_torch/csrc/small_seq_attn_sm90.cu",
           "aniportrait_tpu/ops/pallas_attention.py:1847"),
    # K5a and K5b at stage-2 training's 16 rows (the train2 phase's launches)
    "K5a.stage2": ("flash_attention_fwd_lse stage 2 B=16",
                   "aniportrait_tpu_torch/csrc/flash_attn_sm90.cu",
                   "aniportrait_tpu/ops/pallas_attention.py:370"),
    "K5b.stage2": ("flash_attention_bwd stage 2 B=16",
                   "aniportrait_tpu_torch/csrc/flash_bwd_sm90.cu",
                   "aniportrait_tpu/ops/pallas_attention.py:468"),
    # the normalisation kernels (no TPU counterpart: XLA fuses the JAX
    # package's norms with their casts)
    "N1": ("group_norm", "aniportrait_tpu_torch/csrc/norm_sm90.cu",
           "none (XLA's GroupNorm, aniportrait_tpu/models/resnet.py:58)"),
    "N2": ("layer_norm", "aniportrait_tpu_torch/csrc/norm_sm90.cu",
           "none (XLA's LayerNorm, aniportrait_tpu/models/attention.py)"),
    # K4 in float32 at wav2vec2's self-attention (its 3xTF32 form): the
    # audio phase's B=1 S=1800 H=12 d=64 row, launches from the 40-s clip
    "K4.audio": ("flash_attention wav2vec2 float32 B=1 S=1800 H=12 d=64",
                 "aniportrait_tpu_torch/csrc/flash_attn_tf32x3_sm90.cu",
                 "aniportrait_tpu/ops/pallas_attention.py:294"),
}
# the kernels of the shared flash forward: bf16 runs its tensor-core form
# (the source above), float32 at d <= 128 its 3xTF32 tensor-core form
# (csrc/flash_attn_tf32x3_sm90.cu) and above 128 its FMA form
# (csrc/flash_attn.cu); K5b (csrc/flash_bwd.cu), K3 (csrc/temporal_attn.cu),
# K6 and K9 (csrc/small_seq_attn.cu) run float32 on their FMA forms
FLASH_FWD = ("K1", "K2", "K2u", "K4", "K5a", "K7", "K8")
# kernel id -> the tensor-core counter its bf16 form moves (tensor_core_check)
TENSOR_CORE = {**{k: "forward" for k in FLASH_FWD}, "K5b": "backward", "K3": "temporal",
               "K6": "small_seq", "K9": "small_seq", "K5a.stage2": "forward",
               "K5b.stage2": "backward"}


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def tensor_core_counts() -> dict:
    from aniportrait_tpu_torch.ops.kernels import flash, small_seq, temporal

    return {"forward": flash.tensor_core_launches,
            "tf32x3": flash.tf32x3_launches,
            "backward": flash.tensor_core_bwd_launches,
            "temporal": temporal.tensor_core_launches,
            "small_seq": small_seq.tensor_core_launches}


def tensor_core_check(phase: str, kernels=("forward",)) -> None:
    """The tensor-core kernels' launches since the last
    ``reset_launch_counts`` (``forward``: the flash forward, ``backward``:
    the flash backward, ``temporal``: K3, ``small_seq``: K6 and K9,
    ``tf32x3``: the float32 flash forward); the phase fails if one of
    ``kernels`` never ran."""
    counts = tensor_core_counts()
    log(f"[{phase}] tensor-core launches: flash forward (wgmma) {counts['forward']}, "
        f"float32 flash forward (mma.sync 3xTF32) {counts['tf32x3']}, "
        f"flash backward (wgmma) {counts['backward']}, temporal (mma.sync) "
        f"{counts['temporal']}, short sequences K6/K9 (mma.sync) {counts['small_seq']}")
    never = [k for k in kernels if counts[k] == 0]
    if never:
        raise SystemExit(f"{phase}: the tensor-core {never} kernel never launched")


# ------------------------------------------------------------------ kernels
def _time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _chunked(plain, n_rows: int, chunk: int):
    """Run a plain version over row chunks (its float32 logits at the main
    path's full batch would take tens of GB); ``plain(lo, hi)`` returns a
    tensor or a tuple of tensors, each with the rows first."""
    import torch

    def run():
        parts = [plain(lo, min(lo + chunk, n_rows)) for lo in range(0, n_rows, chunk)]
        if isinstance(parts[0], tuple):
            return tuple(torch.cat(p) for p in zip(*parts))
        return torch.cat(parts)

    return run


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(flops: float, nbytes: float, peak: str):
    """(least ms the card could take, what bounds it); ``peak``: a key of
    ``PEAK_FLOPS``, the dtype's name or the form ``tf32x3``."""
    ops_ms = flops * FLOP_FACTOR.get(peak, 1) / PEAK_FLOPS[peak] * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _sdpa(q, k, v, drop=None, split=None):
    """The library yardstick: ``F.scaled_dot_product_attention`` on
    ``(B, S, H, D)`` views, with the bank-drop mask as a boolean mask."""
    import torch
    import torch.nn.functional as F

    mask = None
    if drop is not None:
        bank = torch.arange(k.shape[1], device=k.device) >= split
        mask = ~(drop[:, None, None, None] & bank)
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask
    ).transpose(1, 2)


def _sdpa_fwd_bwd(q, k, v, do, drop=None, split=None):
    import torch

    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    return lambda: torch.autograd.grad(_sdpa(*leaves, drop, split), leaves, do)


def rows(x, lo, hi):
    return None if x is None else x[lo:hi]


def _flash_flops(b, h, sq, skv, d, drop, split) -> float:
    """Matrix-product FLOPs of one (B, S, H, D) flash forward; rows flagged
    in ``drop`` take only ``split`` keys, as the kernel's loop does."""
    n_drop = 0 if drop is None else int(drop.sum())
    keys = (b - n_drop) * skv + n_drop * (split or 0)
    return 4.0 * h * sq * keys * d


def kernel_cases(dtype):
    """Cases ``dict(kid, label, run, plain, library, flops, nbytes)`` at the
    main paths' widths: K1-K4 at the pose2vid shapes, K5a/K5b at stage-1
    training's (train_bs 2, 512 px); in float32 also K4 at d = 160, the
    flash forward's FMA form."""
    import torch
    import torch.nn.functional as F

    from aniportrait_tpu_torch.ops import kernels as K
    from aniportrait_tpu_torch.ops.kernels import flash, small_seq, temporal

    g = torch.Generator(device="cuda").manual_seed(0)
    rand = lambda *s: torch.randn(*s, generator=g, device="cuda", dtype=dtype)
    cases = []

    def case(kid, label, run, plain, library, flops, nbytes, guarded=None, tiled=None,
             d=None, contract=None):
        cases.append(dict(kid=kid, label=label, run=run, plain=plain, library=library,
                          flops=flops, nbytes=nbytes, guarded=guarded, tiled=tiled, d=d,
                          contract=contract))

    def tiled_ref(q, k, v, drop=None, split=None, chunk=4):
        """The tensor-core kernel's rounding contract on (B, S, H, D)
        operands with its KV tile, chunked over batch rows."""
        bkv = flash.wgmma_block_kv(q.shape[-1])
        return _chunked(lambda lo, hi: flash.plain_attention_tiled(
            q[lo:hi], k[lo:hi], v[lo:hi], bkv, rows(drop, lo, hi), split), q.shape[0], chunk)

    def tf32_ref(q, k, v, drop=None, split=None, n_rows=256):
        """The 3xTF32 form's arithmetic on (B, S, H, D) operands, on the
        first batch row's first ``n_rows`` queries (the kernel's rows
        there are compared with it)."""
        return lambda: flash.plain_attention_tf32x3(
            q[:1, :n_rows], k[:1], v[:1], rows(drop, 0, 1), split)

    # K1: cond CFG half at 64x64: 16 frame rows over self + one bank row
    b, s, c, h, rep = 16, 4096, 320, 8, 16
    q, k, v = rand(b, s, c), rand(b, s, c), rand(b, s, c)
    kb, vb = rand(b // rep, s, c), rand(b // rep, s, c)
    x = (q, k, v, kb, vb)
    qh = q.view(b, s, h, c // h)
    kc = torch.cat([k, kb.repeat_interleave(rep, 0)], 1).view(b, 2 * s, h, c // h)
    vc = torch.cat([v, vb.repeat_interleave(rep, 0)], 1).view(b, 2 * s, h, c // h)
    case("K1", f"B={b} S={s} S_bank={s} C={c} H={h} rep={rep}",
         lambda x=x: K.tok_flash_banked(*x, h, rep),
         _chunked(lambda lo, hi, x=x: flash.plain_tok_flash_banked(
             x[0][lo:hi], x[1][lo:hi], x[2][lo:hi],
             x[3][lo // rep:lo // rep + 1], x[4][lo // rep:lo // rep + 1],
             h, hi - lo), b, 4),
         lambda qh=qh, kc=kc, vc=vc: _sdpa(qh, kc, vc),
         4.0 * b * h * s * 2 * s * (c // h), _nbytes(q, k, v, kb, vb, q),
         tiled=tiled_ref(qh, kc, vc), d=c // h, contract=tf32_ref(qh, kc, vc))

    # K2: uncond half at 64x64 (d=40) and the c=640 concat call (d=80)
    for b, sq, skv, c in ((16, 4096, 4096, 320), (16, 1024, 2048, 640)):
        q, k, v = rand(b, sq, c), rand(b, skv, c), rand(b, skv, c)
        d = c // h
        heads = [t.view(b, t.shape[1], h, d) for t in (q, k, v)]
        case("K2", f"B={b} Sq={sq} Skv={skv} C={c} H={h}",
             lambda q=q, k=k, v=v: K.tok_flash(q, k, v, h),
             _chunked(lambda lo, hi, q=q, k=k, v=v: flash.plain_tok_flash(
                 q[lo:hi], k[lo:hi], v[lo:hi], h), b, 4),
             lambda heads=heads: _sdpa(*heads),
             4.0 * b * h * sq * skv * d, _nbytes(q, k, v, q), tiled=tiled_ref(*heads),
             d=d, contract=tf32_ref(*heads))

    # K7, K8, K2u (the token-kernel A/B's fixed-shift variants): the uncond
    # half at 64x64 (d=40) and the res/2 self + bank shape (d=80); K8's bytes
    # count its bound
    variants = (("K7", K.tok_flash_noshift, flash.plain_tok_flash_noshift),
                ("K8", K.tok_flash_bounded, flash.plain_tok_flash_bounded),
                ("K2u", K.tok_flash_unshifted, flash.plain_tok_flash_unshifted))
    for b, sq, skv, c in ((16, 4096, 4096, 320), (16, 1024, 3072, 640)):
        q, k, v = rand(b, sq, c), rand(b, skv, c), rand(b, skv, c)
        d = c // h
        heads = [t.view(b, t.shape[1], h, d) for t in (q, k, v)]
        for kid, fn, plain in variants:
            extra = b * sq * h * 4 if kid == "K8" else 0
            case(kid, f"B={b} Sq={sq} Skv={skv} C={c} H={h}",
                 lambda q=q, k=k, v=v, fn=fn: fn(q, k, v, h),
                 _chunked(lambda lo, hi, q=q, k=k, v=v, plain=plain: plain(
                     q[lo:hi], k[lo:hi], v[lo:hi], h)[0], b, 4),
                 lambda heads=heads: _sdpa(*heads),
                 4.0 * b * h * sq * skv * d, _nbytes(q, k, v, q) + extra, guarded=fn,
                 tiled=tiled_ref(*heads), d=d, contract=tf32_ref(*heads))

    # K9: the head-folded pack of the 512x512 request's top-level motion
    # module (2 CFG rows x 4096 positions x 8 heads = 65536 sequences of 16
    # frames, 8 to a 128-row tile); and 24-row groups with a dead tail
    # (rows 120-127 of each tile).  Library: SDPA on the sequences, or on
    # the tiles with the block-diagonal mask; q arrives scaled (scale 1).
    # FLOPs count the logits the mask keeps.
    for n, t, dp, seq, nv in ((8192, 128, 40, 16, 128), (3277, 128, 80, 24, 120)):
        x = [rand(n, t, dp) for _ in range(3)]
        mask = small_seq.ssa_mask(t, seq, nv, "cuda")
        if t == nv and t % seq == 0:
            lib_x, lib_mask = [y.view(n * t // seq, 1, seq, dp) for y in x], None
        else:
            lib_x, lib_mask = [y.view(n, 1, t, dp) for y in x], mask
        case("K9", f"n={n} T={t} dp={dp} seq={seq} n_valid_rows={nv}",
             lambda x=x, seq=seq, nv=nv: K.ssa_packed(*x, seq, nv),
             lambda x=x, seq=seq, nv=nv: small_seq.plain_ssa_packed(*x, seq, nv),
             lambda lib_x=lib_x, m=lib_mask: F.scaled_dot_product_attention(
                 *lib_x, attn_mask=m, scale=1.0),
             4.0 * n * int(mask.sum()) * dp, _nbytes(*x, x[0]))

    # K3: every motion module level of the 512x512 request (64x64 ... 8x8),
    # f = 16, CFG rows b = 2.  bf16 (the tensor-core form) is held to the
    # Pallas rounding contract and also reports its error against the exact
    # softmax (``tiled``); float32 to the exact softmax
    for s, c in ((4096, 320), (1024, 640), (256, 1280), (64, 1280)):
        f, bb, d = 16, 2, c // h
        x = [rand(bb * f, s, c) for _ in range(3)]
        tok = [t.view(bb, f, s, h, d).permute(0, 2, 1, 3, 4).reshape(bb * s, f, h, d)
               for t in x]
        sc = math.log2(math.e) / math.sqrt(d)
        exact = lambda x=x, sc=sc: temporal.plain_nat_temporal(*x, f, h, sc * temporal.LN2)
        mma = temporal.forward_form(dtype, d) == "mma"
        case("K3", f"b={bb} f={f} s={s} C={c} H={h} d={d}",
             lambda x=x, sc=sc: K.nat_temporal(*x, f, h, sc),
             (lambda x=x, sc=sc: temporal.plain_nat_temporal_rounded(*x, f, h, sc))
             if mma else exact,
             lambda tok=tok: _sdpa(*tok),
             4.0 * bb * s * h * f * f * d, _nbytes(*x, x[0]), tiled=exact if mma else None)

    # K6: the 576x768 long clip's 9x12 motion modules, 6 rows (3 windows x
    # CFG 2) x 108 positions = 648 sequences of 16 frames, C = 1280 (8 x
    # 160); and 24-frame sequences at C = 640, 1001 of them (not a multiple
    # of the TPU's 128 // 24 = 5 sequences per tile)
    for n, seq, ch in ((648, 16, 1280), (1001, 24, 640)):
        dh = ch // h
        x = [rand(n, seq, ch) for _ in range(3)]
        heads = [t.view(n, seq, h, dh) for t in x]
        sc = math.log2(math.e) / math.sqrt(dh)
        case("K6", f"N={n} seq={seq} C={ch} H={h} d={dh}",
             lambda x=x, seq=seq, sc=sc: K.ctg_packed(*x, seq, h, sc),
             lambda x=x, seq=seq, sc=sc: small_seq.plain_ctg_packed(*x, seq, h, sc),
             lambda heads=heads: _sdpa(*heads),
             4.0 * n * h * seq * seq * dh, _nbytes(*x, x[0]))

    # K4: PoseGuider stage-0 transformer (16 frames, 1024 tokens, 16 x 88);
    # with drop rows: 2048 keys, alternate rows see only the first 1024
    b, s, hh, d = 16, 1024, 16, 88
    q = rand(b, s, hh, d)
    for skv, drop, split in ((s, None, None),
                             (2 * s, torch.arange(b, device="cuda") % 2 == 1, s)):
        k, v = rand(b, skv, hh, d), rand(b, skv, hh, d)
        label = f"B={b} S={s} Skv={skv} H={hh} d={d}" + (
            f" drop_tail kv_split={split}" if drop is not None else "")
        case("K4", label,
             lambda q=q, k=k, v=v, drop=drop, split=split:
                 K.flash_attention(q, k, v, drop, split),
             _chunked(lambda lo, hi, q=q, k=k, v=v, drop=drop, split=split:
                      flash.plain_attention_bshd(
                          q[lo:hi], k[lo:hi], v[lo:hi],
                          None if drop is None else drop[lo:hi], split), b, 4),
             lambda q=q, k=k, v=v, drop=drop, split=split: _sdpa(q, k, v, drop, split),
             _flash_flops(b, hh, s, skv, d, drop, split), _nbytes(q, k, v, q),
             tiled=tiled_ref(q, k, v, drop, split), d=d,
             contract=tf32_ref(q, k, v, drop, split))

    # K4 in float32 above d = 128, the FMA form's range (no path of the port
    # takes it there; bf16 at d = 160 is the wgmma form's): the UNet's
    # 1280-channel width, 8 heads of 160, 1024 queries over 2048 keys
    if dtype == torch.float32:
        b, s, hh, d = 2, 1024, 8, 160
        q, k, v = rand(b, s, hh, d), rand(b, 2 * s, hh, d), rand(b, 2 * s, hh, d)
        case("K4", f"B={b} S={s} Skv={2 * s} H={hh} d={d}",
             lambda q=q, k=k, v=v: K.flash_attention(q, k, v),
             _chunked(lambda lo, hi, q=q, k=k, v=v: flash.plain_attention_bshd(
                 q[lo:hi], k[lo:hi], v[lo:hi]), b, 1),
             lambda q=q, k=k, v=v: _sdpa(q, k, v),
             _flash_flops(b, hh, s, 2 * s, d, None, None), _nbytes(q, k, v, q), d=d)

    # K5a / K5b: stage-1 training at 512 px, train_bs 2.  The denoising
    # UNet's self + bank attention (masked: CFG-dropped rows skip the bank)
    # at 64x64 (d=40) and 32x32 (d=80), and the PoseGuider's stage-0
    # transformer (16 x 88, no bank); row 1 is the dropped one.
    b = 2
    for sq, skv, hh, d, masked in ((4096, 8192, 8, 40, False), (4096, 8192, 8, 40, True),
                                   (1024, 2048, 8, 80, False), (1024, 2048, 8, 80, True),
                                   (1024, 1024, 16, 88, False)):
        q, k, v, do = rand(b, sq, hh, d), rand(b, skv, hh, d), rand(b, skv, hh, d), \
            rand(b, sq, hh, d)
        drop, split = ((torch.tensor([False, True], device="cuda"), skv // 2)
                       if masked else (None, None))
        label = f"B={b} Sq={sq} Skv={skv} H={hh} d={d}" + (
            f" drop_tail=[0,1] kv_split={split}" if masked else "")
        fwd_flops = _flash_flops(b, hh, sq, skv, d, drop, split)

        plain_fwd = _chunked(lambda lo, hi, q=q, k=k, v=v, drop=drop, split=split:
                             flash.plain_attention_fwd_lse(
                                 q[lo:hi], k[lo:hi], v[lo:hi], rows(drop, lo, hi), split),
                             b, 1)
        out, lse = plain_fwd()
        out = out.contiguous()
        case("K5a", label,
             lambda q=q, k=k, v=v, drop=drop, split=split:
                 K.flash_attention_fwd_lse(q, k, v, drop, split),
             plain_fwd,
             lambda q=q, k=k, v=v, drop=drop, split=split: _sdpa(q, k, v, drop, split),
             fwd_flops, _nbytes(q, k, v, q, lse), tiled=tiled_ref(q, k, v, drop, split, 1),
             d=d, contract=tf32_ref(q, k, v, drop, split))
        case("K5b", label,
             lambda q=q, k=k, v=v, out=out, lse=lse, do=do, drop=drop, split=split:
                 K.flash_attention_bwd(q, k, v, out, lse, do, drop, split),
             _chunked(lambda lo, hi, q=q, k=k, v=v, out=out, lse=lse, do=do, drop=drop,
                      split=split: flash.plain_attention_bwd(
                          q[lo:hi], k[lo:hi], v[lo:hi], out[lo:hi], lse[lo:hi],
                          do[lo:hi], rows(drop, lo, hi), split), b, 1),
             _sdpa_fwd_bwd(q, k, v, do, drop, split),
             2.5 * fwd_flops, _nbytes(q, k, v, out, lse, do, q, k, v))

    # K5a / K5b at stage-2 training's shapes (train_bs 1 x 16 frames, 512
    # px): the denoising UNet's self + bank attention under the bank-drop
    # mask with no row dropped (a CFG-dropped step drops all 16), at 64x64
    # (d=40) and 32x32 (d=80)
    b = 16
    for sq, skv, hh, d in ((4096, 8192, 8, 40), (1024, 2048, 8, 80)):
        q, k, v, do = rand(b, sq, hh, d), rand(b, skv, hh, d), rand(b, skv, hh, d), \
            rand(b, sq, hh, d)
        drop, split = torch.zeros(b, dtype=torch.bool, device="cuda"), skv // 2
        label = f"B={b} Sq={sq} Skv={skv} H={hh} d={d} drop_tail=none kv_split={split}"
        fwd_flops = _flash_flops(b, hh, sq, skv, d, drop, split)
        plain_fwd = _chunked(lambda lo, hi, q=q, k=k, v=v, drop=drop, split=split:
                             flash.plain_attention_fwd_lse(
                                 q[lo:hi], k[lo:hi], v[lo:hi], drop[lo:hi], split), b, 1)
        out, lse = plain_fwd()
        out = out.contiguous()
        case("K5a.stage2", label,
             lambda q=q, k=k, v=v, drop=drop, split=split:
                 K.flash_attention_fwd_lse(q, k, v, drop, split),
             plain_fwd,
             lambda q=q, k=k, v=v, drop=drop, split=split: _sdpa(q, k, v, drop, split),
             fwd_flops, _nbytes(q, k, v, q, lse), tiled=tiled_ref(q, k, v, drop, split, 1),
             d=d, contract=tf32_ref(q, k, v, drop, split))
        case("K5b.stage2", label,
             lambda q=q, k=k, v=v, out=out, lse=lse, do=do, drop=drop, split=split:
                 K.flash_attention_bwd(q, k, v, out, lse, do, drop, split),
             _chunked(lambda lo, hi, q=q, k=k, v=v, out=out, lse=lse, do=do, drop=drop,
                      split=split: flash.plain_attention_bwd(
                          q[lo:hi], k[lo:hi], v[lo:hi], out[lo:hi], lse[lo:hi],
                          do[lo:hi], drop[lo:hi], split), b, 1),
             _sdpa_fwd_bwd(q, k, v, do, drop, split),
             2.5 * fwd_flops, _nbytes(q, k, v, out, lse, do, q, k, v))
    return cases


# (rows, c, h, w, silu, frames a sample for the pooled form) of N1 and
# (shape, with the positional encoding) of N2: the shapes one f16 request
# (32 UNet rows) and one f48 request (128 rows) run, the pooled form once
NORM_GROUP_SHAPES = (
    (32, 320, 64, 64, True, 1), (32, 320, 64, 64, False, 1), (32, 960, 64, 64, True, 1),
    (32, 640, 32, 32, True, 1), (32, 1280, 16, 16, False, 1), (32, 1280, 8, 8, True, 1),
    (128, 320, 64, 64, True, 1), (128, 640, 32, 32, False, 1),
    (32, 320, 64, 64, False, 16),
    (16, 320, 32, 32, False, 1), (16, 1280, 8, 8, False, 1),
    (8, 512, 64, 64, True, 1), (8, 512, 128, 128, True, 1), (8, 256, 256, 256, True, 1),
    (8, 512, 256, 256, True, 1), (8, 128, 512, 512, True, 1), (8, 256, 512, 512, True, 1),
)
NORM_LAYER_SHAPES = (
    ((32, 4096, 320), False), ((32, 1024, 640), False), ((32, 256, 1280), False),
    ((32, 64, 1280), False), ((2, 16, 4096, 320), True), ((2, 16, 64, 1280), True),
    ((8, 16, 4096, 320), True), ((8, 16, 1024, 640), True), ((1, 257, 1024), False),
    ((16, 1024, 1408), False),
)


def norm_cases():
    """N1 and N2 cases in ``kernel_cases``' form, bf16 at the shapes of
    ``NORM_GROUP_SHAPES`` and ``NORM_LAYER_SHAPES``: the kernel against the
    float32 composition (its plain version) and ATen's norm on the bf16
    tensor (then ``F.silu`` or the encoding add) as the library yardstick;
    bytes: the activation read once and written once."""
    import torch
    import torch.nn.functional as F

    from aniportrait_tpu_torch.ops.kernels import norm

    g = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    rand = lambda *s, scale=1.0, shift=0.0: (torch.randn(
        *s, generator=g, device="cuda") * scale + shift).to(bf16)
    cases = []
    for rows, c, h, w, silu, frames in NORM_GROUP_SHAPES:
        x = rand(rows, c, h, w, scale=2.0, shift=0.5)
        wt, b = rand(c, scale=0.3, shift=1.0), rand(c, scale=0.3)

        def library(x=x, wt=wt, b=b, silu=silu, frames=frames):
            xv = x if frames == 1 else x.view(-1, frames, *x.shape[1:]).transpose(1, 2)
            y = F.group_norm(xv, 32, wt, b, 1e-5)
            return F.silu(y) if silu else y

        cases.append(dict(
            kid="N1", label=f"({rows}, {c}, {h}, {w}) 32 groups" + (" + SiLU" if silu else "")
            + (f" pooled over {frames} frames" if frames > 1 else ""),
            run=lambda x=x, wt=wt, b=b, silu=silu, frames=frames:
                norm.group_norm(x, 32, wt, b, 1e-5, frames, silu),
            plain=lambda x=x, wt=wt, b=b, silu=silu, frames=frames:
                norm.plain_group_norm(x, 32, wt, b, 1e-5, frames, silu),
            library=library, flops=0.0, nbytes=2 * _nbytes(x), guarded=None, tiled=None,
            d=None, contract=None))
    for shape, with_pe in NORM_LAYER_SHAPES:
        c = shape[-1]
        x = rand(*shape, scale=2.0, shift=0.5)
        wt, b = rand(c, scale=0.3, shift=1.0), rand(c, scale=0.3)
        pe = rand(shape[1], c) if with_pe else None

        def library(x=x, wt=wt, b=b, pe=pe):
            y = F.layer_norm(x, (x.shape[-1],), wt, b, 1e-5)
            return y if pe is None else y + pe[:, None, :]

        cases.append(dict(
            kid="N2", label=f"{tuple(shape)}" + (" + PE" if with_pe else ""),
            run=lambda x=x, wt=wt, b=b, pe=pe: norm.layer_norm(x, wt, b, 1e-5, pe),
            plain=lambda x=x, wt=wt, b=b, pe=pe: norm.plain_layer_norm(x, wt, b, 1e-5, pe),
            library=library, flops=0.0, nbytes=2 * _nbytes(x), guarded=None, tiled=None,
            d=None, contract=None))
    return cases


def _check(got, ref):
    """(ok, max abs error, rel-L2 error, bound) of outputs against the plain
    version's; each output is held to the tolerance of its own dtype."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    ok, worst_abs, worst_rel, worst_bound = True, 0.0, 0.0, 0.0
    for a, r in zip(got, ref):
        name = str(r.dtype).split(".")[-1]
        atol, rtol = TOLERANCE[name]
        diff = a.float() - r.float()
        max_abs = diff.abs().max().item()
        rel = (diff.norm() / r.float().norm().clamp_min(1e-30)).item()
        bound = atol * r.float().abs().max().item() if name == "bfloat16" else atol
        ok &= bool(torch.isfinite(a).all()) and max_abs <= bound and rel <= rtol
        worst_abs, worst_rel = max(worst_abs, max_abs), max(worst_rel, rel)
        worst_bound = max(worst_bound, bound)
    return ok, worst_abs, worst_rel, worst_bound


def _sm90_report(log_text: str) -> list:
    """ptxas's lines for each instantiation of the tensor-core kernels, with
    the dynamic shared memory its launch asks for: the flash forward
    (``flash_fwd_sm90_kernel<DP, MODE>``, ``Tile<DP>::SMEM`` in
    csrc/flash_attn_sm90.cu, with the stages of its K/V ring), the flash backward
    (``flash_bwd_sm90_kernel<DP>``, ``BwdTile<DP>::SMEM`` in
    csrc/flash_bwd_sm90.cu), the temporal kernel
    (``temporal_kernel_mma<FT>``) and the short-sequence kernels
    (``ctg_kernel_mma<FT>``, K6, and ``ssa_kernel_mma<FT>``, K9), these three
    sized per call up to ~72 KB (K9 up to ~200 KB for one tile at dp = 256);
    and the float32 flash forward in 3xTF32
    (``flash_fwd_tf32x3_kernel<DP, MODE, LSE>``).  The two forwards' shared
    memory and blocks an SM their own sources report (``flash.wgmma_shape``,
    ``flash.tf32x3_shape``: the occupancy API, registers included).  Returns
    ``(kernel, line)`` pairs."""
    from aniportrait_tpu_torch.ops.kernels.flash import tf32x3_shape, wgmma_shape

    def blocks(shape):
        warps = shape["threads"] // 32
        return (f" -> {shape['blocks_per_sm']} blocks ({warps * shape['blocks_per_sm']} "
                f"warps) an SM")

    def wgmma(dp, mode):
        shape = wgmma_shape(dp)
        return (f"DP={dp} mode={mode} BKV={shape['block_kv']} stages={shape['stages']}",
                shape["smem_bytes"], blocks(shape))

    def tf32x3(dp, mode, lse):
        shape = tf32x3_shape(dp, mode, bool(lse))
        return (f"DP={dp} mode={mode}{' LSE' if lse else ''}", shape["smem_bytes"],
                blocks(shape))

    patterns = (
        ("forward", r"flash_fwd_sm90_kernelILi(\d+)ELi(\d+)E", wgmma),
        ("backward", r"flash_bwd_sm90_kernelILi(\d+)E",
         lambda dp: (f"DP={dp}", 128 + 2 * 64 * dp * 2 + 4 * 64 * dp * 2 + 64 * 64 * 2
                     + 4 * 64 * 4 + 64 * dp * 4, "")),
        ("temporal", r"temporal_kernel_mmaILi(\d+)E",
         lambda ft: (f"FT={ft} (f <= {16 * ft})", None, "")),
        ("K6", r"ctg_kernel_mmaILi(\d+)E",
         lambda ft: (f"FT={ft} (seq <= {16 * ft})", None, "")),
        ("K9", r"ssa_kernel_mmaILi(\d+)E",
         lambda ft: (f"FT={ft} (groups <= {16 * ft} rows)", None, "")),
        ("tf32x3", r"flash_fwd_tf32x3_kernelILi(\d+)ELi(\d+)ELb(\d)E", tf32x3),
    )
    out, current = [], None
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            current = None
            for kind, pat, describe in patterns:
                m = re.search(pat, line)
                if m:
                    current = (kind, *describe(*map(int, m.groups())))
        elif current and ("registers" in line or "spill" in line):
            kind, label, smem, occupancy = current
            mem = f"{smem} B" if smem is not None else "per call"
            if "registers" not in line:
                occupancy = ""
            out.append((kind, f"{kind} {label} ({mem} dynamic shared memory): "
                              f"{line.split(':', 1)[-1].strip()}{occupancy}"))
    return out


def kernel_phase(results: dict) -> None:
    import torch

    from aniportrait_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    build.library()
    log(f"[kernels] built {build.BUILD_DIR} in {time.perf_counter() - t0:.1f} s "
        f"from {', '.join(p.name for p in build.sources())}")
    log_text = (build.BUILD_DIR / "build.log").read_text()
    for line in log_text.splitlines():
        if "sm90" in line or "mma" in line:
            continue
        if "registers" in line or ("spill" in line and " 0 bytes spill" not in line):
            log(f"[ptxas] {line.strip()}")
    failed = []
    for line in log_text.splitlines():
        if "Performance Loss" in line:  # e.g. wgmma serialized by ptxas
            log(f"[ptxas] {line.strip()}")
    for kind, line in _sm90_report(log_text):
        log(f"[ptxas sm90] {line}")
        # the bf16 forward holds its two tiles in registers at the head tiles
        # a path runs (DP <= 128); above, no path runs it, and from 160 it spills
        fwd_held = kind == "forward" and int(re.search(r"DP=(\d+)", line)[1]) <= 128
        if ((kind in ("backward", "temporal", "K6", "K9", "tf32x3") or fwd_held)
                and "spill" in line and " 0 bytes spill stores" not in line):
            failed.append(f"ptxas: {line}")
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for c in kernel_cases(dtype) + (norm_cases() if name == "bfloat16" else []):
            row = _kernel_row(c, dtype, failed)
            if c["kid"] not in results and name == "bfloat16":
                results[c["kid"]] = row
        torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"kernel phase failed: {failed}")


def _kernel_row(c: dict, dtype, failed: list) -> dict:
    """One case of ``kernel_cases``: the kernel against its plain version
    (and the form it ran), then the kernel, plain and library times and the
    bound; prints its line, appends to ``failed`` where it fails, and
    returns the line's numbers."""
    import torch

    from aniportrait_tpu_torch.ops.kernels import flash

    name = str(dtype).split(".")[-1]
    kid, label = c["kid"], c["label"]
    counters = tensor_core_counts()
    got = c["run"]()
    torch.cuda.synchronize()
    after = tensor_core_counts()
    form, ok_form, peak = "", True, name
    if kid in TENSOR_CORE and TENSOR_CORE[kid] == "forward":
        # the flash forward: the form its dtype and head dim choose, by the
        # counter that moved (wgmma, tf32x3, or neither: FMA)
        want = flash.forward_form(dtype, c["d"])
        moved = [f for f, key in (("wgmma", "forward"), ("tf32x3", "tf32x3"))
                 if after[key] > counters[key]]
        ran = moved[0] if len(moved) == 1 else "fma" if not moved else "both"
        ok_form = ran == want
        form = {"wgmma": " [wgmma bf16]", "tf32x3": " [mma.sync tf32x3 float32]",
                "fma": f" [FMA {name}]"}.get(ran, f" [{moved} FORM?]")
        peak = "tf32x3" if want == "tf32x3" else name
    elif kid in TENSOR_CORE:
        which = TENSOR_CORE[kid]
        tc = after[which] > counters[which]
        ok_form = tc == (dtype == torch.bfloat16)
        tc_name = "wgmma" if which == "backward" else "mma.sync"
        form = f" [{tc_name} bf16]" if tc else f" [FMA {name}]"
    tiled = ""
    out = got[0] if isinstance(got, tuple) else got
    if c["tiled"] is not None and dtype == torch.bfloat16:
        _, t_abs, t_rel, _ = _check(out, c["tiled"]().reshape(out.shape))
        what = "exact softmax" if kid == "K3" else "tiled contract"
        tiled = f" vs {what} max_abs_err={t_abs:.3e} rel_l2={t_rel:.3e}"
    if c.get("contract") is not None and peak == "tf32x3":
        want_rows = c["contract"]()
        _, t_abs, t_rel, _ = _check(out[:1, :want_rows.shape[1]].reshape(want_rows.shape),
                                    want_rows)
        tiled = f" vs 3xTF32 arithmetic max_abs_err={t_abs:.3e} rel_l2={t_rel:.3e}"
    ref = c["plain"]()
    ok, max_abs, rel_l2, bound = _check(got, ref)
    ok &= ok_form
    lib_err = ""
    if dtype == torch.float32 and kid.split(".")[0] in FLASH_FWD + ("K5b",):
        # the yardstick's own accuracy: the library call against the plain version
        lib = c["library"]()
        lib = lib if isinstance(lib, tuple) else (lib,)
        want = ref if isinstance(ref, tuple) else (ref,)
        _, l_abs, l_rel, _ = _check(tuple(x.reshape(r.shape) for x, r in zip(lib, want)),
                                    want[:len(lib)])
        lib_err = f" library vs plain max_abs_err={l_abs:.3e} rel_l2={l_rel:.3e}"
        del lib
    del got, ref, out
    guard = ""
    if c["guarded"] is not None:  # the fast path's output must stand
        held = c["guarded"].last_guard.item() == 0
        ok &= held
        guard = f" guard {'held' if held else 'TRIPPED'}"
    ms = _time_ms(c["run"], 5)
    plain_ms = _time_ms(c["plain"], 2)
    lib_ms = _time_ms(c["library"], 5)
    bound_ms, bound_by = _bound(c["flops"], c["nbytes"], peak)
    fma_bound = ""
    if peak == "tf32x3":
        fma_ms, fma_by = _bound(c["flops"], c["nbytes"], "float32")
        fma_bound = f"; FMA bound {fma_ms:.4f} ms ({fma_by})"
    log(f"[kernels] {kid}{form} {name} {label}: max_abs_err={max_abs:.3e} "
        f"rel_l2={rel_l2:.3e} (tol {bound:.3g}/{TOLERANCE[name][1]:g}){tiled}{lib_err} "
        f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms library {lib_ms:.3f} ms "
        f"bound {bound_ms:.4f} ms ({bound_by}{', 3xTF32' if peak == 'tf32x3' else ''}; "
        f"{c['flops'] / 1e9:.1f} GFLOP, {c['nbytes'] / 1e6:.1f} MB{fma_bound}){guard} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failed.append(f"{kid} {name} {label}")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms)


# ---------------------------------------------------------------- reference
def _gpu_vs_cpu(cpu_modules, width: int, height: int, frames: int, steps: int,
                seed: int, **pipe_kw):
    """One micro sampler run on the GPU and on the CPU from the same
    weights, inputs and initial latents; returns (max |gpu - cpu| of the
    final latents, kernel launches of the GPU run, GPU latents finite)."""
    import numpy as np
    import torch

    from aniportrait_tpu_torch.ops import kernels as K
    from aniportrait_tpu_torch.pipelines import Pose2VideoPipeline

    rs = np.random.RandomState(seed)
    ref = rs.randint(0, 255, (height, width, 3), np.uint8)
    poses = [rs.randint(0, 255, (height, width, 3), np.uint8) for _ in range(frames)]
    lat0 = rs.randn(1, frames, height // 8, width // 8, 4).astype(np.float32)
    out, counts = {}, None
    for device, modules in (("cuda", cpu_modules.to("cuda")), ("cpu", cpu_modules)):
        K.reset_launch_counts()
        pipe = Pose2VideoPipeline(modules, dtype=torch.float32, **pipe_kw)
        ref_u8, clip_u8, pose_u8 = pipe.stage_inputs(ref, poses, width, height)
        ctx, _, banks = pipe._encode_reference(ref_u8, clip_u8)
        pose_fea = pipe._pose_features(pose_u8)
        sampler = pipe._build_sampler(frames, height // 8, width // 8, steps, 3.5, True)
        lat = sampler(torch.from_numpy(lat0).to(device), ctx, banks, pose_fea)
        out[device] = lat.cpu().numpy()
        if device == "cuda":  # with the float32 flash forward's 3xTF32 calls
            counts = dict(K.launch_counts(), tf32x3=tensor_core_counts()["tf32x3"])
    err = float(np.abs(out["cuda"] - out["cpu"]).max())
    return err, counts, bool(np.isfinite(out["cuda"]).all())


def reference_phase() -> None:
    """The micro model, float32, 2 steps, GPU (kernels) vs CPU (plain
    versions): the exact windowed sampler at 256 px, 8 frames (its flash
    forward calls on the 3xTF32 form); and a fused, cached, windowed sampler
    at 112x80 px, 12 frames, where K6 runs."""
    import torch

    from aniportrait_tpu_torch import factory

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu_modules = factory.build_models("micro", "cpu", torch.float32, seed=0)
    runs = (
        ("exact windowed 256x256 px, 8 frames", dict(width=256, height=256, frames=8),
         ("K1", "K2", "K3", "tf32x3"), {}),
        ("fused + cached windowed 112x80 px, 12 frames, context 8/2",
         dict(width=112, height=80, frames=12), ("K6",),
         dict(context_frames=8, context_overlap=2, window_fusion=True,
              fusion_motion="context", encoder_cache_interval=2)),
    )
    for i, (label, size, need, pipe_kw) in enumerate(runs):
        err, counts, finite = _gpu_vs_cpu(cpu_modules, steps=2, seed=3 + i, **size,
                                          **pipe_kw)
        log(f"[reference] micro {label}, 2 steps, float32: final latents max |gpu - "
            f"cpu| = {err:.3e} (tol {REF_LATENT_ATOL:g}); kernel launches on the GPU "
            f"run {counts}")
        if not finite or err > REF_LATENT_ATOL:
            raise SystemExit(f"reference phase failed: GPU pipeline disagrees with CPU "
                             f"({label})")
        missing = [k for k in need if counts[k] == 0]
        if missing:
            raise SystemExit(f"reference phase ({label}): kernels {missing} never "
                             "launched")


# ----------------------------------------------------------------- pipeline
def pipeline_phase(results: dict) -> None:
    import numpy as np
    import torch

    from aniportrait_tpu_torch import factory
    from aniportrait_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    res, frames, steps = 512, 16, 25
    t0 = time.perf_counter()
    pipe = factory.build_pipeline("full", device="cuda", dtype=torch.bfloat16,
                                  seed=0)
    torch.cuda.synchronize()
    log(f"[pipeline] full-size models built on the GPU in "
        f"{time.perf_counter() - t0:.1f} s")
    requests = []
    for seed in (0, 1):
        rs = np.random.RandomState(100 + seed)
        ref = rs.randint(0, 255, (res, res, 3), np.uint8)
        poses = [rs.randint(0, 255, (res, res, 3), np.uint8) for _ in range(frames)]
        requests.append((ref, poses, seed))

    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    videos = []
    for i, (ref, poses, seed) in enumerate(requests):
        pipe.timer.totals.clear()
        pipe.timer.counts.clear()
        t0 = time.perf_counter()
        video = pipe(ref, poses, None, width=res, height=res, video_length=frames,
                     num_inference_steps=steps, guidance_scale=3.5, seed=seed,
                     decode_chunk=8)
        dt = time.perf_counter() - t0
        videos.append(video)
        log(f"[pipeline] request {i} (seed {seed}): {dt:.2f} s, "
            f"{frames / dt:.3f} frames/s; phases {pipe.timer.report()}")
        if video.shape != (frames, res, res, 3):
            raise SystemExit(f"pipeline: output shape {video.shape}")
        if not np.isfinite(video).all() or video.min() < 0 or video.max() > 1:
            raise SystemExit("pipeline: output not finite in [0, 1]")
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[pipeline] {res}x{res}, {frames} frames, {steps} steps, CFG 3.5, bf16: "
        f"peak device memory {peak:.2f} GiB; kernel launches {counts}")
    if np.array_equal(videos[0], videos[1]):
        raise SystemExit("pipeline: two different requests gave the same video")
    serving = ("K1", "K2", "K3", "K4", "N1", "N2")
    never = [k for k in serving if counts[k] == 0]
    if never:
        raise SystemExit(f"pipeline: kernels {never} never launched on the main path")
    tensor_core_check("pipeline", ("forward", "temporal"))
    by_level = {}
    for _, s, route in temporal_routes(pipe.m.denoising_unet, res // 8, res // 8, 2,
                                       frames):
        if route == "K3":
            by_level[s] = by_level.get(s, 0) + steps
    log(f"[pipeline] K3 launches per request by level (positions: launches), from the "
        f"model's structure: {by_level}; counted over both requests: {counts['K3']}")
    if 2 * sum(by_level.values()) != counts["K3"]:
        raise SystemExit("pipeline: K3 launches differ from the model's reckoning")
    want = {**attention_reckoning(pipe.m, res, res, frames, steps),
            **norm_reckoning(pipe.m, steps, -(-frames // 8))}
    off = {k: (counts[k], 2 * n) for k, n in want.items() if counts[k] != 2 * n}
    if off:
        raise SystemExit(f"pipeline: launches over both requests (counted, reckoned) "
                         f"differ: {off}")
    for kid in serving:
        results.setdefault(kid, {})["launches"] = counts[kid]


# --------------------------------------------------------------- long clips
def temporal_routes(unet, hlat: int, wlat: int, rows: int, frames: int):
    """``(part, s, route)`` of every temporal attention call of one
    denoising-UNet call on ``rows`` clip rows of ``frames`` frames at a
    ``hlat x wlat`` latent: part is "enc" (down + mid blocks) or "dec" (up
    blocks), s the level's positions, route what ``attention_route`` gives."""
    from aniportrait_tpu_torch.ops.attention import attention_route

    n = len(unet.down_blocks)
    sizes = [(hlat, wlat)]
    for _ in range(n - 1):
        sizes.append(((sizes[-1][0] + 1) // 2, (sizes[-1][1] + 1) // 2))
    levels = [("enc", b, i) for i, b in enumerate(unet.down_blocks)]
    levels += [("enc", unet.mid_block, n - 1)]
    levels += [("dec", b, n - 1 - i) for i, b in enumerate(unet.up_blocks)]
    out = []
    for part, blk, level in levels:
        s = sizes[level][0] * sizes[level][1]
        for mm in getattr(blk, "motion_modules", []):
            for block in mm.temporal_transformer.transformer_blocks:
                for attn in block.attention_blocks:
                    d = attn.to_q.out_features // attn.heads
                    out.append((part, s, attention_route(rows, s, s, attn.heads, d,
                                                         frames=frames)))
    return out


def k6_calls(unet, hlat: int, wlat: int, rows: int, frames: int):
    """(encoder, decoder) K6 launches of one denoising-UNet call (see
    ``temporal_routes``)."""
    calls = temporal_routes(unet, hlat, wlat, rows, frames)
    return tuple(sum(1 for p, _, r in calls if p == part and r == "K6")
                 for part in ("enc", "dec"))


def long_clip_phase(results: dict) -> None:
    """Requests A (exact windowed) and B (fused, cached, interpolated) at
    576x768, 28 frames, through ``run_cases`` on two pipelines over one set
    of full-size bf16 modules."""
    import numpy as np
    import torch

    from aniportrait_tpu_torch import factory
    from aniportrait_tpu_torch.ops import kernels as K
    from aniportrait_tpu_torch.pipelines import Pose2VideoPipeline
    from aniportrait_tpu_torch.pipelines.context import uniform_context_windows

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    width, height, frames, steps, cfg = 576, 768, 28, 25, 3.5
    t0 = time.perf_counter()
    modules = factory.build_models("full", "cuda", torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    log(f"[long-clip] full-size models built on the GPU in {time.perf_counter() - t0:.1f} s")
    windows = uniform_context_windows(0, frames, 16, 1, 4)
    log(f"[long-clip] context table (16/4, closed loop): {windows.tolist()}")
    n_win = len(windows)
    hlat, wlat = height // 8, width // 8
    enc, dec = k6_calls(modules.denoising_unet, hlat, wlat, 2 * n_win, 16)
    refresh = len(range(0, steps, 2))
    requests = (
        ("A", "exact windowed, window batch 3",
         dict(window_batch=3), dict(), frames, steps * (enc + dec)),
        ("B", "window fusion (context table), encoder cache 2, interpolation x2",
         dict(window_fusion=True, fusion_motion="context", encoder_cache_interval=2),
         dict(interpolation_factor=2), 2 * frames - 1, refresh * enc + steps * dec),
    )
    never = set()
    for i, (name, label, pipe_kw, call_kw, out_frames, k6_expected) in enumerate(requests):
        pipe = Pose2VideoPipeline(modules, dtype=torch.bfloat16, context_frames=16,
                                  context_overlap=4, **pipe_kw)
        case = _long_clip_case(name, 200 + i, width, height, frames)
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (key, video), = pipe.run_cases([case], width, height, video_length=frames,
                                       num_inference_steps=steps, guidance_scale=cfg,
                                       seed=i, decode_chunk=8, **call_kw)
        dt = time.perf_counter() - t0
        counts = K.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[long-clip] request {key} ({label}): {width}x{height}, {frames} frames, "
            f"{steps} steps, CFG {cfg}, bf16: {dt:.2f} s, {frames / dt:.3f} denoised "
            f"frames/s, {out_frames} frames out; phases {pipe.timer.report()}; peak "
            f"device memory {peak:.2f} GiB; kernel launches {counts} (K6 reckoned "
            f"{k6_expected})")
        if video.shape != (out_frames, height, width, 3):
            raise SystemExit(f"long clip {name}: output shape {video.shape}")
        if not np.isfinite(video).all() or video.min() < 0 or video.max() > 1:
            raise SystemExit(f"long clip {name}: output not finite in [0, 1]")
        if counts["K6"] != k6_expected:
            raise SystemExit(f"long clip {name}: K6 launched {counts['K6']} times, "
                             f"the model and schedule say {k6_expected}")
        need = ("K1", "K2", "K3", "K4", "K6") if name == "A" else ("K6",)
        never |= {k for k in need if counts[k] == 0}
        tensor_core_check(f"long-clip {name}", ("forward", "temporal", "small_seq")
                          if name == "A" else ("small_seq",))
        if tensor_core_counts()["small_seq"] != counts["K6"]:
            raise SystemExit(f"long clip {name}: {tensor_core_counts()['small_seq']} of "
                             f"{counts['K6']} K6 launches on the tensor cores")
        results.setdefault("K6", {}).setdefault("launches", 0)
        results["K6"]["launches"] += counts["K6"]
        del pipe, video
        gc.collect()
        torch.cuda.empty_cache()
    if never:
        raise SystemExit(f"long clips: kernels {sorted(never)} never launched")

    # where the time goes: request A's configuration at 3 steps under the
    # profiler (device activity only)
    from torch.profiler import ProfilerActivity, profile

    pipe = Pose2VideoPipeline(modules, dtype=torch.bfloat16, context_frames=16,
                              context_overlap=4, window_batch=3)
    case = _long_clip_case("A", 200, width, height, frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe(case["ref_image"], case["pose_images"], None, width, height, frames,
             num_inference_steps=3, guidance_scale=cfg, seed=0)
        wall = time.perf_counter() - t0
    totals, busy, idle = _profile_families(prof, wall)
    if busy:
        shares = ", ".join(f"{f} {s:.3f} s ({s / busy:.1%})"
                           for f, s in sorted(totals.items(), key=lambda x: -x[1]))
        log(f"[long-clip] profiled request A at 3 steps: {wall:.3f} s wall, {busy:.3f} s "
            f"device busy, idle share {idle:.1%}; phases {pipe.timer.report()}; by "
            f"family: {shares}")
    else:
        log("[long-clip] profiled request: the profiler gave no device time (not measured)")


def _long_clip_case(key: str, seed: int, width: int, height: int, frames: int) -> dict:
    import numpy as np

    rs = np.random.RandomState(seed)
    return dict(ref_image=rs.randint(0, 255, (height, width, 3), np.uint8),
                pose_images=[rs.randint(0, 255, (height, width, 3), np.uint8)
                             for _ in range(frames)], key=key)


# -------------------------------------------------------------- entry points
# configs/prompts/animation.yaml with its inference_config
# (configs/inference/inference_v2.yaml) in place of the path, as a literal:
# the card's machine may lack PyYAML.  tests/test_torch_loader.py holds it
# equal to load_config of the two files.
ENTRY_CONFIG = {
    "pretrained_base_model_path": "./pretrained_model/stable-diffusion-v1-5",
    "pretrained_vae_path": "./pretrained_model/sd-vae-ft-mse",
    "image_encoder_path": "./pretrained_model/image_encoder",
    "denoising_unet_path": "./pretrained_model/denoising_unet.pth",
    "reference_unet_path": "./pretrained_model/reference_unet.pth",
    "pose_guider_path": "./pretrained_model/pose_guider.pth",
    "motion_module_path": "./pretrained_model/motion_module.pth",
    "inference_config": {
        "unet_additional_kwargs": {
            "use_inflated_groupnorm": True,
            "unet_use_cross_frame_attention": False,
            "unet_use_temporal_attention": False,
            "use_motion_module": True,
            "motion_module_resolutions": [1, 2, 4, 8],
            "motion_module_mid_block": True,
            "motion_module_decoder_only": False,
            "motion_module_type": "Vanilla",
            "motion_module_kwargs": {
                "num_attention_heads": 8,
                "num_transformer_block": 1,
                "attention_block_types": ["Temporal_Self", "Temporal_Self"],
                "temporal_position_encoding": True,
                "temporal_position_encoding_max_len": 32,
                "temporal_attention_dim_div": 1,
            },
        },
        "noise_scheduler_kwargs": {
            "beta_start": 0.00085,
            "beta_end": 0.012,
            "beta_schedule": "linear",
            "clip_sample": False,
            "steps_offset": 1,
            "prediction_type": "v_prediction",
            "rescale_betas_zero_snr": True,
            "timestep_spacing": "trailing",
        },
        "sampler": "DDIM",
    },
    "weight_dtype": "fp16",
    "test_cases": {"./configs/inference/ref_images/solo.png":
                   ["./configs/inference/pose_videos/solo_pose.mp4"]},
}
ENTRY_BENCH_TIMEOUT = 600  # seconds for one bench subprocess


def pose_guider_routes(pg, height: int, width: int, frames: int) -> list:
    """The route of each PoseGuider transformer's attention on ``frames``
    pose maps of ``height x width``."""
    from aniportrait_tpu_torch.ops.attention import attention_route

    routes, side = [], (height // 8, width // 8)
    for i in range(pg.num_stages):
        if i < pg.num_stages - 1:
            side = ((side[0] + 1) // 2, (side[1] + 1) // 2)
        block = getattr(pg, f"cross_attn{i + 1}").transformer_blocks[0]
        h = block.attn1.heads
        s = side[0] * side[1]
        routes.append(attention_route(frames, s, s, h, block.attn1.to_q.out_features // h))
    return routes


def attention_reckoning(modules, height: int, width: int, frames: int, steps: int,
                        calls_per_step: int = 1, windows_per_call: int = 1,
                        window_frames: int | None = None) -> dict:
    """K1-K4 launches of one request with CFG (``drop_mode="first_half"``),
    from the models' structure and ``attention_route``: the ReferenceNet once
    on the 2 CFG rows of one frame, the denoising UNet ``calls_per_step``
    times a step (the unconditional half's self attention without the bank,
    the conditional half's with it, the cross attention over the one CLIP
    token), the PoseGuider's transformers once on the clip, and the motion
    modules (``temporal_routes``).  The whole-clip sampler makes one call a
    step on the clip; the windowed one ``calls_per_step`` calls, each on
    ``windows_per_call`` windows of ``window_frames`` frames."""
    from collections import Counter

    from aniportrait_tpu_torch.ops.attention import attention_route

    hlat, wlat = height // 8, width // 8
    window_frames = window_frames or frames
    call_frames = windows_per_call * window_frames
    calls = steps * calls_per_step
    counts = Counter()

    def unet_levels(unet):
        n = len(unet.down_blocks)
        sizes = [(hlat, wlat)]
        for _ in range(n - 1):
            sizes.append(((sizes[-1][0] + 1) // 2, (sizes[-1][1] + 1) // 2))
        blocks = [(b, i) for i, b in enumerate(unet.down_blocks)]
        blocks += [(unet.mid_block, n - 1)]
        blocks += [(b, n - 1 - i) for i, b in enumerate(unet.up_blocks)]
        for blk, level in blocks:
            s = sizes[level][0] * sizes[level][1]
            for st in getattr(blk, "attentions", []):
                for block in st.transformer_blocks:
                    h = block.attn1.heads
                    yield s, h, block.attn1.to_q.out_features // h

    for s, h, d in unet_levels(modules.reference_unet):
        counts[attention_route(2, s, s, h, d)] += 1
        counts[attention_route(2, s, 1, h, d)] += 1
    for s, h, d in unet_levels(modules.denoising_unet):
        counts[attention_route(call_frames, s, s, h, d)] += calls
        counts[attention_route(call_frames, s, s, h, d, bank=s)] += calls
        counts[attention_route(2 * call_frames, s, 1, h, d)] += calls
    counts.update(pose_guider_routes(modules.pose_guider, height, width, frames))
    for _, _, route in temporal_routes(modules.denoising_unet, hlat, wlat,
                                       2 * windows_per_call, window_frames):
        counts[route] += calls
    return {kid: counts[kid] for kid in ("K1", "K2", "K3", "K4")}


def norm_reckoning(modules, unet_calls: int, decode_chunks: int) -> dict:
    """N1 and N2 launches of one bf16 request, from the models' structure:
    every ``GroupNorm`` and ``LayerNorm`` of a model runs once a model call
    (CLIP, the VAE encoder and the ReferenceNet once, the PoseGuider once
    on the clip, the denoising UNet ``unet_calls`` times, the VAE decoder
    once a chunk of ``decode_chunks``)."""
    from aniportrait_tpu_torch.models.attention import LayerNorm
    from aniportrait_tpu_torch.models.resnet import GroupNorm

    def count(model, kind):
        return sum(isinstance(m, kind) for m in model.modules())

    once = (modules.clip, modules.vae.encoder, modules.reference_unet, modules.pose_guider)
    return {kid: sum(count(m, kind) for m in once)
            + unet_calls * count(modules.denoising_unet, kind)
            + decode_chunks * count(modules.vae.decoder, kind)
            for kid, kind in (("N1", GroupNorm), ("N2", LayerNorm))}


def write_checkpoints(modules, root, base=None, safetensors: bool = False) -> dict:
    """The reference's weight files from ``modules``, laid out as the prompt
    configs name them: HF-style folders for the SD-1.5 UNet (from ``base``'s
    denoising UNet without its motion modules, default ``modules``), the VAE
    and the image encoder (``.safetensors`` with ``safetensors``, else
    ``.bin``), and ``reference_unet.pth``, ``motion_module.pth`` (the motion
    modules), ``denoising_unet.pth`` (the rest, wrapped in ``state_dict``)
    and ``pose_guider.pth``.  Returns the config's path keys."""
    import os

    import torch

    def cpu(model, keep=lambda k: True):
        return {k: v.detach().cpu().contiguous().clone()
                for k, v in model.state_dict().items() if keep(k)}

    def save(state, path, hf: bool = False):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if hf and safetensors:
            from safetensors.torch import save_file

            save_file(state, path)
        else:
            torch.save(state, path)

    def hf(folder, stem):
        return os.path.join(root, folder, stem + (".safetensors" if safetensors else ".bin"))

    motion = lambda k: ".motion_modules." in k
    base = base or modules
    paths = dict(pretrained_base_model_path=os.path.join(root, "sd15"),
                 pretrained_vae_path=os.path.join(root, "vae"),
                 image_encoder_path=os.path.join(root, "image_encoder"),
                 reference_unet_path=os.path.join(root, "reference_unet.pth"),
                 motion_module_path=os.path.join(root, "motion_module.pth"),
                 denoising_unet_path=os.path.join(root, "denoising_unet.pth"),
                 pose_guider_path=os.path.join(root, "pose_guider.pth"))
    save(cpu(base.denoising_unet, lambda k: not motion(k)),
         hf("sd15/unet", "diffusion_pytorch_model"), hf=True)
    save(cpu(modules.vae), hf("vae", "diffusion_pytorch_model"), hf=True)
    save(cpu(modules.clip), hf("image_encoder", "model" if safetensors else "pytorch_model"),
         hf=True)
    save(cpu(modules.reference_unet), paths["reference_unet_path"])
    save(cpu(modules.denoising_unet, motion), paths["motion_module_path"])
    save({"state_dict": cpu(modules.denoising_unet, lambda k: not motion(k))},
         paths["denoising_unet_path"])
    save(cpu(modules.pose_guider), paths["pose_guider_path"])
    return paths


def _entry_bench(argv: list, expect: str | None = None) -> dict:
    """One bench run in its own process (its standard output is exactly the
    one JSON line, its standard error holds ``expect``); returns the line,
    parsed."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "aniportrait_tpu_torch.scripts.bench",
                          *argv], cwd=root, capture_output=True, text=True,
                         timeout=ENTRY_BENCH_TIMEOUT)
    dt = time.perf_counter() - t0
    for line in res.stderr.strip().splitlines()[-8:]:
        log(f"[entry] bench {' '.join(argv) or '(default)'} stderr: {line}")
    lines = res.stdout.strip().splitlines()
    if res.returncode != 0 or len(lines) != 1:
        raise SystemExit(f"entry: bench {argv} exited {res.returncode} with "
                         f"{len(lines)} lines on stdout")
    row = json.loads(lines[0])
    if sorted(row) != ["metric", "unit", "value", "vs_baseline"] or not row["value"] > 0:
        raise SystemExit(f"entry: bench {argv} printed {row}")
    if expect is not None and expect not in res.stderr:
        raise SystemExit(f"entry: bench {argv} did not say {expect!r}")
    log(f"[entry] bench {' '.join(argv) or '(default)'} on {gpu_line()} ({dt:.1f} s "
        f"in all): {lines[0]}")
    return row


def entry_phase() -> None:
    """The user's entry points on the card: ``load_pipeline`` from the
    default prompt and inference settings (random weights, full size,
    bf16); the pose2vid CLI's generation at 512x512, 16 frames, 25 steps,
    CFG 3.5 on cases made from arrays (the card has no OpenCV); the bench
    entry at its default and ``vid2vid24`` configs; and the loader's weight
    files at tiny size, read back bit for bit."""
    import os
    import tempfile

    import numpy as np
    import torch

    from aniportrait_tpu_torch import factory
    from aniportrait_tpu_torch.config import Config
    from aniportrait_tpu_torch.ops import kernels as K
    from aniportrait_tpu_torch.scripts import pose2vid
    from aniportrait_tpu_torch.scripts.loader import load_pipeline

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    res, frames, steps = 512, 16, 25
    t0 = time.perf_counter()
    pipe = load_pipeline(Config(ENTRY_CONFIG), random_init=True, size="full",
                         device="cuda")
    torch.cuda.synchronize()
    log(f"[entry] load_pipeline (random init, full size, bf16, cuda) in "
        f"{time.perf_counter() - t0:.1f} s")

    root = os.path.dirname(os.path.abspath(__file__))
    golden = np.load(os.path.join(root, "tests", "fixtures", "landmark_golden.npz"))
    names = ("lyl", "solo", "Aragaki")
    poses = [golden[f"{names[i % 3]}_pose"] for i in range(frames)]
    ref = np.random.RandomState(300).randint(0, 255, (res, res, 3), np.uint8)
    case = dict(ref_image=ref, pose_images=poses, ref_pose_image=golden["solo_pose"],
                kw=dict(video_length=frames))
    args = pose2vid.parse_args(["-W", str(res), "-H", str(res), "--steps", str(steps),
                                "--cfg", "3.5", "--seed", "0"])
    K.reset_launch_counts()
    t0 = time.perf_counter()
    grids = list(pose2vid.generate(pipe, [case], args))
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    want = attention_reckoning(pipe.m, res, res, frames, steps)
    (key, grid), = grids
    log(f"[entry] pose2vid generate {res}x{res}, {frames} frames, {steps} steps, CFG 3.5, "
        f"bf16: {dt:.2f} s, {frames / dt:.3f} frames/s; phases {pipe.timer.report()}; "
        f"grid {grid.shape}; kernel launches {counts}, reckoned {want}")
    if grid.shape != (3, frames, res, res, 3):
        raise SystemExit(f"entry: grid shape {grid.shape}")
    video = grid[2]
    if not np.isfinite(video).all() or video.min() < 0 or video.max() > 1:
        raise SystemExit("entry: output not finite in [0, 1]")
    if not (np.array_equal(grid[0], np.repeat(ref[None] / np.float32(255), frames, 0))
            and np.array_equal(grid[1], np.stack(poses) / np.float32(255))):
        raise SystemExit("entry: the grid's reference or pose row differs from its input")
    off = {k: (counts[k], n) for k, n in want.items() if counts[k] != n}
    if off:
        raise SystemExit(f"entry: kernel launches (counted, reckoned) differ: {off}")
    tensor_core_check("entry", ("forward", "temporal"))
    del pipe, grids, grid, video
    gc.collect()
    torch.cuda.empty_cache()

    _entry_bench([])
    _entry_bench(["--config", "vid2vid24"])

    src = factory.build_models("tiny", "cuda", torch.bfloat16, seed=5)
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(root, "build")) as tmp:
        paths = write_checkpoints(src, tmp)
        t0 = time.perf_counter()
        loaded = load_pipeline(Config({**ENTRY_CONFIG, **paths}), size="tiny",
                               device="cuda").m
        dt = time.perf_counter() - t0
    differ = [f"{name}.{k}" for name, model in src.models().items()
              for k, v in model.state_dict().items()
              if not torch.equal(v, loaded.models()[name].state_dict()[k])]
    n = sum(len(m.state_dict()) for m in src.models().values())
    log(f"[entry] loader: tiny bf16 weights written as .pth files and HF folders and "
        f"read back onto the card in {dt:.1f} s: {n - len(differ)} of {n} tensors bit-equal")
    if differ:
        raise SystemExit(f"entry: loaded weights differ from their source: {differ[:5]}")


# -------------------------------------------------------------------- audio
# configs/prompts/animation_audio.yaml with its inference_config
# (inference_v2.yaml, as in ENTRY_CONFIG) and audio_inference_config
# (configs/inference/inference_audio.yaml) in place of the paths, as a
# literal: the card's machine may lack PyYAML.  tests/test_torch_serve.py
# holds it equal to load_config of the three files.
AUDIO_CONFIG = {
    **{k: v for k, v in ENTRY_CONFIG.items() if k != "test_cases"},
    "audio_inference_config": {
        "a2m_model": {"out_dim": 1404, "latent_dim": 512,
                      "model_path": "./pretrained_model/wav2vec2-base-960h",
                      "only_last_fetures": True, "from_pretrained": True},
        "a2p_model": {"out_dim": 6, "latent_dim": 512,
                      "model_path": "./pretrained_model/wav2vec2-base-960h",
                      "only_last_fetures": True, "from_pretrained": True},
        "pretrained_model": {"a2m_ckpt": "./pretrained_model/audio2mesh.pt",
                             "a2p_ckpt": "./pretrained_model/audio2pose.pt"},
    },
    "test_cases": {"./configs/inference/ref_images/lyl.png":
                   ["./configs/inference/audio/lyl.wav"]},
}
# Audio2Mesh and Audio2Pose, float32 with TF32 off, card against CPU: every
# output within this share of the CPU output's largest magnitude.  Both
# sides accumulate in float32 and differ in summation order (cuBLAS and
# cuDNN against the CPU's kernels, K4 against its plain version) through 12
# encoder layers and, for the poses, an autoregressive decode that feeds
# each frame back.
AUDIO_REL_TOL = 1e-3
AUDIO_LONG_SECONDS = 40  # 1200 frames at 30 fps: wav2vec2's attention takes K4
# the encoder sizes of tests/test_audio_stack.py's tiny models
TINY_WAV2VEC2 = dict(hidden=32, layers=2, heads=4, intermediate=64, pos_conv_kernel=16,
                     pos_conv_groups=4, conv_layers=((16, 10, 5), (16, 3, 2)))


def write_wav(path: str, seconds: float, seed: int, rate: int = 16000) -> str:
    """Seeded 16-bit mono audio: noise under a 3 Hz envelope, so the
    normalised signal has loud and quiet stretches."""
    import numpy as np
    from scipy.io import wavfile

    rs = np.random.RandomState(seed)
    n = int(round(seconds * rate))
    env = 0.5 + 0.4 * np.sin(2 * np.pi * 3.0 * np.arange(n) / rate + rs.uniform(0, 6))
    wavfile.write(path, rate, (np.clip(0.1 * env * rs.randn(n), -1, 1) * 32767).astype(
        np.int16))
    return path


def write_audio_checkpoints(a2m, a2p, root) -> dict:
    """The reference's ``audio2mesh.pt`` and ``audio2pose.pt`` from the
    models: the positional conv stored as ``weight_g`` / ``weight_v`` (the
    weight norm of HF wav2vec2, ``weight_norm(dim=2)``: g the norm over the
    kernel's first two dims), and in ``audio2pose.pt`` the ``PPE.pe`` and
    ``biased_mask`` tensors the reference saves.  Each model's positional
    conv is first set to the merge of what is written, so that reading the
    files gives the model back bit for bit.  Returns the audio config's
    ``pretrained_model`` entries."""
    import os

    import torch

    from aniportrait_tpu_torch.weights.convert import merge_pos_conv_weight_norm

    key = "audio_encoder.encoder.pos_conv_embed.conv"
    paths = {}
    for model, name, ckpt in ((a2m, "audio2mesh", "a2m_ckpt"), (a2p, "audio2pose", "a2p_ckpt")):
        state = {k: v.detach().cpu().contiguous().clone()
                 for k, v in model.state_dict().items()}
        v = state.pop(f"{key}.weight")
        g = v.norm(dim=(0, 1), keepdim=True)
        merged = merge_pos_conv_weight_norm({f"{key}.weight_g": g, f"{key}.weight_v": v},
                                            "audio_encoder.")[f"{key}.weight"]
        with torch.no_grad():
            model.audio_encoder.encoder.pos_conv_embed.conv.weight.copy_(
                torch.from_numpy(merged))
        state[f"{key}.weight_g"], state[f"{key}.weight_v"] = g, v
        if name == "audio2pose":
            d = model.in_fn.out_features
            state["PPE.pe"] = torch.zeros(1, model.pe_max_len, d)
            state["biased_mask"] = torch.zeros(model.heads, 16, 16)
        paths[ckpt] = os.path.join(root, f"{name}.pt")
        torch.save(state, paths[ckpt])
    return paths


def audio_kernel_cases(dtype):
    """K4 at wav2vec2-base's self-attention, B=1, 12 heads, d=64: 1024
    frames (the first length that takes K4, 34.1 s of audio at 30 fps) and
    1800 (60 s; 28 tiles of 64 and 8 rows)."""
    import torch

    from aniportrait_tpu_torch.ops import kernels as K
    from aniportrait_tpu_torch.ops.kernels import flash

    g = torch.Generator(device="cuda").manual_seed(2)
    cases = []
    for s in (1024, 1800):
        q, k, v = (torch.randn(1, s, 12, 64, generator=g, device="cuda", dtype=dtype)
                   for _ in range(3))
        bkv = flash.wgmma_block_kv(64)
        cases.append(dict(
            kid="K4", label=f"wav2vec2 B=1 S={s} H=12 d=64", seq=s,
            run=lambda q=q, k=k, v=v: K.flash_attention(q, k, v),
            plain=lambda q=q, k=k, v=v: flash.plain_attention_bshd(q, k, v),
            library=lambda q=q, k=k, v=v: _sdpa(q, k, v),
            flops=4.0 * 12 * s * s * 64, nbytes=_nbytes(q, k, v, q), guarded=None,
            tiled=lambda q=q, k=k, v=v: flash.plain_attention_tiled(q, k, v, bkv), d=64,
            contract=lambda q=q, k=k, v=v: flash.plain_attention_tf32x3(q, k, v)))
    return cases


def _rel_err(got, want) -> tuple:
    import numpy as np

    scale = float(np.abs(want).max())
    return float(np.abs(got - want).max()) / scale, scale


def audio_phase(results: dict) -> None:
    """The audio-driven path (ROADMAP M9, M10b) on the card: K4 at
    wav2vec2's shapes; Audio2Mesh and Audio2Pose (full size, random weights
    from seed 0) card against CPU on a 2.5-s seeded WAV read back through
    ``prepare_audio_feature``, a 40-s clip through Audio2Mesh (K4 exactly
    once per encoder layer) and a 10-s ``generate_head_pose`` (timed; ROADMAP
    F7's case); one serving request through ``serving_core.animate`` from
    ``load_serving_models`` (48 frames, 512x512, 25 steps, CFG 3.5, the
    fixture's pose maps), K1-K4 held to the window table's reckoning; the
    bench in its own process at ``audio2mesh`` and ``audio2vid --pose-maps
    fixture``; and tiny audio checkpoints written as the reference's files
    and read back bit for bit."""
    import copy
    import os
    import tempfile

    import numpy as np
    import torch

    from aniportrait_tpu_torch.config import Config
    from aniportrait_tpu_torch.landmark.geometry import GeometrySolver, load_geometry_metadata
    from aniportrait_tpu_torch.landmark.pipeline import DEFAULT_TASK
    from aniportrait_tpu_torch.ops import kernels as K
    from aniportrait_tpu_torch.ops.kernels import build
    from aniportrait_tpu_torch.pipelines.context import uniform_context_windows
    from aniportrait_tpu_torch.scripts import audio2vid, serving_core
    from aniportrait_tpu_torch.scripts.loader import load_audio_models
    from aniportrait_tpu_torch.utils.audio_util import normalize_audio, prepare_audio_feature

    t_phase = time.perf_counter()
    # float32 without TF32 (an earlier phase may have allowed it) for the
    # plain versions and for the audio models, card and CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.library()
    failed = []
    for dtype in (torch.float32, torch.bfloat16):
        for c in audio_kernel_cases(dtype):
            row = _kernel_row(c, dtype, failed)
            if dtype == torch.float32 and c["seq"] == 1800:
                results["K4.audio"] = row
    if failed:
        raise SystemExit(f"audio phase: kernel rows failed: {failed}")

    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    tmp_dir = tempfile.TemporaryDirectory(dir=os.path.join(root, "build"))
    tmp = tmp_dir.name
    audio_cfg = Config(AUDIO_CONFIG["audio_inference_config"])

    # card against CPU, float32, TF32 off
    cpu = load_audio_models(audio_cfg, random_init=True, device="cpu")
    card = tuple(copy.deepcopy(m).cuda() for m in cpu)
    sample = prepare_audio_feature(write_wav(os.path.join(tmp, "a.wav"), 2.5, seed=10))
    wav, seq_len = sample["audio_feature"], sample["seq_len"]
    K.reset_launch_counts()
    out = {}
    for dev, (a2m, a2p) in (("cuda", card), ("cpu", cpu)):
        out[dev] = (audio2vid.mesh_offsets(a2m, wav, seq_len),
                    audio2vid.generate_head_pose(a2p, wav, seq_len, id_seed=7))
    errs = [_rel_err(a, b) for a, b in zip(out["cuda"], out["cpu"])]
    log(f"[audio] 2.5-s WAV ({len(wav)} samples, {seq_len} frames), float32, TF32 off, card "
        f"vs CPU: mesh offsets {out['cuda'][0].shape} max err {errs[0][0]:.3e} of max "
        f"|offset| {errs[0][1]:.3g}; head poses {out['cuda'][1].shape} max err "
        f"{errs[1][0]:.3e} of max |pose| {errs[1][1]:.3g} (tol {AUDIO_REL_TOL:g}); kernel "
        f"launches {K.launch_counts()}")
    if (out["cuda"][0].shape != (seq_len, 468, 3) or out["cuda"][1].shape != (seq_len, 6)
            or not all(e <= AUDIO_REL_TOL for e, _ in errs)):
        raise SystemExit("audio: the card's audio models disagree with the CPU's")

    # a 40-s clip through Audio2Mesh: wav2vec2's attention at 1200 frames
    long_wav = normalize_audio(np.random.RandomState(11).randn(
        16000 * AUDIO_LONG_SECONDS).astype(np.float32))
    frames = 30 * AUDIO_LONG_SECONDS
    a2m, a2p = card
    audio2vid.mesh_offsets(a2m, long_wav[:16000], 30)  # warm-up below K4's length
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    offsets = audio2vid.mesh_offsets(a2m, long_wav, frames)
    dt = time.perf_counter() - t0
    counts, forms = K.launch_counts(), tensor_core_counts()
    repeats = []  # five more passes, timed alone
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        audio2vid.mesh_offsets(a2m, long_wav, frames)
        repeats.append(time.perf_counter() - t0)
    cpu_offsets = audio2vid.mesh_offsets(cpu[0], long_wav, frames)
    err, scale = _rel_err(offsets, cpu_offsets)
    layers = len(a2m.audio_encoder.encoder.layers)
    log(f"[audio] {AUDIO_LONG_SECONDS}-s clip ({frames} frames) through Audio2Mesh on "
        f"{gpu_line()}: {dt:.3f} s with upload and download (then "
        f"{', '.join(f'{x * 1e3:.2f}' for x in repeats)} ms, median "
        f"{sorted(repeats)[2] * 1e3:.2f} ms); kernel launches {counts} "
        f"(K4 on the 3xTF32 form: {forms['tf32x3']}, on wgmma: {forms['forward']}); "
        f"vs CPU max err {err:.3e} of {scale:.3g}")
    if (counts["K4"] != layers or sum(counts.values()) != layers
            or forms["tf32x3"] != layers or forms["forward"] != 0):
        raise SystemExit(f"audio: the {frames}-frame clip launched {counts} ({forms}), not "
                         f"K4 on the 3xTF32 form once per each of {layers} layers")
    if not np.isfinite(offsets).all() or err > AUDIO_REL_TOL:
        raise SystemExit("audio: the long clip's offsets are not finite or off the CPU's")
    results.setdefault("K4.audio", {})["launches"] = counts["K4"]

    # the autoregressive decode: a 10.0-s clip, whose last chunk is full
    ten = normalize_audio(np.random.RandomState(12).randn(160000).astype(np.float32))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    poses = audio2vid.generate_head_pose(a2p, ten, 300, id_seed=3)
    dt = time.perf_counter() - t0
    log(f"[audio] generate_head_pose on a 10.0-s clip (300 frames, two 5-s chunks merged "
        f"into one decode): {dt:.3f} s, {dt / 300 * 1e3:.2f} ms a frame; poses "
        f"{poses.shape}")
    if poses.shape != (300, 6) or not np.isfinite(poses).all():
        raise SystemExit(f"audio: generate_head_pose gave {poses.shape} for 300 frames")
    del cpu, card, a2m, a2p, out
    gc.collect()
    torch.cuda.empty_cache()

    # one serving request through the audio2vid device function
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    res, steps, length = 512, 25, 48
    t0 = time.perf_counter()
    models = serving_core.load_serving_models(Config(AUDIO_CONFIG), random_init=True,
                                              size="full", device="cuda")
    torch.cuda.synchronize()
    log(f"[audio] load_serving_models (random init, full size: pipeline bf16, audio "
        f"models float32, cuda) in {time.perf_counter() - t0:.1f} s")
    golden = np.load(os.path.join(root, "tests", "fixtures", "landmark_golden.npz"))
    solver = GeometrySolver(load_geometry_metadata(DEFAULT_TASK))
    face = dict(lmks=golden["solo_lmks"], trans_mat=golden["solo_trans_mat"],
                lmks3d=solver.solve(golden["solo_lmks"], (res, res))["mesh"])
    maps = [golden[f"{n}_pose"] for n in ("lyl", "solo", "Aragaki")]
    ref = np.random.RandomState(301).randint(0, 255, (res, res, 3), np.uint8)
    sample = prepare_audio_feature(write_wav(os.path.join(tmp, "b.wav"), length / 30, 13))
    pipe = models.pipe
    pipe.timer.totals.clear()
    pipe.timer.counts.clear()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    video = serving_core.animate(models, sample, face, ref, golden["solo_pose"], size=res,
                                 steps=steps, length=length, seed=0, pose_maps=maps)
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    n_win = len(uniform_context_windows(0, length, pipe.context_frames, pipe.context_stride,
                                        pipe.context_overlap))
    wb = min(pipe.window_batch, n_win)
    want = attention_reckoning(pipe.m, res, res, length, steps, -(-n_win // wb), wb,
                               pipe.context_frames)
    phases = pipe.timer.summary()
    audio_s = sum(phases[k]["total_s"] for k in ("audio2mesh", "audio2pose"))
    log(f"[audio] serving request ({sample['seq_len']} frames of audio, {res}x{res}, "
        f"{length} frames, {steps} steps, CFG 3.5, bf16; {n_win} windows of "
        f"{pipe.context_frames}, window batch {wb}): {dt:.2f} s, {length / dt:.3f} "
        f"frames/s, audio stack {audio_s:.3f} s; phases {pipe.timer.report()}; kernel "
        f"launches {counts}, reckoned {want}")
    if video.shape != (length, res, res, 3):
        raise SystemExit(f"audio: video shape {video.shape}")
    if not np.isfinite(video).all() or video.min() < 0 or video.max() > 1:
        raise SystemExit("audio: video not finite in [0, 1]")
    off = {k: (counts[k], n) for k, n in want.items() if counts[k] != n}
    if off:
        raise SystemExit(f"audio: kernel launches (counted, reckoned) differ: {off}")
    tensor_core_check("audio", ("forward", "temporal"))
    for kid in ("K1", "K2", "K3", "K4"):
        results.setdefault(kid, {}).setdefault("launches", counts[kid])
    del models, pipe, video
    gc.collect()
    torch.cuda.empty_cache()

    _entry_bench(["--config", "audio2mesh"])
    _entry_bench(["--config", "audio2vid", "--pose-maps", "fixture"])

    # the loader's weight path: tiny audio models written as the reference's
    # files and read back onto the card
    tiny = {**AUDIO_CONFIG["audio_inference_config"]}
    tiny["a2m_model"] = {**tiny["a2m_model"], "latent_dim": 16}
    tiny["a2p_model"] = {**tiny["a2p_model"], "latent_dim": 16}
    src = load_audio_models(Config(tiny), random_init=True, device="cpu", seed=5,
                            wav2vec2=TINY_WAV2VEC2)
    paths = write_audio_checkpoints(*src, tmp)
    t0 = time.perf_counter()
    loaded = load_audio_models(Config({**tiny, "pretrained_model": paths}), device="cuda",
                               wav2vec2=TINY_WAV2VEC2)
    dt = time.perf_counter() - t0
    differ = [f"{i}.{k}" for i, (a, b) in enumerate(zip(src, loaded))
              for k, v in a.state_dict().items() if not torch.equal(v.cuda(), b.state_dict()[k])]
    n = sum(len(m.state_dict()) for m in src)
    log(f"[audio] loader: tiny audio models written as audio2mesh.pt / audio2pose.pt "
        f"(weight_g / weight_v, packed in_proj, PPE.pe, biased_mask) and read back onto the "
        f"card in {dt:.2f} s: {n - len(differ)} of {n} tensors bit-equal")
    if differ:
        raise SystemExit(f"audio: loaded weights differ from their source: {differ[:5]}")
    tmp_dir.cleanup()
    log(f"[audio] phase time {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------------ quality
LPIPS_REL_TOL = 1e-4  # float32 LPIPS, card against CPU, of the largest distance
FILM_TOL = 1e-4  # float32 FiLM, card against CPU, of the largest |output|


def _random_lpips_weights(seed: int = 0) -> dict:
    """LPIPS weights in the ``.npz`` layout of ``convert_lpips_weights``,
    seeded (the pretrained ones are not in the repository)."""
    import numpy as np

    from aniportrait_tpu_torch.utils.quality import _ALEX_CONVS

    rs = np.random.RandomState(seed)
    w, cin = {}, 3
    for i, (cout, k, _, _) in enumerate(_ALEX_CONVS):
        w[f"conv{i}_w"] = (rs.randn(k, k, cin, cout) * np.sqrt(2.0 / (k * k * cin))
                           ).astype(np.float32)
        w[f"conv{i}_b"] = (rs.randn(cout) * 0.01).astype(np.float32)
        w[f"lin{i}"] = rs.rand(cout).astype(np.float32)
        cin = cout
    return w


def _py_config(path: str, **values) -> str:
    """A prompt config as an importable ``.py`` file (no PyYAML needed)."""
    with open(path, "w") as f:
        f.writelines(f"{k} = {v!r}\n" for k, v in values.items())
    return path


def _validate_on_card(root: str) -> None:
    """Full-size checkpoint files (bf16 diffusion models as the entry phase
    writes them, float32 audio checkpoints with their encoders, a traced
    random FiLM blob) through ``validate_weights``: exit 0; and with one
    key of ``pose_guider.pth`` dropped: exit 1, naming the key."""
    import contextlib
    import io
    import os

    import torch

    from aniportrait_tpu_torch import factory
    from aniportrait_tpu_torch.audio.audio2mesh import Audio2MeshModel
    from aniportrait_tpu_torch.audio.audio2pose import Audio2PoseModel
    from aniportrait_tpu_torch.scripts import validate_weights
    from aniportrait_tpu_torch.utils.frame_interpolation import random_film

    t0 = time.perf_counter()
    modules = factory.build_models("full", "cuda", torch.bfloat16, seed=7)
    paths = write_checkpoints(modules, root)
    del modules
    audio = write_audio_checkpoints(Audio2MeshModel(), Audio2PoseModel(), root)
    film = random_film(0).eval()
    x = torch.rand(1, 3, 64, 64)
    with torch.no_grad():
        torch.jit.save(torch.jit.trace(film, (x, x, torch.full((1,), 0.5))),
                       os.path.join(root, "film_net_fp16.pt"))
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root)
                 for f in fs)
    log(f"[quality] full-size checkpoint files written ({nbytes / 2**30:.2f} GiB) in "
        f"{time.perf_counter() - t0:.1f} s")
    infer = ENTRY_CONFIG["inference_config"]
    cfg = _py_config(os.path.join(root, "prompt.py"), inference_config=infer, **paths)
    acfg = dict(AUDIO_CONFIG["audio_inference_config"], pretrained_model=audio)
    audio_cfg = _py_config(os.path.join(root, "audio.py"), audio_inference_config=acfg)

    def run(argv):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = validate_weights.main(argv)
        return rc, out.getvalue(), time.perf_counter() - t0

    rc, out, dt = run(["--config", cfg, "--audio-config", audio_cfg,
                       "--film", os.path.join(root, "film_net_fp16.pt")])
    checked = [line for line in out.splitlines() if line.startswith("checked")]
    log(f"[quality] validate_weights on the full-size files: exit {rc} in {dt:.1f} s; "
        f"{'; '.join(checked)}")
    if rc != 0 or len(checked) != 8:
        raise SystemExit(f"quality: validate_weights failed on a complete set:\n{out}")
    state = torch.load(paths["pose_guider_path"], weights_only=True)
    dropped = sorted(state)[len(state) // 2]
    del state[dropped]
    bad_pg = os.path.join(root, "pose_guider_dropped.pth")
    torch.save(state, bad_pg)
    bad = _py_config(os.path.join(root, "prompt_dropped.py"), inference_config=infer,
                     **{**paths, "pose_guider_path": bad_pg})
    rc, out, dt = run(["--config", bad])
    problems = [line for line in out.splitlines() if line.startswith(" - ")]
    log(f"[quality] validate_weights with {dropped!r} dropped: exit {rc} in {dt:.1f} s; "
        f"{problems}")
    if rc != 1 or not any(dropped in line for line in problems):
        raise SystemExit(f"quality: validate_weights missed the dropped key {dropped}")


def quality_phase() -> None:
    """LPIPS and FiLM on the card against the CPU and timed, the bench's
    ``audio2vid_acc``, weight validation on full-size files, and the
    approximations' quality gate (``quality_speed_gate --check``)."""
    import copy
    import os
    import tempfile

    import numpy as np
    import torch

    from aniportrait_tpu_torch.scripts import quality_speed_gate
    from aniportrait_tpu_torch.utils.frame_interpolation import _load_film, random_film
    from aniportrait_tpu_torch.utils.quality import LPIPS, compare_videos

    root = os.path.dirname(os.path.abspath(__file__))
    rs = np.random.RandomState(11)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # LPIPS, float32: card against CPU, 8 frames at 512 px
    weights = _random_lpips_weights(0)
    a, b = (rs.randint(0, 256, (8, 512, 512, 3), np.uint8) for _ in range(2))
    gpu, cpu = LPIPS(weights, device="cuda"), LPIPS(weights, device="cpu")
    got, want = gpu(a, b), cpu(a, b)
    err = float(np.abs(got - want).max() / np.abs(want).max())
    ta, tb = (torch.from_numpy(x).cuda() for x in (a, b))
    ms = _time_ms(lambda: gpu(ta, tb), 5)
    log(f"[quality] LPIPS (float32, 8 frames at 512 px) card vs CPU: distances "
        f"{np.round(got, 5).tolist()}, max rel err {err:.2e} (tol {LPIPS_REL_TOL:.0e}); "
        f"{ms:.2f} ms for 8 frame pairs on {gpu_line()} ({ms / 8:.3f} ms a pair)")
    if not err <= LPIPS_REL_TOL:
        raise SystemExit(f"quality: LPIPS card vs CPU {err:.2e}")

    # FiLM, float32 at full width: card against CPU on one 128x128 pair
    film = random_film(0).eval()
    x0, x1 = (torch.from_numpy(rs.rand(1, 3, 128, 128).astype(np.float32)) for _ in range(2))
    with torch.no_grad():
        want = film(x0, x1, torch.full((1,), 0.5))
        film_gpu = copy.deepcopy(film).cuda()
        got = film_gpu(x0.cuda(), x1.cuda(), torch.full((1,), 0.5, device="cuda")).cpu()
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    log(f"[quality] FiLM (float32, full width, 128x128) card vs CPU: max err {err:.2e} "
        f"of the largest |output| {scale:.3f} (tol {FILM_TOL:.0e})")
    if not err <= FILM_TOL:
        raise SystemExit(f"quality: FiLM card vs CPU {err:.2e}")
    del film, film_gpu
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True

    # FiLM, bf16 at 512x512, batch 4 (the -acc path's loader and batch)
    fn = _load_film(None, random_init=True, device="cuda")
    pairs = [torch.from_numpy(rs.rand(4, 512, 512, 3).astype(np.float32)).cuda()
             for _ in range(2)]
    fn(*pairs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = _time_ms(lambda: fn(*pairs), 5)
    peak = torch.cuda.max_memory_allocated() - base
    out = fn(*pairs)
    if out.shape != (4, 512, 512, 3) or not torch.isfinite(out).all():
        raise SystemExit(f"quality: bf16 FiLM gave {tuple(out.shape)}")
    log(f"[quality] FiLM (bf16, 512x512, batch 4) on {gpu_line()}: {ms:.2f} ms a call, "
        f"{ms / 4:.2f} ms a midpoint frame; peak {peak / 2**30:.2f} GiB above the inputs "
        f"and weights")
    del fn, pairs, out
    gc.collect()
    torch.cuda.empty_cache()

    # the bench's audio2vid_acc (its own process)
    _entry_bench(["--config", "audio2vid_acc", "--pose-maps", "fixture"],
                 expect="output 46 frames")

    # weight validation on full-size files
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(root, "build")) as tmp:
        _validate_on_card(tmp)
    gc.collect()
    torch.cuda.empty_cache()

    # the approximations' quality gate at full size
    out_json = os.path.join(root, "build", "quality_gate_rows.json")
    clips: dict = {}
    t0 = time.perf_counter()
    rc = quality_speed_gate.main(["--steps", "25", "--frames", "16", "--win-frames", "24",
                                  "--check", "--out", out_json], clips)
    dt = time.perf_counter() - t0
    with open(out_json) as f:
        rows = json.load(f)
    log(f"[quality] quality_speed_gate --check (full size, bf16, 25 steps, 16 and 24 "
        f"frames) on {gpu_line()}: exit {rc} in {dt:.1f} s; rows {json.dumps(rows)}")
    if rc != 0:
        raise SystemExit("quality: quality_speed_gate --check found a regression")
    exact, cached = clips["pose2vid exact (k=1)"], clips["encoder cache k=2"]
    with tempfile.NamedTemporaryFile(suffix=".npz", dir=os.path.join(root, "build")) as f:
        np.savez(f, **weights)
        f.flush()
        report = compare_videos(cached, exact, lpips_weights=f.name, device="cuda")
    row = next(r for r in rows if r["mode"] == "encoder cache k=2")
    log(f"[quality] compare_videos(encoder cache k=2, exact), LPIPS on the card: {report}")
    if (report["frames"] != 16 or abs(report["psnr"] - row["psnr"]) > 1e-9
            or not 0 <= report["lpips"] < 1e3):
        raise SystemExit(f"quality: compare_videos gave {report} against the row {row}")


# ----------------------------------------------------------------- training
def _train_batch(rs, b: int, res: int, clip_res: int, frames: int = 1):
    """A batch in the train_step contract: channels-last images in [-1, 1]."""
    import numpy as np

    img = lambda *s: rs.uniform(-1, 1, s).astype(np.float32)
    return {"pixel_values": img(b, frames, res, res, 3),
            "pixel_values_pose": img(b, frames, res, res, 3),
            "pixel_values_ref_img": img(b, res, res, 3),
            "clip_ref_image": rs.randn(b, clip_res, clip_res, 3).astype(np.float32)}


def train_reference_phase() -> None:
    """One stage-1 step of the micro model at 256 px, float32: GPU (kernels)
    vs CPU (plain versions) from the same weights, batch and draws."""
    import numpy as np
    import torch

    from aniportrait_tpu_torch import factory
    from aniportrait_tpu_torch.ops import kernels as K
    from aniportrait_tpu_torch.train import train_step as ts
    from aniportrait_tpu_torch.train.stage1 import Stage1Settings

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    settings = Stage1Settings()
    b, res = 2, 256
    cpu = factory.build_training_models(
        "micro", "cpu", seed=0, frozen_dtype=torch.float32,
        scheduler_kwargs=settings.scheduler_kwargs())
    rs = np.random.RandomState(4)
    batch = _train_batch(rs, b, res, cpu.clip.image_size)
    hl = res // 8
    draws = dict(eps_target=rs.randn(b, 4, hl, hl), eps_ref=rs.randn(b, 4, hl, hl),
                 noise=rs.randn(b, 1, 4, hl, hl), offset=rs.randn(b, 1, 4, 1, 1))
    t = rs.randint(0, 1000, (b,))
    loss, grads = {}, {}
    for device, modules in (("cuda", cpu.to("cuda")), ("cpu", cpu)):
        trainable = ts.apply_freeze(modules)
        opt = ts.make_optimizer(trainable)
        step_draws = ts.Draws(
            **{k: torch.from_numpy(v.astype(np.float32)).to(device) for k, v in draws.items()},
            uncond=torch.tensor(False, device=device),
            t=torch.from_numpy(t).to(device))
        K.reset_launch_counts()
        out = ts.train_step(modules, opt, {k: torch.from_numpy(v).to(device)
                                           for k, v in batch.items()},
                            draws=step_draws, uncond_ratio=settings.uncond_ratio)
        loss[device] = float(out["loss"])
        grads[device] = {k: p.grad.float().cpu() for k, p in trainable.items()}
        if device == "cuda":  # with the float32 flash forward's 3xTF32 calls
            counts = dict(K.launch_counts(), tf32x3=tensor_core_counts()["tf32x3"])
    scale = max(g.abs().max().item() for g in grads["cpu"].values())
    err = max((grads["cuda"][k] - g).abs().max().item() for k, g in grads["cpu"].items())
    loss_err = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
    log(f"[train-reference] micro {res}px train_bs {b} float32, one step: loss gpu "
        f"{loss['cuda']:.7f} cpu {loss['cpu']:.7f} (rel err {loss_err:.2e}, tol "
        f"{TRAIN_LOSS_RTOL:g}); {len(grads['cpu'])} trainable tensors, max |grad gpu - "
        f"cpu| = {err:.3e} = {err / scale:.2e} of the largest gradient {scale:.3e} "
        f"(tol {TRAIN_GRAD_TOL:g}); kernel launches on the GPU step {counts}")
    if not math.isfinite(loss["cuda"]) or loss_err > TRAIN_LOSS_RTOL:
        raise SystemExit("train reference phase: GPU loss disagrees with CPU")
    if not err <= TRAIN_GRAD_TOL * scale:
        raise SystemExit("train reference phase: GPU gradients disagree with CPU")
    missing = [k for k in ("K2", "K5a", "K5b", "tf32x3") if counts[k] == 0]
    if missing:
        raise SystemExit(f"train reference phase: kernels {missing} never launched")


def _profile_families(prof, wall_s: float):
    """Device seconds by kernel family from a torch.profiler run, and the
    device's idle share of the wall time.  Where the profile has the
    device-side ranges of ``K3_BACKWARD`` (K3's plain-autograd backward,
    ``ops/kernels/autograd.py``; recorded with CPU activity on), the kernels
    inside them form a family of their own."""
    from aniportrait_tpu_torch.ops.kernels.autograd import K3_BACKWARD

    families = (("flash backward (K5b; bf16: tensor cores)", ("flash_bwd",)),
                ("flash forward, tensor cores (bf16 K1, K2, K4, K5a)", ("flash_fwd_sm90",)),
                ("flash forward, 3xTF32 tensor cores (float32, d <= 128)",
                 ("flash_fwd_tf32x3",)),
                ("flash forward, FMA (float32, d > 128)", ("flash_fwd",)),
                ("temporal (K3; bf16: tensor cores)", ("temporal_kernel",)),
                ("short sequences (K6, K9)", ("ctg_kernel", "ssa_kernel")),
                ("GEMM", ("gemm", "cutlass", "xmma", "cublas", "matmul")),
                ("convolution", ("conv", "cudnn", "implicit", "winograd", "fft")),
                ("norm", ("norm",)),
                ("optimizer", ("multi_tensor", "foreach", "adam")))
    is_device = lambda evt: (evt.device_type is not None
                             and "cuda" in str(evt.device_type).lower())
    events = prof.events()
    # the device copies of host ranges (user annotations) carry the host
    # range's name; kernels never do
    host_names = {e.name for e in events if not is_device(e)}
    k3_ranges = sorted((e.time_range.start, e.time_range.end) for e in events
                       if is_device(e) and e.name == K3_BACKWARD)
    kernels = [e for e in events if is_device(e) and e.name not in host_names
               and e.name != K3_BACKWARD]
    totals, busy = {}, 0.0
    if kernels:
        import bisect

        starts = [a for a, _ in k3_ranges]
        for evt in kernels:
            us = evt.time_range.end - evt.time_range.start
            i = bisect.bisect_right(starts, evt.time_range.start) - 1
            if i >= 0 and evt.time_range.end <= k3_ranges[i][1]:
                fam = f"{K3_BACKWARD} (autograd of plain_nat_temporal)"
            else:
                name = evt.name.lower()
                fam = next((f for f, keys in families if any(k in name for k in keys)),
                           "elementwise, reductions, copies")
            totals[fam] = totals.get(fam, 0.0) + us / 1e6
            busy += us / 1e6
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        name = evt.key.lower()
        if us and is_device(evt) and ("_sm90_kernel" in name or "kernel_mma" in name
                                      or "tf32x3_kernel" in name):
            # the tensor-core kernels by instantiation: calls and device time
            m = re.search(r"(\w+_kernel\w*<[^>]*>)", evt.key)
            log(f"[profile] {m.group(1) if m else evt.key[:100]}: {evt.count} calls, "
                f"{us / 1e3:.3f} ms")
    return totals, busy, (1.0 - busy / wall_s if busy else None)


def training_phase(results: dict) -> None:
    """The stage-1 trainer at SD-1.5 widths: 512x512, train_bs 2, bf16
    compute, float32 AdamW, seeded random batches."""
    import numpy as np
    import torch

    from aniportrait_tpu_torch import factory
    from aniportrait_tpu_torch.ops import kernels as K
    from aniportrait_tpu_torch.train.stage1 import Stage1Settings, train

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    settings = Stage1Settings(seed=0)
    res, b = settings.sample_size[0], settings.train_bs
    t0 = time.perf_counter()
    modules = factory.build_training_models("full", "cuda", seed=0,
                                            scheduler_kwargs=settings.scheduler_kwargs())
    torch.cuda.synchronize()
    log(f"[training] full-size training models built on the GPU in "
        f"{time.perf_counter() - t0:.1f} s")
    named = {f"{m}.{n}": p for m, mod in modules.models().items()
             for n, p in mod.named_parameters()}
    frozen_keys = [k for k in named if k.startswith(
        ("reference_unet.up_blocks.3.", "vae.", "clip."))]
    frozen = {k: named[k].detach().clone() for k in frozen_keys}
    probes = ("reference_unet.down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight",
              "denoising_unet.conv_in.weight", "pose_guider.final_proj.weight")
    before = {k: named[k].detach().clone() for k in probes}
    stats = {k: v.clone() for k, v in modules.pose_guider.state_dict().items()
             if "running" in k}
    clip_res = modules.clip.image_size
    rs = np.random.RandomState(0)

    from torch.profiler import ProfilerActivity, profile, schedule

    # one train() call of TRAIN_STEPS + 1 steps; the profiler records only
    # the last one (device activity only, to keep its host cost small), one
    # step after a warm-up step
    prof = profile(activities=[ProfilerActivity.CUDA],
                   schedule=schedule(wait=TRAIN_STEPS - 1, warmup=1, active=1))

    def batches():  # the trainer asks for the next batch when a step is done
        for _ in range(TRAIN_STEPS + 1):
            yield _train_batch(rs, b, res, clip_res)
            prof.step()

    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with prof:
        history = train(settings, modules, batches(), max_steps=TRAIN_STEPS + 1,
                        device="cuda")
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for h in history:
        log(f"[training] step {h['step']}: loss {h['loss']:.6f} grad norm "
            f"{h['grad_norm']:.4f} {h['seconds']:.3f} s")
    steady = [h["seconds"] for h in history[1:TRAIN_STEPS - 1]]
    trained = sum(p.numel() for p in named.values() if p.requires_grad)
    log(f"[training] {res}x{res} train_bs {b} bf16 compute, float32 AdamW over "
        f"{trained / 1e9:.3f} B trainable parameters: steps 1-{TRAIN_STEPS - 2} (not "
        f"profiled) {', '.join(f'{t:.3f}' for t in steady)} s, mean "
        f"{sum(steady) / len(steady):.3f} s; peak device memory {peak:.2f} GiB; "
        f"kernel launches {counts}")
    wall = history[-1]["seconds"]
    totals, busy, idle = _profile_families(prof, wall)
    if busy:
        shares = ", ".join(f"{f} {s:.3f} s ({s / busy:.1%})"
                           for f, s in sorted(totals.items(), key=lambda x: -x[1]))
        log(f"[training] profiled step {history[-1]['step']}: {wall:.3f} s wall, "
            f"{busy:.3f} s device busy, idle share {idle:.1%}; by family: {shares}")
    else:
        log("[training] profiled step: the profiler gave no device time (not measured)")

    losses = [h["loss"] for h in history]
    if len(history) != TRAIN_STEPS + 1 or not all(map(math.isfinite, losses)):
        raise SystemExit(f"training: losses {losses}")
    moved = [k for k in probes if not torch.equal(before[k], named[k].detach())]
    if not moved:
        raise SystemExit("training: no trained parameter moved")
    changed = [k for k in frozen_keys if not torch.equal(frozen[k], named[k].detach())]
    if changed or not frozen_keys:
        raise SystemExit(f"training: frozen parameters changed: {changed[:5]}")
    new_stats = modules.pose_guider.state_dict()
    if all(torch.equal(v, new_stats[k]) for k, v in stats.items()):
        raise SystemExit("training: the PoseGuider's running statistics did not change")
    never = [k for k in ("K2", "K5a", "K5b") if counts[k] == 0]
    if never:
        raise SystemExit(f"training: kernels {never} never launched on the main path")
    tensor_core_check("training", ("forward", "backward"))
    log(f"[training] ok: {len(moved)}/{len(probes)} probed trained tensors moved, "
        f"{len(frozen_keys)} frozen tensors unchanged, running statistics updated")
    for kid in ("K5a", "K5b"):
        results.setdefault(kid, {})["launches"] = counts[kid]


# ------------------------------------------------------------- stage 2
TRAIN2_STEPS = 5  # stage-2 trainer steps before the profiled one (>= 4)
TRAIN2_8BIT_STEPS = 2


def unet_attention_walk(unet, hlat: int, wlat: int):
    """``(kind, s, module)`` of every spatial transformer (kind "spatial")
    and motion module ("motion") of one UNet call, in the order the forward
    runs them; ``s`` is the level's latent positions."""
    n = len(unet.down_blocks)
    sizes = [(hlat, wlat)]
    for _ in range(n - 1):
        sizes.append(((sizes[-1][0] + 1) // 2, (sizes[-1][1] + 1) // 2))
    blocks = [(b, i, unet.layers_per_block) for i, b in enumerate(unet.down_blocks)]
    blocks += [(unet.mid_block, n - 1, 1)]
    blocks += [(b, n - 1 - i, unet.layers_per_block + 1) for i, b in enumerate(unet.up_blocks)]
    for blk, level, layers in blocks:
        s = sizes[level][0] * sizes[level][1]
        for j in range(layers):
            for kind, name in (("spatial", "attentions"), ("motion", "motion_modules")):
                if hasattr(blk, name):
                    yield kind, s, getattr(blk, name)[j]


def stage2_reckoning(modules, height: int, width: int, frames: int,
                     checkpointing: bool) -> dict:
    """K2, K3, K4, K5a and K5b launches of one stage-2 step (train_bs 1,
    ``frames`` frames), from the models' structure and the routes of
    ``ops/attention.py``:

    * the VAE encoder's single-head mid-block attention on the frames and on
      the reference image (K4 only where its head is small: the test sizes);
    * the ReferenceNet on one frame, without gradients: its self attention
      (K2 where it routes there);
    * the PoseGuider's transformers on the frames, without gradients (K4);
    * the denoising UNet on the frames: each spatial self attention reads
      the bank through the bank-drop mask (``drop_mode='traced'``), the K4
      route; before the first motion module nothing needs a gradient and it
      runs K4, after it K5a forward and K5b backward; each temporal
      attention runs K3 forward (its backward is plain autograd);
    * with gradient checkpointing every block that records a gradient runs
      its forward again in the backward: K5a and K3 twice."""
    from collections import Counter

    from aniportrait_tpu_torch.ops.attention import attention_route, sdpa_route

    hlat, wlat = height // 8, width // 8
    rerun = 2 if checkpointing else 1
    counts = Counter(pose_guider_routes(modules.pose_guider, height, width, frames))
    vae_d = modules.vae.encoder.conv_out.in_channels  # one head over the latent grid
    for rows in (frames, 1):  # the target frames, then the reference image
        counts[sdpa_route(rows, hlat * wlat, hlat * wlat, 1, vae_d)] += 1
    for kind, s, st in unet_attention_walk(modules.reference_unet, hlat, wlat):
        for block in st.transformer_blocks:
            h = block.attn1.heads
            counts[attention_route(1, s, s, h, block.attn1.to_q.out_features // h)] += 1
    grad = False
    for kind, s, mod in unet_attention_walk(modules.denoising_unet, hlat, wlat):
        if kind == "motion":
            grad = True
            for block in mod.temporal_transformer.transformer_blocks:
                for attn in block.attention_blocks:
                    d = attn.to_q.out_features // attn.heads
                    counts[attention_route(1, s, s, attn.heads, d, frames=frames)] += rerun
            continue
        for block in mod.transformer_blocks:
            h = block.attn1.heads
            route = sdpa_route(frames, s, 2 * s, h, block.attn1.to_q.out_features // h,
                               masked=True)
            if route == "K4" and grad:
                counts["K5a"] += rerun
                counts["K5b"] += 1
            else:
                counts[route] += 1
    return {kid: counts[kid] for kid in ("K2", "K3", "K4", "K5a", "K5b")}


def train2_reference_phase() -> None:
    """One stage-2 step of the micro model at 256 px, 8 frames, float32,
    gradient checkpointing on: the card (kernels) against the CPU (plain
    versions) from the same weights, batch and draws."""
    import numpy as np
    import torch

    from aniportrait_tpu_torch import factory
    from aniportrait_tpu_torch.ops import kernels as K
    from aniportrait_tpu_torch.train import train_step as ts
    from aniportrait_tpu_torch.train.stage2 import Stage2Settings

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    settings = Stage2Settings()
    b, frames, res = 1, 8, 256
    cpu = factory.build_training_models(
        "micro", "cpu", seed=0, frozen_dtype=torch.float32, stage=2,
        gradient_checkpointing=True, scheduler_kwargs=settings.scheduler_kwargs())
    rs = np.random.RandomState(5)
    batch = _train_batch(rs, b, res, cpu.clip.image_size, frames)
    hl = res // 8
    draws = dict(eps_target=rs.randn(b * frames, 4, hl, hl), eps_ref=rs.randn(b, 4, hl, hl),
                 noise=rs.randn(b, frames, 4, hl, hl), offset=rs.randn(b, 1, 4, 1, 1))
    t = rs.randint(0, 1000, (b,))
    loss, grads = {}, {}
    for device, modules in (("cuda", cpu.to("cuda")), ("cpu", cpu)):
        trainable = ts.apply_freeze(modules, stage=2)
        opt = ts.make_optimizer(trainable)
        step_draws = ts.Draws(
            **{k: torch.from_numpy(v.astype(np.float32)).to(device) for k, v in draws.items()},
            uncond=torch.tensor(False, device=device), t=torch.from_numpy(t).to(device))
        K.reset_launch_counts()
        out = ts.train_step(modules, opt, {k: torch.from_numpy(v).to(device)
                                           for k, v in batch.items()},
                            draws=step_draws, uncond_ratio=settings.uncond_ratio)
        loss[device] = float(out["loss"])
        grads[device] = {k: p.grad.float().cpu() for k, p in trainable.items()}
        if device == "cuda":
            counts = K.launch_counts()
            want = stage2_reckoning(modules, res, res, frames, checkpointing=True)
    scale = max(g.abs().max().item() for g in grads["cpu"].values())
    err = max((grads["cuda"][k] - g).abs().max().item() for k, g in grads["cpu"].items())
    loss_err = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
    got = {k: counts[k] for k in want}
    log(f"[train2-reference] micro stage 2, {res}px, {frames} frames, float32, gradient "
        f"checkpointing: loss gpu {loss['cuda']:.7f} cpu {loss['cpu']:.7f} (rel err "
        f"{loss_err:.2e}, tol {TRAIN_LOSS_RTOL:g}); {len(grads['cpu'])} motion-module "
        f"tensors, max |grad gpu - cpu| = {err:.3e} = {err / scale:.2e} of the largest "
        f"gradient {scale:.3e} (tol {TRAIN_GRAD_TOL:g}); launches {got}, reckoned {want}")
    if not math.isfinite(loss["cuda"]) or loss_err > TRAIN_LOSS_RTOL:
        raise SystemExit("train2 reference phase: GPU loss disagrees with CPU")
    if not err <= TRAIN_GRAD_TOL * scale:
        raise SystemExit("train2 reference phase: GPU gradients disagree with CPU")
    if got != want or not got["K3"] or not got["K5b"]:
        raise SystemExit(f"train2 reference phase: launches {got} != reckoning {want}")


def train2_phase(results: dict) -> None:
    """The stage-2 trainer at SD-1.5 widths with the motion modules of
    inference_v2.yaml: 512x512, 16 frames, train_bs 1, bf16 compute with the
    frozen weights in bf16, float32 AdamW over the motion modules, gradient
    checkpointing, seeded random batches: TRAIN2_STEPS steps and a profiled
    one; then TRAIN2_8BIT_STEPS steps with 8-bit AdamW."""
    import numpy as np
    import torch

    from aniportrait_tpu_torch import factory
    from aniportrait_tpu_torch.ops import kernels as K
    from aniportrait_tpu_torch.train.optim8bit import state_bytes
    from aniportrait_tpu_torch.train.stage2 import Stage2Settings, train
    from aniportrait_tpu_torch.train.train_step import apply_freeze, make_optimizer

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    settings = Stage2Settings(seed=0)
    res, b, frames = settings.sample_size[0], settings.train_bs, settings.sample_n_frames
    t0 = time.perf_counter()
    modules = factory.build_training_models(
        "full", "cuda", seed=0, stage=2, gradient_checkpointing=True,
        scheduler_kwargs=settings.scheduler_kwargs())
    torch.cuda.synchronize()
    log(f"[train2] full-size stage-2 models built on the GPU in "
        f"{time.perf_counter() - t0:.1f} s")
    trainable = apply_freeze(modules, stage=2)
    named = {f"{m}.{n}": p for m, mod in modules.models().items()
             for n, p in mod.named_parameters()}
    # the copies the checks compare with live on the host, out of the peak
    host = lambda p: p.detach().to("cpu", copy=True)
    frozen = {k: host(p) for k, p in named.items() if k not in trainable}
    before = {k: host(p) for k, p in trainable.items()}
    n_train = sum(p.numel() for p in trainable.values())
    dtypes = sorted({str(p.dtype) for k, p in named.items() if k not in trainable
                     and ".motion_modules." not in k})
    clip_res = modules.clip.image_size
    rs = np.random.RandomState(0)
    want = stage2_reckoning(modules, res, res, frames, settings.gradient_checkpointing)

    from torch.profiler import ProfilerActivity, profile, schedule

    # the last step profiled with host activity on, so that the device
    # copies of the K3_BACKWARD ranges mark K3's plain backward
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=TRAIN2_STEPS - 1, warmup=1, active=1))

    def batches(n, profiled):
        for _ in range(n):
            yield _train_batch(rs, b, res, clip_res, frames)
            if profiled:
                prof.step()

    opt = make_optimizer(trainable, settings.learning_rate, settings.adam_weight_decay,
                         (settings.adam_beta1, settings.adam_beta2), settings.adam_epsilon)
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with prof:
        history = train(settings, modules, batches(TRAIN2_STEPS + 1, True),
                        max_steps=TRAIN2_STEPS + 1, device="cuda", optimizer=opt)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    fp32_bytes = state_bytes(opt)
    for h in history:
        log(f"[train2] step {h['step']}: loss {h['loss']:.6f} grad norm "
            f"{h['grad_norm']:.4f} {h['seconds']:.3f} s")
    steady = [h["seconds"] for h in history[1:TRAIN2_STEPS - 1]]
    steps = len(history)
    got = {k: counts[k] for k in want}
    log(f"[train2] {res}x{res} {frames} frames train_bs {b} bf16 compute (frozen weights "
        f"{', '.join(dtypes)}), float32 AdamW over {n_train / 1e6:.1f} M motion-module "
        f"parameters, gradient checkpointing: steps 1-{TRAIN2_STEPS - 2} (not profiled) "
        f"{', '.join(f'{t:.3f}' for t in steady)} s, mean {sum(steady) / len(steady):.3f} "
        f"s; peak device memory {peak:.2f} GiB; launches over {steps} steps {got}, "
        f"reckoned {steps} x {want}")
    wall = history[-1]["seconds"]
    totals, busy, idle = _profile_families(prof, wall)
    if busy:
        shares = ", ".join(f"{f} {s:.3f} s ({s / busy:.1%})"
                           for f, s in sorted(totals.items(), key=lambda x: -x[1]))
        log(f"[train2] profiled step {history[-1]['step']}: {wall:.3f} s wall, "
            f"{busy:.3f} s device busy, idle share {idle:.1%}; by family: {shares}")
    else:
        log("[train2] profiled step: the profiler gave no device time (not measured)")
    del prof

    losses = [h["loss"] for h in history]
    if steps != TRAIN2_STEPS + 1 or not all(map(math.isfinite, losses)):
        raise SystemExit(f"train2: losses {losses}")
    still = [k for k, p in trainable.items() if torch.equal(before[k], host(p))]
    if still:
        raise SystemExit(f"train2: {len(still)} motion-module tensors did not move: "
                         f"{still[:5]}")
    changed = [k for k, v in frozen.items() if not torch.equal(v, host(named[k]))]
    if changed or not frozen:
        raise SystemExit(f"train2: frozen parameters changed: {changed[:5]}")
    if got != {k: v * steps for k, v in want.items()}:
        raise SystemExit(f"train2: launches {got} != {steps} x reckoning {want}")
    tensor_core_check("train2", ("forward", "backward", "temporal"))
    for kid in ("K5a", "K5b"):
        results.setdefault(f"{kid}.stage2", {})["launches"] = counts[kid]
    del opt
    gc.collect()
    torch.cuda.empty_cache()

    # 8-bit AdamW over the same motion modules
    opt8 = make_optimizer(trainable, settings.learning_rate, settings.adam_weight_decay,
                          (settings.adam_beta1, settings.adam_beta2), settings.adam_epsilon,
                          adam_8bit=True)
    before = {k: host(p) for k, p in trainable.items()}
    history = train(settings, modules, batches(TRAIN2_8BIT_STEPS, False),
                    max_steps=TRAIN2_8BIT_STEPS, device="cuda", optimizer=opt8)
    bytes8 = state_bytes(opt8)
    moved = sum(not torch.equal(before[k], host(p)) for k, p in trainable.items())
    log(f"[train2] 8-bit AdamW: {len(history)} steps, losses "
        f"{', '.join(f'{h['loss']:.6f}' for h in history)}, "
        f"{', '.join(f'{h['seconds']:.3f}' for h in history)} s; {moved}/{len(trainable)} "
        f"motion-module tensors moved; optimizer state {bytes8 / 2**20:.1f} MiB "
        f"({bytes8 / n_train:.3f} B/parameter) against float32 AdamW's "
        f"{fp32_bytes / 2**20:.1f} MiB ({fp32_bytes / n_train:.3f} B/parameter)")
    if (len(history) != TRAIN2_8BIT_STEPS
            or not all(math.isfinite(h["loss"]) for h in history) or moved == 0
            or not bytes8 < fp32_bytes / 3):
        raise SystemExit("train2: the 8-bit AdamW steps failed")
    changed = [k for k, v in frozen.items() if not torch.equal(v, host(named[k]))]
    if changed:
        raise SystemExit(f"train2: frozen parameters changed under 8-bit AdamW: "
                         f"{changed[:5]}")
    log(f"[train2] ok: {len(trainable)} motion-module tensors moved, {len(frozen)} frozen "
        f"tensors unchanged, launches as reckoned")


# ------------------------------------------------------- token-kernel A/B
def _crafted(kind: str):
    """The crafted inputs of tests/test_pallas_attention.py, float32, one
    head of 8 over 16 tokens: ``orthogonal`` (huge-norm q along e0, k along
    e1, every true logit 0) or ``overflow`` (one logit of 1e3 / sqrt(8))."""
    import numpy as np
    import torch

    rs = np.random.RandomState(6)
    q = np.zeros((1, 16, 8), np.float32)
    if kind == "orthogonal":
        q[..., 0] = 1e4
        k = np.zeros((1, 16, 8), np.float32)
        k[..., 1] = 1e4
    else:
        q[..., 0] = 1e3
        k = (0.01 * rs.randn(1, 16, 8)).astype(np.float32)
        k[:, 3, 0] = 1.0
    v = rs.randn(1, 16, 8).astype(np.float32)
    return [torch.from_numpy(x).cuda() for x in (q, k, v)]


def guard_checks() -> None:
    """Each fixed-shift variant's guard on the crafted inputs: the flag is
    set exactly where the JAX guard falls back (tests/test_pallas_attention.py
    :288-346, :376-411), the output is then the running max's, bit for bit,
    and where all logits are equal it is the uniform mean of v."""
    import torch

    from aniportrait_tpu_torch.ops import kernels as K

    cases = (("K7", K.tok_flash_noshift, "overflow", True),
             ("K7", K.tok_flash_noshift, "orthogonal", False),
             ("K8", K.tok_flash_bounded, "orthogonal", True),
             ("K2u", K.tok_flash_unshifted, "overflow", True))
    failed = []
    for kid, fn, kind, tripped in cases:
        q, k, v = _crafted(kind)
        got = fn(q, k, v, 1)
        flag = fn.last_guard.item()
        ok = flag == int(tripped)
        if tripped:
            ok &= torch.equal(got, K.tok_flash(q, k, v, 1))
        if kind == "orthogonal":
            uniform = v.mean(1, keepdim=True).expand_as(got)
            ok &= torch.allclose(got, uniform, atol=2e-5, rtol=1e-4)
        log(f"[tok-ab] guard {kid} on {kind} inputs: flag {flag} (JAX falls back: "
            f"{tripped}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{kid} {kind}")
    if failed:
        raise SystemExit(f"guard checks failed: {failed}")


def tok_ab_phase(results: dict) -> None:
    """The token-kernel A/B entry at its four full shapes, bf16."""
    from aniportrait_tpu_torch.ops import kernels as K
    from aniportrait_tpu_torch.scripts import bench_tok_kernel as ab

    guard_checks()
    K.reset_launch_counts()
    rows = ab.run("cuda", ab.SHAPES, 5, log=log)
    counts = K.launch_counts()
    log(f"[tok-ab] {gpu_line()}: kernel launches {counts}")
    atol = TOLERANCE["bfloat16"][0]
    bad = [f"{row['name']} {v}" for row in rows for v in ab.VARIANTS
           if row["guard_held"][v] is False
           or not row["max_abs_diff"][v] <= atol * row["runmax_max_abs"]]
    if bad or len(rows) != len(ab.SHAPES):
        raise SystemExit(f"tok-ab: guard tripped or variant off runmax: {bad}")
    never = [k for k in ("K7", "K8", "K2u") if counts[k] == 0]
    if never:
        raise SystemExit(f"tok-ab: kernels {never} never launched")
    for kid in ("K7", "K8", "K2u"):
        results.setdefault(kid, {})["launches"] = counts[kid]


def folded_small_seq_phase(results: dict) -> None:
    """The head-folded short-sequence path (``small_seq_attention_folded``,
    K9 through ``SsaPacked``) at the 512x512 request's top-level motion
    module: (B, S, H, D) = (8192, 16, 8, 40), 65536 sequences, bf16, forward
    and backward; then float32 gradients on the card against the CPU's at 64
    rows."""
    import torch
    import torch.nn.functional as F

    from aniportrait_tpu_torch.ops import kernels as K
    from aniportrait_tpu_torch.ops.attention import small_seq_attention_folded

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(1)

    def rand(*s, dtype=torch.bfloat16):
        return torch.randn(*s, generator=g, device="cuda", dtype=dtype)

    b, s, h, d = 8192, 16, 8, 40
    x = [rand(b, s, h, d).requires_grad_() for _ in range(3)]
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = small_seq_attention_folded(*x)
    out.backward(rand(b, s, h, d))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    tensor_core_check("tok-ab K9 path", ("small_seq",))
    if tensor_core_counts()["small_seq"] != counts["K9"]:
        raise SystemExit(f"K9 path: {tensor_core_counts()['small_seq']} of {counts['K9']} "
                         f"K9 launches on the tensor cores")
    # reference: the library's attention in float32 on the same bf16 inputs;
    # the bf16 output is held to the bf16 tolerance of its largest value
    ref = F.scaled_dot_product_attention(
        *(t.detach().float().transpose(1, 2) for t in x)).transpose(1, 2)
    diff = out.detach().float() - ref
    max_abs, rel = diff.abs().max().item(), (diff.norm() / ref.norm()).item()
    tol = TOLERANCE["bfloat16"][0] * ref.abs().max().item()
    ok = max_abs <= tol and rel <= TOLERANCE["bfloat16"][1]
    ok &= all(bool(torch.isfinite(t.grad).all()) for t in x)
    del ref, diff

    xs = [rand(64, s, h, d, dtype=torch.float32) for _ in range(4)]
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).requires_grad_() for t in xs[:3]]
        small_seq_attention_folded(*leaves).backward(xs[3].to(dev))
        grads[dev] = [t.grad.cpu() for t in leaves]
    scale = max(t.abs().max().item() for t in grads["cpu"])
    err = max((a - c).abs().max().item() for a, c in zip(grads["cuda"], grads["cpu"]))
    grad_tol = TOLERANCE["float32"][0] * scale
    log(f"[tok-ab] head-folded short sequences (K9) B={b} S={s} H={h} D={d} bf16, forward "
        f"+ backward {dt:.3f} s: vs the library's float32 forward max_abs_err={max_abs:.3e} "
        f"rel_l2={rel:.3e} (tol {tol:.3g}/{TOLERANCE['bfloat16'][1]:g}); float32 "
        f"gradients card vs CPU (64 rows) max err {err:.3e} (tol {grad_tol:.3g}); kernel "
        f"launches {counts}")
    if not ok or not err <= grad_tol:
        raise SystemExit("head-folded short-sequence path disagrees")
    if counts["K9"] == 0:
        raise SystemExit("head-folded short-sequence path: K9 never launched")
    results.setdefault("K9", {})["launches"] = counts["K9"]


# ------------------------------------------------------------ multi-rank
MULTI_RANKS = 2  # ranks of the multi phase: over gloo on one card, NCCL on two
MULTI_STEPS = 3  # DDIM steps of its sampler runs, trainer steps per optimizer
# the multi phase's bounds.  Micro float32 on the card: a rank's video
# equals the single process's within 1.5/255 (tests/test_parallel.py's: a
# uint8 rounding flip), and that run's PSNR is printed beside the bf16
# checks.  Full size in bf16, where a rank's UNet runs fewer rows than the
# single process's (other GEMM and convolution algorithms, other bf16
# roundings, grown by 3 steps of CFG 3.5): the frames' PSNR against the
# single process at least MULTI_PSNR_DB (an rmse of 8 levels; a shard that
# puts frames, windows or CFG halves in the wrong place gives noise-level
# frames, under 15 dB on these random inputs).  The bf16 step-1 loss of the
# data-parallel trainer against the single process's within
# MULTI_LOSS_RTOL (the losses' bf16 forward differ by row order and by the
# global BatchNorm statistics' summation); the micro float32 data-parallel
# step on the card against the CPU's single process: the loss within
# TRAIN_LOSS_RTOL and each weight within 2 lr + 1e-6 (Adam's first step
# moves a weight by ~lr * sign(g), and a gradient that is zero but for
# rounding may flip its sign).
# The data-parallel step's gradient, which Adam's first move (~lr * sign(g))
# hides: the micro float32 ranks' averaged gradients against the single
# process on the card within MULTI_GRAD_RTOL of the largest gradient (the
# CPU's float32 rounding, grown through the PoseGuider's eight BatchNorms,
# reached 3.3e-5; tests/test_torch_parallel.py), the norm before the clip
# within it, and where |g| is 10 x that bound each weight's move within
# MULTI_MOVE_TOL lr plus two float32 spacings of the weight (a sign flip is
# out there).  The full-size bf16 step-1 norm before the clip within
# MULTI_GRAD_NORM_RTOL, as the loss.
MULTI_MICRO_ATOL = 1.5 / 255
MULTI_PSNR_DB = 30.0
MULTI_LOSS_RTOL = 1e-2
MULTI_GRAD_NORM_RTOL = 1e-2
MULTI_MICRO_LR = 1e-5
MULTI_GRAD_RTOL = 1e-4
MULTI_MOVE_TOL = 1e-2


def psnr_db(a, b) -> float:
    """PSNR in dB of two float videos in [0, 1]."""
    import numpy as np

    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return math.inf if mse == 0 else 10 * math.log10(1.0 / mse)


def _micro_multi_cases():
    """The multi phase's micro float32 sampler runs on the card: the exact
    windowed path (context 8 / overlap 2, window batch 2) and window fusion
    over 12 frames at 256x256 px, 2 steps."""
    import numpy as np

    rs = np.random.RandomState(7)
    ref = rs.randint(0, 255, (256, 256, 3), np.uint8)
    poses = [rs.randint(0, 255, (256, 256, 3), np.uint8) for _ in range(12)]
    ctx = dict(context_frames=8, context_overlap=2)
    return [("windowed", dict(ctx, window_batch=2), ref, poses),
            ("fused", dict(ctx, window_fusion=True), ref, poses)]


def _micro_multi_videos(mesh):
    import torch

    from aniportrait_tpu_torch import factory
    from aniportrait_tpu_torch.pipelines import Pose2VideoPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    modules = factory.build_models("micro", "cuda", torch.float32, seed=0)
    return {name: Pose2VideoPipeline(modules, mesh=mesh, **kw)(
        ref, poses, None, 256, 256, len(poses), num_inference_steps=2, seed=1)
        for name, kw, ref, poses in _micro_multi_cases()}


def _multi_sampler_cases():
    """(name, label, pipeline options, case, width, height, frames) of the
    full-size bf16 sampler runs: (a) long clip A's exact windowed path, (b)
    the bench's default config's whole-clip path."""
    return [
        ("a", "exact windowed 576x768, 28 frames, 3 windows, window batch 3",
         dict(context_frames=16, context_overlap=4, window_batch=3),
         _long_clip_case("A", 200, 576, 768, 28), 576, 768, 28),
        ("b", "whole clip (bench default config) 512x512, 16 frames, CFG split",
         {}, _long_clip_case("B", 300, 512, 512, 16), 512, 512, 16),
    ]


def _dp_batches(n: int, res: int, clip_res: int, seed: int):
    import numpy as np

    rs = np.random.RandomState(seed)
    return [_train_batch(rs, 2, res, clip_res) for _ in range(n)]


def multi_rank(mesh) -> dict:
    """What each rank of the multi phase runs (see ``multi_phase``);
    returns its numbers and, from rank 0, the videos."""
    import hashlib

    import numpy as np
    import torch

    from aniportrait_tpu_torch import factory
    from aniportrait_tpu_torch.ops import kernels as K
    from aniportrait_tpu_torch.ops.kernels import build
    from aniportrait_tpu_torch.parallel.mesh import shard_batch
    from aniportrait_tpu_torch.pipelines import Pose2VideoPipeline
    from aniportrait_tpu_torch.train import optim8bit
    from aniportrait_tpu_torch.train.stage1 import Stage1Settings, train
    from aniportrait_tpu_torch.train.train_step import apply_freeze, make_optimizer

    build.library()  # the parent built it: this loads the same library
    rank = mesh.rank
    out = {"rank": rank, "backend": mesh.world.backend, "micro": _micro_multi_videos(mesh)}
    digest = lambda v: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    modules = factory.build_models("full", "cuda", torch.bfloat16, seed=rank)
    for name, _, kw, case, width, height, frames in _multi_sampler_cases():
        pipe = Pose2VideoPipeline(modules, dtype=torch.bfloat16, mesh=mesh, **kw)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        video = pipe(case["ref_image"], case["pose_images"], None, width, height, frames,
                     num_inference_steps=MULTI_STEPS, guidance_scale=3.5, seed=0)
        out[name] = dict(seconds=time.perf_counter() - t0, counts=K.launch_counts(),
                         phases=pipe.timer.report(), digest=digest(video),
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                         window_batch=pipe.window_batch)
        if rank == 0:
            out[name]["video"] = np.round(video * 255).astype(np.uint8)
        del pipe, video

    # the motion module's all-to-all at full width: the top level's module
    # (320 channels, 64x64 positions, 16 frames) on this rank's 8 frames
    # against the unsharded module on all 16, in float32 and bf16
    from aniportrait_tpu_torch.parallel.mesh import FrameShard, frame_sizes

    mm = modules.denoising_unet.down_blocks[0].motion_modules[0]
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((16, 320, 64, 64), generator=gen, device="cuda")
    shard = FrameShard(mesh.world, frame_sizes(16, mesh.size))
    a2a = {}
    for dtype in (torch.float32, torch.bfloat16):
        mmd = mm.to(dtype)
        torch.backends.cuda.matmul.allow_tf32 = dtype != torch.float32
        torch.backends.cudnn.allow_tf32 = dtype != torch.float32
        with torch.no_grad():
            whole = mmd(x.to(dtype), 16)[shard.block].float()
            K.reset_launch_counts()
            part = mmd(x[shard.block].to(dtype), shard.sizes[rank], None, shard).float()
            counts = K.launch_counts()
        a2a[str(dtype).split(".")[-1]] = dict(
            err=float((part - whole).abs().max()), scale=float(whole.abs().max()),
            k3=counts["K3"], positions=frame_sizes(64 * 64, mesh.size)[rank])
    out["a2a"] = a2a
    del modules, mm, x
    gc.collect()
    torch.cuda.empty_cache()

    # (c) data-parallel stage-1 steps at full width: this rank's row of each
    # train_bs 2 batch, float32 AdamW under ZeRO-1, then 8-bit AdamW
    settings = Stage1Settings(seed=0)
    train_models = factory.build_training_models(
        "full", "cuda", seed=rank, scheduler_kwargs=settings.scheduler_kwargs())
    trainable = apply_freeze(train_models)
    batches = _dp_batches(MULTI_STEPS, settings.sample_size[0],
                          train_models.clip.image_size, seed=11)
    out["train"] = {}
    for eight in (False, True):
        opt = make_optimizer(trainable, settings.learning_rate, settings.adam_weight_decay,
                             adam_8bit=eight, mesh=mesh)
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        history = train(settings, train_models, [shard_batch(b, mesh) for b in batches],
                        max_steps=MULTI_STEPS, device="cuda", optimizer=opt, mesh=mesh)
        out["train"]["8-bit" if eight else "float32"] = dict(
            history=history, counts=K.launch_counts(),
            state_bytes=optim8bit.state_bytes(opt),
            peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        if not eight:
            out["gather"] = _zero1_gather(opt)
        del opt
        gc.collect()
        torch.cuda.empty_cache()
    del train_models, trainable
    gc.collect()
    torch.cuda.empty_cache()

    # a micro float32 data-parallel step on the card (the parent holds it to
    # the CPU's single process on the global batch and the same draws)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out["micro_dp"] = micro_dp_step(mesh, "cuda")

    out["collective_gbps"] = _collective_rates(mesh)
    return out


def _zero1_gather(opt) -> dict:
    """``opt.gather_state()`` (a ZeRO-1 checkpoint's gather to rank 0), timed,
    with the device and host peaks, and a float64 sum of each state tensor:
    of the ones this rank owns, and on rank 0 of every gathered one."""
    import resource

    import torch

    index = {p: i for i, p in enumerate(opt.params)}
    total = lambda st: {k: float(torch.sum(v, dtype=torch.float64))
                        for k, v in st.items() if torch.is_tensor(v)}
    own = {index[p]: total(st) for p, st in opt.state.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    gathered = opt.gather_state()
    seconds = time.perf_counter() - t0
    return dict(seconds=seconds, own=own, params=len(opt.params),
                device_extra_gib=(torch.cuda.max_memory_allocated() - base) / 2**30,
                host_peak_gib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
                gathered={index[p]: total(st) for p, st in gathered.items()},
                gathered_bytes=sum(v.nbytes for st in gathered.values()
                                   for v in st.values() if torch.is_tensor(v)))


def _collective_rates(mesh) -> dict:
    """GB/s of the port's all_reduce and broadcast (``parallel.mesh.Group``)
    on 256 MiB of float32 on the card, and over gloo, which stages card
    tensors through pinned host memory itself, of the same with the staging
    done here: the comparison that let the port drop its own."""
    import torch
    import torch.distributed as dist

    from aniportrait_tpu_torch.parallel.mesh import broadcast_tensors_

    buf = torch.ones(1 << 26, device="cuda")

    def staged(op):
        host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        host.copy_(buf)
        op(host)
        buf.copy_(host)

    runs = {"all_reduce": lambda: mesh.world.all_reduce_(buf),
            "broadcast": lambda: broadcast_tensors_([buf], mesh.world, 0)}
    if mesh.world.backend == "gloo":
        runs["all_reduce staged here"] = lambda: staged(dist.all_reduce)
        runs["broadcast staged here"] = lambda: staged(lambda t: dist.broadcast(t, 0))
    rates = {}
    for name, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        rates[name] = buf.nbytes / (time.perf_counter() - t0) / 1e9
    return rates


def micro_dp_step(mesh, device: str) -> dict:
    """One micro float32 stage-1 step on ``device`` of this rank's rows of a
    global batch (train_bs 4 at 64 px) with the global batch's draws, from
    numpy seeds: the models built on the CPU from seed 0, the BatchNorm
    synchronised and the optimizer sharded over ``mesh`` (None: one
    process).  Returns the loss, the gradient norm before the clip, the
    trainables before and after the step and their gradients as the
    optimizer took them (averaged over the ranks, clipped)."""
    import numpy as np
    import torch

    from aniportrait_tpu_torch import factory
    from aniportrait_tpu_torch.models.pose_guider import sync_batch_norm
    from aniportrait_tpu_torch.parallel.mesh import shard_batch, shard_rows
    from aniportrait_tpu_torch.train import train_step as ts
    from aniportrait_tpu_torch.train.stage1 import Stage1Settings

    settings = Stage1Settings(mixed_precision="no")
    modules = factory.build_training_models(
        "micro", "cpu", seed=0, frozen_dtype=torch.float32,
        scheduler_kwargs=settings.scheduler_kwargs()).to(device)
    b, res = 4, 64
    rs = np.random.RandomState(12)
    batch = _train_batch(rs, b, res, modules.clip.image_size)
    hl = res // 8
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    draws = ts.Draws(eps_target=t(rs.randn(b, 4, hl, hl)), eps_ref=t(rs.randn(b, 4, hl, hl)),
                     uncond=torch.tensor(False, device=device),
                     noise=t(rs.randn(b, 1, 4, hl, hl)), offset=t(rs.randn(b, 1, 4, 1, 1)),
                     t=torch.from_numpy(rs.randint(0, 1000, (b,))).to(device))
    trainable = ts.apply_freeze(modules)
    if mesh is not None:
        sync_batch_norm(modules.pose_guider, mesh.world)
        rows = shard_rows(b, mesh.size, mesh.rank)
        batch, draws = shard_batch(batch, mesh), draws.rows(rows.start, rows.stop)
    opt = ts.make_optimizer(trainable, MULTI_MICRO_LR, mesh=mesh)
    before = {k: p.detach().cpu().numpy().copy() for k, p in trainable.items()}
    out = ts.train_step(modules, opt, {k: torch.from_numpy(v).to(device)
                                       for k, v in batch.items()},
                        draws=draws, mesh=mesh)
    return dict(loss=float(out["loss"]), grad_norm=float(out["grad_norm"]), before=before,
                params={k: p.detach().cpu().numpy() for k, p in trainable.items()},
                grads={k: p.grad.cpu().numpy() for k, p in trainable.items()})


def step_mismatch(got: dict, want: dict, lr: float) -> dict:
    """How far ``got``'s optimizer step (``micro_dp_step``'s keys) is from
    ``want``'s, which starts from the same weights: the norm's relative
    difference, the gradients' largest difference over the largest
    gradient, and the weights whose gradient's sign is clear (|g| over 10 x
    ``MULTI_GRAD_RTOL`` of the largest) that moved otherwise than ``want``'s
    (by more than ``MULTI_MOVE_TOL`` lr plus two float32 spacings) or by
    less than lr / 2."""
    import numpy as np

    scale = max(float(np.abs(g).max()) for g in want["grads"].values())
    grad = max(float(np.abs(got["grads"][k] - g).max()) for k, g in want["grads"].items())
    clear_n = off = still = 0
    for k, g in want["grads"].items():
        w0 = want["before"][k].astype(np.float64)
        moved, want_moved = got["params"][k] - w0, want["params"][k] - w0
        clear = np.abs(g) > 10 * MULTI_GRAD_RTOL * scale
        bound = MULTI_MOVE_TOL * lr + 2 * np.spacing(np.abs(w0))
        clear_n += int(clear.sum())
        off += int((clear & (np.abs(moved - want_moved) > bound)).sum())
        still += int((clear & (np.abs(moved) <= lr / 2)).sum())
    return dict(norm=abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"],
                grad=grad / scale, clear=clear_n, off=off, still=still)


def multi_phase() -> None:
    """The sharded sampler and the data-parallel trainer at MULTI_RANKS ranks
    (gloo on the one card, or NCCL with a card each), against this
    process's single-process runs of the same work (see the module doc)."""
    import numpy as np
    import torch

    from aniportrait_tpu_torch import factory
    from aniportrait_tpu_torch.ops.kernels import build
    from aniportrait_tpu_torch.parallel.launch import spawn
    from aniportrait_tpu_torch.pipelines import Pose2VideoPipeline
    from aniportrait_tpu_torch.train.stage1 import Stage1Settings, train

    t_phase = time.perf_counter()
    build.library()  # once here, so the ranks do not both run nvcc
    single = {"micro": _micro_multi_videos(None)}
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    modules = factory.build_models("full", "cuda", torch.bfloat16, seed=0)
    for name, _, kw, case, width, height, frames in _multi_sampler_cases():
        pipe = Pose2VideoPipeline(modules, dtype=torch.bfloat16, **kw)
        t0 = time.perf_counter()
        video = pipe(case["ref_image"], case["pose_images"], None, width, height, frames,
                     num_inference_steps=MULTI_STEPS, guidance_scale=3.5, seed=0)
        single[name] = dict(seconds=time.perf_counter() - t0,
                            video=np.round(video * 255).astype(np.uint8))
    del modules, pipe
    gc.collect()
    torch.cuda.empty_cache()
    settings = Stage1Settings(seed=0)
    train_models = factory.build_training_models(
        "full", "cuda", seed=0, scheduler_kwargs=settings.scheduler_kwargs())
    batches = _dp_batches(1, settings.sample_size[0], train_models.clip.image_size, seed=11)
    t0 = time.perf_counter()
    history = train(settings, train_models, batches, max_steps=1, device="cuda")
    single["train"] = dict(loss=history[0]["loss"], grad_norm=history[0]["grad_norm"],
                           seconds=time.perf_counter() - t0)
    del train_models
    gc.collect()
    torch.cuda.empty_cache()
    single["micro_dp"] = micro_dp_step(None, "cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    single["micro_dp_card"] = micro_dp_step(None, "cuda")
    t_single = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    ranks = spawn(multi_rank, MULTI_RANKS, timeout=900, threads=4)
    t_ranks = time.perf_counter() - t0
    gpu, cards = gpu_line(), torch.cuda.device_count()
    shared = ("the ranks share ONE card, so their times are no scaling numbers"
              if cards < MULTI_RANKS else "one card a rank")
    log(f"[multi] {MULTI_RANKS} ranks over {ranks[0]['backend']} on {min(cards, MULTI_RANKS)} "
        f"card(s) ({gpu}): {shared}; single-process references {t_single:.1f} s, ranks "
        f"{t_ranks:.1f} s")
    failed = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    for name, video in single["micro"].items():
        for r in ranks:
            err = float(np.abs(r["micro"][name] - video).max())
            log(f"[multi] micro float32 {name} sampler, rank {r['rank']}: max |rank - "
                f"single| {err:.3e} (tol {MULTI_MICRO_ATOL:.4g}), PSNR "
                f"{psnr_db(r['micro'][name], video):.2f} dB")
            check(err <= MULTI_MICRO_ATOL, f"micro {name} rank {r['rank']}")
    for name, label, kw, case, width, height, frames in _multi_sampler_cases():
        got = ranks[0][name]["video"]
        db = psnr_db(got / 255.0, single[name]["video"] / 255.0)
        same = len({r[name]["digest"] for r in ranks}) == 1
        log(f"[multi] ({name}) {label}, {MULTI_STEPS} steps, CFG 3.5, bf16: PSNR against "
            f"the single process {db:.2f} dB (floor {MULTI_PSNR_DB:g}); ranks return the "
            f"same video: {same}; single process {single[name]['seconds']:.2f} s")
        check(db >= MULTI_PSNR_DB and same, f"sampler {name}")
        for r in ranks:
            log(f"[multi] ({name}) rank {r['rank']}: {r[name]['seconds']:.2f} s, window "
                f"batch {r[name]['window_batch']}, peak {r[name]['peak_gib']:.2f} GiB, "
                f"launches {r[name]['counts']}; phases {r[name]['phases']}")
            check(all(r[name]["counts"][k] > 0 for k in ("K2", "K3", "K4")),
                  f"sampler {name} rank {r['rank']}: K2/K3/K4 never launched")
        _multi_reckoning(name, ranks, width, height, frames, kw, check)
    for r in ranks:
        for dtype, a in r["a2a"].items():
            tol = 1e-5 if dtype == "float32" else TOLERANCE["bfloat16"][0]
            log(f"[multi] motion module all-to-all, full width (320 ch, 16 frames, "
                f"64x64), {dtype}, rank {r['rank']}: max |sharded - unsharded| "
                f"{a['err']:.3e} of {a['scale']:.3e} (tol {tol:g} of it); K3 launches "
                f"{a['k3']} on {a['positions']} of 4096 positions")
            check(a["err"] <= tol * a["scale"] and a["k3"] == 2
                  and a["positions"] == 4096 // MULTI_RANKS, f"a2a {dtype} rank {r['rank']}")
    for opt in ("float32", "8-bit"):
        total = sum(r["train"][opt]["state_bytes"] for r in ranks)
        for r in ranks:
            t = r["train"][opt]
            steps = ", ".join(f"{h['seconds']:.2f}" for h in t["history"])
            log(f"[multi] (c) data-parallel stage 1, {opt} AdamW under ZeRO-1, rank "
                f"{r['rank']}: losses {[round(h['loss'], 6) for h in t['history']]}, step "
                f"seconds {steps}; optimizer state {t['state_bytes'] / 2**30:.3f} GiB of "
                f"{total / 2**30:.3f} ({t['state_bytes'] / total:.1%}); peak "
                f"{t['peak_gib']:.2f} GiB; launches {t['counts']}")
            check(all(math.isfinite(h["loss"]) for h in t["history"]),
                  f"train {opt} rank {r['rank']} losses")
            check(all(t["counts"][k] > 0 for k in ("K2", "K5a", "K5b")),
                  f"train {opt} rank {r['rank']}: K2/K5a/K5b never launched")
            check(abs(t["state_bytes"] / total - 1 / MULTI_RANKS) < 0.05,
                  f"train {opt} rank {r['rank']}: state share")
    first = ranks[0]["train"]["float32"]["history"][0]
    rel = abs(first["loss"] - single["train"]["loss"]) / abs(single["train"]["loss"])
    # the 8-bit runs go on from the float32 runs' weights: step 1 is float32's
    nrel = [abs(r["train"]["float32"]["history"][0]["grad_norm"]
                - single["train"]["grad_norm"]) / single["train"]["grad_norm"] for r in ranks]
    log(f"[multi] (c) step-1 loss, {MULTI_RANKS} ranks {first['loss']:.6f} against the single "
        f"process's train_bs 2 step {single['train']['loss']:.6f}: rel err {rel:.2e} "
        f"(tol {MULTI_LOSS_RTOL:g}); gradient norm before the clip {first['grad_norm']:.6f} "
        f"against {single['train']['grad_norm']:.6f}: rel err, each rank, at most {max(nrel):.2e} (tol {MULTI_GRAD_NORM_RTOL:g}); single process "
        f"{single['train']['seconds']:.2f} s")
    check(rel <= MULTI_LOSS_RTOL, "train step-1 loss")
    check(max(nrel) <= MULTI_GRAD_NORM_RTOL, "train step-1 gradient norm")
    g = ranks[0]["gather"]
    owned = {i: v for r in ranks for i, v in r["gather"]["own"].items()}
    sums_ok = (len(g["gathered"]) == len(owned) == g["params"] and all(
        math.isclose(g["gathered"][i][k], v, rel_tol=1e-9, abs_tol=1e-9)
        for i, st in owned.items() for k, v in st.items()))
    total = sum(r["train"]["float32"]["state_bytes"] for r in ranks)
    log(f"[multi] (c) full-size float32 ZeRO-1 state gathered to rank 0 (a checkpoint's "
        f"gather): {g['gathered_bytes'] / 2**30:.3f} of {total / 2**30:.3f} GiB in "
        f"{g['seconds']:.2f} s; every owner's tensors' sums equal: {sums_ok}; card memory "
        + ", ".join(f"rank {r['rank']} +{r['gather']['device_extra_gib']:.3f} GiB" for r in ranks)
        + "; host peak " + ", ".join(f"rank {r['rank']} {r['gather']['host_peak_gib']:.2f} GiB"
                                     for r in ranks))
    check(sums_ok and g["gathered_bytes"] == total, "ZeRO-1 gather to rank 0")
    want, card = single["micro_dp"], single["micro_dp_card"]
    for r in ranks:
        got = r["micro_dp"]
        lrel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
        werr = max(float(np.abs(got["params"][k] - w).max()) for k, w in want["params"].items())
        m = step_mismatch(got, card, MULTI_MICRO_LR)
        log(f"[multi] (c) micro float32 data-parallel step on the card, rank {r['rank']}, "
            f"against the CPU's single process: loss rel err {lrel:.2e} (tol "
            f"{TRAIN_LOSS_RTOL:g}), max weight difference {werr:.3e} (tol "
            f"{2 * MULTI_MICRO_LR + 1e-6:g}); against the card's single process: gradient "
            f"{m['grad']:.2e} of the largest (tol {MULTI_GRAD_RTOL:g}), norm before the clip "
            f"rel err {m['norm']:.2e} (tol {MULTI_GRAD_RTOL:g}), of {m['clear']} "
            f"clear-gradient weights {m['off']} moved otherwise and {m['still']} by under "
            f"lr / 2")
        check(lrel <= TRAIN_LOSS_RTOL and werr <= 2 * MULTI_MICRO_LR + 1e-6,
              f"micro data-parallel step rank {r['rank']}")
        check(m["grad"] <= MULTI_GRAD_RTOL and m["norm"] <= MULTI_GRAD_RTOL and m["clear"] > 0
              and m["off"] == 0 and m["still"] == 0,
              f"micro data-parallel gradient rank {r['rank']}")
    for r in ranks:
        log(f"[multi] collectives over {r['backend']}, 256 MiB float32 on the card, rank "
            f"{r['rank']} ({gpu}): " + ", ".join(f"{k} {v:.2f} GB/s"
                                                 for k, v in r["collective_gbps"].items()))
    log(f"[multi] phase {time.perf_counter() - t_phase:.1f} s")
    if failed:
        raise SystemExit(f"multi phase failed: {failed}")


def _multi_reckoning(name: str, ranks, width: int, height: int, frames: int, kw: dict,
                     check) -> None:
    """K6 and K3 launches of each rank of sampler run ``name`` against the
    model's reckoning for that rank's share: (a) each rank's UNet calls on
    its windows; (b) each rank's calls on its CFG half of the clip."""
    import torch

    from aniportrait_tpu_torch import factory
    from aniportrait_tpu_torch.parallel.mesh import shard_rows
    from aniportrait_tpu_torch.pipelines.context import uniform_context_windows

    with torch.device("meta"):
        unet = factory.make_models("full")["denoising_unet"]
    hlat, wlat = height // 8, width // 8
    n = len(ranks)
    for r in ranks:
        if name == "a":
            wb = r[name]["window_batch"]
            table = uniform_context_windows(0, frames, kw["context_frames"], 1,
                                            kw["context_overlap"])
            pad_to = -(-len(table) // wb) * wb
            share = range(pad_to)[shard_rows(pad_to, n, r["rank"])]
            local = -(-wb // n)
            calls = [min(local, share.stop - i) for i in range(share.start, share.stop, local)]
            rows = [2 * c for c in calls]
            win_frames = kw["context_frames"]
        else:
            rows, win_frames = [1], frames
        k3 = k6 = 0
        for nrows in rows:
            routes = temporal_routes(unet, hlat, wlat, nrows, win_frames)
            k3 += MULTI_STEPS * sum(1 for _, _, rt in routes if rt == "K3")
            k6 += MULTI_STEPS * sum(1 for _, _, rt in routes if rt == "K6")
        counts = r[name]["counts"]
        log(f"[multi] ({name}) rank {r['rank']}: K3 {counts['K3']} (reckoned {k3}), K6 "
            f"{counts['K6']} (reckoned {k6}) over {len(rows)} UNet call(s) a step of "
            f"{rows} rows")
        check(counts["K3"] == k3 and counts["K6"] == k6,
              f"sampler {name} rank {r['rank']}: K3/K6 launches differ from the reckoning")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phase", choices=("all", "kernels", "long-clip", "train", "tok-ab",
                                            "entry", "audio", "quality", "multi"),
                        default="all")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 2
    log(gpu_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    results: dict = {}
    if args.phase in ("all", "kernels", "long-clip"):
        kernel_phase(results)
    if args.phase in ("all", "long-clip"):
        reference_phase()
    if args.phase == "all":
        pipeline_phase(results)
        gc.collect()
        torch.cuda.empty_cache()
    if args.phase in ("all", "entry"):
        entry_phase()
        gc.collect()
        torch.cuda.empty_cache()
    if args.phase in ("all", "audio"):
        audio_phase(results)
        gc.collect()
        torch.cuda.empty_cache()
    if args.phase in ("all", "quality"):
        quality_phase()
        gc.collect()
        torch.cuda.empty_cache()
    if args.phase in ("all", "long-clip"):
        long_clip_phase(results)
    if args.phase in ("all", "train"):
        train_reference_phase()
        training_phase(results)
        gc.collect()
        torch.cuda.empty_cache()
        train2_reference_phase()
        train2_phase(results)
        gc.collect()
        torch.cuda.empty_cache()
    if args.phase in ("all", "tok-ab"):
        tok_ab_phase(results)
        folded_small_seq_phase(results)
    if args.phase in ("all", "multi"):
        gc.collect()
        torch.cuda.empty_cache()
        multi_phase()
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        dict(name=f"{kid} {SOURCES[kid][0]}", route="cuda", source=SOURCES[kid][1],
             replaces=SOURCES[kid][2], launches=results.get(kid, {}).get("launches", 0),
             **{k: results.get(kid, {}).get(k) for k in keys})
        for kid in sorted(SOURCES)
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
