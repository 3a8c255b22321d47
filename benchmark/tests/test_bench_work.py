"""The yardstick's arithmetic against hand counts at tiny shapes: attention
FLOPs and bytes, model FLOPs on meta tensors, the union of kernel
intervals, the kernel families and the comparison numbers."""

import numpy as np
import pytest
import torch

from harness import check, trace, work
from reference import attention as ref_attention
from reference.models import CrossAttention


def test_attention_least_time_is_the_larger_bound():
    # 2 rows, 3 heads, 5 queries, 7 keys, d 4: QK^T and PV are 2 * 2*3*5*7*4 MACs
    call = dict(rows=2, heads=3, sq=5, skv=7, d=4, backward=False)
    flops = 2 * 2 * (2 * 3 * 5 * 7 * 4)
    moved = (5 + 7 + 7 + 5) * 2 * 3 * 4 * 2  # q, k, v in, o out, bf16
    want = max(flops / 989e12, moved / 3.35e12)
    assert work.attention_least_seconds([call]) == pytest.approx(want, rel=1e-12)
    big = dict(rows=16, heads=8, sq=4096, skv=8192, d=40, backward=True)
    f = 4.0 * 16 * 8 * 4096 * 8192 * 40
    assert work.attention_least_seconds([big]) == pytest.approx(
        f / 989e12 + 2.5 * f / 989e12, rel=1e-12)  # both bound by operations
    one_key = dict(rows=32, heads=8, sq=4096, skv=1, d=40, backward=False)
    assert work.attention_least_seconds([one_key]) == 0.0


def test_reference_attention_is_recorded_and_counted():
    attn = CrossAttention(8, 2, 4)
    x = torch.randn(3, 5, 8)
    calls = []
    with ref_attention.recording(calls):
        out = attn(x)
    assert calls == [dict(rows=3, heads=2, sq=5, skv=5, d=4, backward=True)]
    q, k, v = (p(x).reshape(3, 5, 2, 4) for p in (attn.to_q, attn.to_k, attn.to_v))
    want = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) / 2.0, -1)
    want = torch.einsum("bhqk,bkhd->bqhd", want, v).reshape(3, 5, 8)
    torch.testing.assert_close(out, attn.to_out[0](want), rtol=1e-5, atol=1e-6)


def test_model_flops_on_meta_match_a_hand_count():
    lin = torch.nn.Linear(64, 32, device="meta")
    x = torch.zeros(10, 64, device="meta")
    flops, _ = work._counted(lambda: lin(x))
    assert flops == 2 * 10 * 64 * 32
    conv = torch.nn.Conv2d(4, 8, 3, padding=1, device="meta")
    flops, _ = work._counted(lambda: conv(torch.zeros(2, 4, 6, 6, device="meta")))
    assert flops == 2 * 2 * 8 * 6 * 6 * 4 * 9


def test_request_work_counts_every_window_and_step():
    from micro import MODELS

    sampler = dict(steps=3, guidance_scale=3.5, context_frames=16, context_stride=1,
                   context_overlap=4)
    one = work.request_work(MODELS, sampler, 16, 64, 64)
    four = work.request_work(MODELS, sampler, 48, 64, 64)
    # the motion modules' calls (8 heads of 4 on 32 channels; the rest have d >= 8)
    unet_calls = lambda r: sum(1 for c in r["attention_calls"] if c["d"] == 4)
    # 4 windows a step against 1: four times the denoising UNet's temporal calls
    assert unet_calls(four) == 4 * unet_calls(one) > 0
    assert four["flops"] > 3 * one["flops"]


def test_busy_time_is_the_union_of_intervals():
    merged = trace._merge([(0, 10), (5, 12), (20, 30), (30, 31), (40, 41)])
    assert merged == [[0, 12], [20, 31], [40, 41]]
    assert sum(b - a for a, b in merged) == 24


def test_kernel_families():
    assert trace.family("void flash_fwd_sm90_kernel<64, 2>(...)") == trace.ATTENTION
    assert trace.family("fmha_cutlassF_bf16_aligned_64x128_rf_sm80") == trace.ATTENTION
    assert trace.family("sm90_xmma_gemm_bf16bf16_bf16f32") == "GEMM"
    assert trace.family("cudnn::xmma_fprop_implicit_gemm") == "GEMM"
    assert trace.family("void at::native::vectorized_elementwise_kernel<4>") == trace.ELEMENTWISE
    assert trace.family("multi_tensor_apply_kernel") == "optimizer"
    assert trace.family("Memcpy DtoH (Device -> Pinned)") == trace.ELEMENTWISE


def test_comparison_numbers():
    a = np.zeros((2, 4, 4, 3), np.uint8)
    b = a.copy()
    b[1, 0, 0, 0] = 48  # one value off by 48 in 48 values of frame 1: rmse sqrt(48)
    assert check.frames_rmse(a, b) == pytest.approx(48 ** 0.5)
    assert check.frames_rmse(a, b[:1]) == float("inf")
    n = check.train_numbers(
        dict(losses=[1.0, 2.0], grad_norms=[1.0, 2.0, 0.0], change_norms=[1.0, 1.0, 9.0]),
        dict(losses=[1.0, 2.2], grad_norms=[2.0, 2.0, 0.0], change_norms=[1.0, 2.0, 1.0]))
    assert n["loss_rel"] == pytest.approx(0.2 / 2.2)
    assert n["grad_gap"] == pytest.approx(0.5)  # leaf 0: |1 - 2| / max(2, median 2)
    assert n["change_gap"] == pytest.approx(0.5)  # leaf 2 has no gradient: left out
    ok, shown = check.verdict({"x": 1.0}, {"x": 2.0})
    assert ok and shown == {"x": {"value": 1.0, "limit": 2.0}}
    assert not check.verdict({"x": float("nan")}, {"x": 2.0})[0]
