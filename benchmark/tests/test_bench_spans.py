"""``harness/spans.py`` (the program's spans beside a device trace) on
made-up event lists, the per-layer readers of the spans on a made-up
``ctx``, and on the card (``cuda``) a micro request traced with the tracer
on: every operation's launch call lies inside the span it is put to."""

from types import SimpleNamespace

import pytest

from aniportrait_tpu_torch.utils.profiling import Record, SpanRecord
from harness import manifest as mf
from harness import spans
from harness.spans import Device, Host

MAIN, AUTOGRAD = 11, 22  # thread idents


def _span(name, start, end, parent, root, thread=MAIN, **counts):
    return SpanRecord(name=name, start_ns=start, end_ns=end, parent=parent, root=root,
                      thread=thread, counts=counts)


def _record():
    return Record(spans=[
        _span("request", 0, 1000, None, 0),           # 0
        _span("denoise", 100, 900, 0, 0),             # 1
        _span("denoising_unet", 200, 400, 1, 0),      # 2
        _span("K3 plain backward", 500, 600, None, 0, thread=AUTOGRAD),  # 3
        _span("vae_decode", 920, 990, 0, 0),          # 4
    ], counters={}, main_thread=MAIN)


def test_kernels_go_to_the_span_of_their_launch_call():
    record = _record()
    host = [Host(250, 260, "cudaLaunchKernel", 1),   # in denoising_unet
            Host(450, 455, "cudaLaunchKernel", 2),   # in denoise
            Host(550, 552, "cudaLaunchKernel", 3),   # K3's span on autograd's thread, begun last
            Host(700, 702, "cudaLaunchKernel", 4),   # K3's span closed: denoise
            Host(1200, 1201, "cudaMemcpyAsync", 5),  # outside every span
            Host(240, 270, "aten::mm", 1)]           # a host op, not the call
    device = [Device(300, 320, "k1", 1), Device(460, 470, "k2", 2), Device(560, 580, "k3", 3),
              Device(710, 720, "k4", 4), Device(1210, 1220, "copy", 5), Device(1230, 1240,
                                                                               "k6", 99)]
    ops = spans.attribute(host, device, record)
    assert [op.span for op in ops] == [2, 1, 3, 1, None, None]
    assert [op.launch.start if op.launch else None for op in ops] == [
        250, 450, 550, 700, 1200, None]
    assert record.path(ops[2].span) == "K3 plain backward"
    assert [spans.within(record, op.span, "denoise") for op in ops[:4]] == [
        True, True, False, True]


def test_idle_gaps_are_named_by_the_main_threads_span():
    record = _record()
    device = [Device(150, 200, "a", 0), Device(300, 400, "b", 0), Device(405, 410, "c", 0),
              Device(1100, 1110, "d", 0), Device(1150, 1160, "e", 0)]
    host = [Host(395, 405, "cudaStreamSynchronize", 0), Host(1110, 1140, "cudaLaunchKernel", 0)]
    gaps = spans.idle_gaps(host, device, record, n=3)
    # 410 -> 1100 opens in denoise with no host event; 200 -> 300 in
    # denoising_unet; 1110 -> 1150 outside every span, in a launch call
    assert gaps == [["request/denoise | no host operation", 690 / 1e9],
                    ["request/denoise/denoising_unet | no host operation", 100 / 1e9],
                    ["cudaLaunchKernel", 40 / 1e9]]
    host.append(Host(405, 415, "cudaStreamSynchronize", 0))
    assert spans.idle_gaps(host, device, record, n=1)[0][0] == (
        "request/denoise | cudaStreamSynchronize")


def _reader(name):
    return mf.metric_reader(name)


def _gen_ctx(**kw):
    base = dict(kind="pose2vid", requests=2, trace_requests=1,
                timer={"denoise": 8.0, "vae_decode": 0.8, "host_inputs": 0.1,
                       "host_outputs": 0.06, "encode_reference": 0.2})
    return SimpleNamespace(**{**base, **kw})


def test_pipeline_readers_of_the_timer():
    ctx = _gen_ctx()
    assert _reader("pipeline.host_io_s.gen")(ctx) == pytest.approx(0.08)
    assert _reader("pipeline.decode_s.gen")(ctx) == pytest.approx(0.37)
    parent = _gen_ctx(timer={"denoise": 8.0, "vae_decode": 0.8})  # no host phases
    for name in ("pipeline.host_io_s.gen", "pipeline.decode_s.gen"):
        assert _reader(name)(parent) is None
        assert _reader(name)(SimpleNamespace(kind="train")) is None


def test_readers_of_the_spans():
    record = _record()
    ops = [spans.Op(0, 5_000_000, "k", 2, None), spans.Op(0, 2_000_000, "k", 1, None),
           spans.Op(0, 1_000_000, "k", 3, None), spans.Op(0, 7_000_000, "k", None, None)]
    glue = _reader("pipeline.glue_device_s.gen")
    assert glue(_gen_ctx(spans=record, span_ops=ops)) == pytest.approx(0.002)
    assert glue(_gen_ctx()) is None

    s = 1_000_000_000
    gen = Record(spans=[_span("build_models", 0, 4 * s, None, 0),
                        _span("init", s, 3 * s, 0, 0),
                        _span("request", 5 * s, 15 * s, None, 2),
                        _span("request", 16 * s, 21 * s, None, 3),
                        _span("request", 22 * s, 28 * s, None, 4),
                        _span("request", 29 * s, 33 * s, None, 5)],
                 counters={}, main_thread=MAIN)
    assert _reader("setup.models_s")(_gen_ctx(spans=gen)) == 4.0
    assert _reader("setup.first_call_s")(_gen_ctx(spans=gen)) == 10.0 - 5.0

    def step(i, t0, seconds, sync, syncs):
        return [_span("step", t0, t0 + seconds, None, i),
                _span("forward", t0, t0 + 1, i, i),
                _span("sync", t0 + seconds - sync, t0 + seconds, i, i, host_syncs=2),
                _span("forward", t0 + 1, t0 + 2, i + 1, i, host_syncs=syncs - 2)]

    train = [_span("build_training_models", 0, 9 * s, None, 0),
             _span("build_models", 0, 8 * s, 0, 0)]
    for k, (seconds, sync) in enumerate([(12 * s, s), (3 * s, s // 2), (2 * s, s // 4),
                                         (4 * s, s)]):
        train += step(len(train), 10 * s * (k + 1), seconds, sync, 5)
    tr = SimpleNamespace(kind="train", spans=Record(spans=train, counters={}, main_thread=MAIN))
    assert _reader("setup.models_s")(tr) == 9.0
    assert _reader("setup.first_call_s")(tr) == 12.0 - 3.0
    assert _reader("train.host_syncs.train")(tr) == 5
    assert _reader("train.dispatch_s.train")(tr) == pytest.approx(2.5)
    for name in ("setup.models_s", "setup.first_call_s", "train.host_syncs.train",
                 "train.dispatch_s.train"):
        assert _reader(name)(SimpleNamespace(kind="train")) is None  # the parent's


@pytest.mark.cuda
def test_launch_calls_lie_in_their_spans_on_the_card():
    """One micro request on the card, traced with device activity (and the
    runtime calls beside it) and the tracer on."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spans are aligned with a device trace")
    from aniportrait_tpu_torch import factory
    from aniportrait_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline
    from aniportrait_tpu_torch.utils.profiling import TRACER
    from harness import trace

    pipe = Pose2VideoPipeline(factory.build_models("micro", "cuda", torch.float32, seed=3),
                              context_frames=4, context_overlap=2, window_batch=2)
    rs = np.random.RandomState(0)
    ref = rs.randint(0, 255, (64, 64, 3), np.uint8)
    poses = [rs.randint(0, 255, (64, 64, 3), np.uint8) for _ in range(6)]
    pipe(ref, poses, None, 64, 64, 6, num_inference_steps=2, seed=1)  # warm-up
    TRACER.start()
    try:
        with trace.Traced() as tr:
            pipe(ref, poses, None, 64, 64, 6, num_inference_steps=2, seed=1)
    finally:
        record = TRACER.stop()
    host, device = spans.events_of(tr.prof)
    ops = spans.attribute(host, device, record)
    assert len(ops) > 100
    placed = [op for op in ops if op.span is not None]
    print(f"{len(ops)} operations, {len(placed)} in a span, "
          f"{sum(op.launch is None for op in ops)} without a launch call")
    print("gaps:", spans.idle_gaps(host, device, record, n=5))
    assert len(placed) == len(ops)
    for op in placed:
        s = record.spans[op.span]
        assert s.start_ns <= op.launch.start <= s.end_ns, (op, s)
    names = {record.spans[op.span].name for op in placed}
    assert {"denoising_unet", "scatter", "vae_decode_chunk", "reference_unet"} <= names
