"""The port's tracer (``aniportrait_tpu_torch/utils/profiling.py``) on the
CPU: off it records nothing and ``PhaseTimer`` keeps its totals; on, spans
nest with their parents and roots, self time is a span less its children,
its clock is ``torch.profiler``'s, and a micro pipeline request and a micro
stage-2 training call record every span and counter the benchmark reads."""

import json
import math
import threading
import time
from collections import defaultdict

import numpy as np
import pytest
import torch

from aniportrait_tpu_torch import factory
from aniportrait_tpu_torch.ops.kernels.autograd import K3_BACKWARD, NatTemporal
from aniportrait_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline
from aniportrait_tpu_torch.train.stage2 import Stage2Settings, train
from aniportrait_tpu_torch.utils.profiling import TRACER, PhaseTimer, count, span

PIPELINE_SPANS = {"request", "host_inputs", "encode_reference", "clip", "vae_encode",
                  "reference_unet", "pose_features", "pose_guider", "denoise", "step",
                  "window_batch", "denoising_unet", "scatter", "scheduler_step",
                  "vae_decode", "vae_decode_chunk", "host_outputs", "build_models", "init"}
TRAIN_SPANS = {"build_training_models", "build_models", "init", "step", "data", "forward",
               "backward", "clip", "optimizer", "sync"}


@pytest.fixture
def tracer():
    """The process-wide tracer, switched on for one test and off after it."""
    TRACER.start()
    try:
        yield TRACER
    finally:
        TRACER.stop()


class ReferencePhaseTimer:
    """``PhaseTimer`` as it was before the tracer: the totals to match."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    def phase(self, name):
        timer = self

        class _Phase:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                timer.totals[name] += time.perf_counter() - self.t0
                timer.counts[name] += 1
                return False

        return _Phase()

    def summary(self):
        return {k: {"total_s": round(v, 4), "count": self.counts[k]}
                for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])}


def _phases(timer):
    for name in ("encode", "denoise", "denoise", "decode"):
        with timer.phase(name):
            pass
    with timer.phase("outer"):
        with timer.phase("inner"):
            pass


@pytest.mark.parametrize("on", [False, True])
def test_phase_timer_totals_unchanged_on_and_off(monkeypatch, on):
    """The same phases on a stepped clock give the reference's totals,
    counts, summary and report, with the tracer off and on."""
    ticks = iter(np.arange(1, 1000) * 0.25)
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
    ref = ReferencePhaseTimer()
    _phases(ref)
    ticks = iter(np.arange(1, 1000) * 0.25)
    timer = PhaseTimer()
    if on:
        TRACER.start()
    try:
        _phases(timer)
    finally:
        record = TRACER.stop()
    assert dict(timer.totals) == dict(ref.totals)
    assert dict(timer.counts) == dict(ref.counts)
    assert timer.summary() == ref.summary()
    assert json.loads(timer.report()) == ref.summary()
    names = [s.name for s in record.spans]
    assert names == (["encode", "denoise", "denoise", "decode", "outer", "inner"] if on
                     else [])


def test_off_records_nothing():
    TRACER.start()
    TRACER.stop()
    assert not TRACER.on
    for _ in range(1000):
        with span("x", index=1) as opened:
            count("host_syncs")
    assert opened is None
    record = TRACER.record()
    assert record.spans == [] and record.counters == {}
    assert span("a") is span("b")  # one shared no-op: nothing allocated a call


def test_spans_nest_with_parents_and_roots(tracer):
    with span("request", frames=16):
        with span("denoise"):
            for i in range(2):
                with span("step", index=i):
                    count("host_syncs")
                    with span("denoising_unet", rows=32):
                        pass
        on_thread = []
        worker = threading.Thread(target=lambda: on_thread.append(span("worker").__enter__()))
        worker.start()
        worker.join(timeout=10)
        assert not worker.is_alive()
        on_thread[0].__exit__(None, None, None)
    with span("request"):
        count("host_syncs", 3)
    record = tracer.stop()
    names = [s.name for s in record.spans]
    assert names == ["request", "denoise", "step", "denoising_unet", "step",
                     "denoising_unet", "worker", "request"]
    s = record.spans
    assert [x.parent for x in s] == [None, 0, 1, 2, 1, 4, None, None]
    assert [x.root for x in s] == [0, 0, 0, 0, 0, 0, 0, 7]
    assert record.roots("request") == [0, 7]
    assert s[0].attrs == {"frames": 16} and s[4].attrs == {"index": 1}
    assert s[6].thread != s[0].thread and s[0].thread == record.main_thread
    assert record.path(5) == "request/denoise/step/denoising_unet"
    assert s[2].counts == {"host_syncs": 1} and s[7].counts == {"host_syncs": 3}
    assert record.counters == {"host_syncs": 5}
    assert record.count_under(0, "host_syncs") == 2 and record.count_under(4, "host_syncs") == 1
    for x in s:
        assert x.start_ns <= x.end_ns
        if x.parent is not None:
            p = s[x.parent]
            assert p.start_ns <= x.start_ns and x.end_ns <= p.end_ns


def test_self_time_is_duration_less_children(monkeypatch, tracer):
    ticks = iter(range(0, 10**6, 10))
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(ticks))
    tracer.start()  # the clock pair on the stepped clock
    with span("step"):          # enters at t, children at +10..+20 and +30..+40
        with span("forward"):
            pass
        with span("backward"):
            pass
    record = tracer.stop()
    step, fwd, bwd = record.spans
    assert step.end_ns - step.start_ns == 50
    assert record.self_ns(0) == 50 - 10 - 10
    assert record.self_ns(1) == fwd.end_ns - fwd.start_ns == 10
    assert record.children(0) == [1, 2]


def test_clock_is_the_profilers(tracer):
    """A span around a ``record_function`` range holds the range's kineto
    start and end within 1 ms: the spans are on the profiler's clock."""
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with span("outer"):
                with record_function("inner range"):
                    for _ in range(20):
                        x = torch.tanh(x @ x.T / 256.0)
            time.sleep(0.002)
    record = tracer.stop()
    ranges = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                    if e.name() == "inner range")
    outers = [(s.start_ns, s.end_ns) for s in record.spans if s.name == "outer"]
    assert len(ranges) == len(outers) == 3
    for (a, b), (sa, sb) in zip(ranges, outers):
        assert sa - 1_000_000 <= a and b <= sb + 1_000_000, (a - sa, sb - b)
        assert a - sa < 1_000_000  # the range starts where the span does


def _names(record):
    return {s.name for s in record.spans}


def test_micro_pipeline_records_every_span(tracer):
    """A 2-step micro request of 6 frames in windows of 4 (so the windowed
    path's spans run too), its models built under the tracer."""
    modules = factory.build_models("micro", "cpu", torch.float32, seed=3)
    pipe = Pose2VideoPipeline(modules, context_frames=4, context_overlap=2, window_batch=2)
    rs = np.random.RandomState(0)
    ref = rs.randint(0, 255, (64, 64, 3), np.uint8)
    poses = [rs.randint(0, 255, (64, 64, 3), np.uint8) for _ in range(6)]
    video = pipe(ref, poses, None, 64, 64, 6, num_inference_steps=2, seed=1)
    record = tracer.stop()
    assert video.shape == (6, 64, 64, 3)
    assert _names(record) == PIPELINE_SPANS
    (req,) = record.roots("request")
    paths = {record.path(i) for i in range(len(record.spans)) if record.spans[i].root == req}
    for p in ("request/host_inputs", "request/encode_reference/reference_unet",
              "request/pose_features/pose_guider", "request/denoise/step/scheduler_step",
              "request/denoise/step/window_batch/denoising_unet", "request/denoise/step/scatter",
              "request/vae_decode/vae_decode_chunk", "request/vae_decode/host_outputs"):
        assert p in paths, p
    steps = [s for s in record.spans if s.name == "step" and s.root == req]
    assert [s.attrs["index"] for s in steps] == [0, 1]
    batches = [s for s in record.spans if s.name == "window_batch"]
    assert batches and all(0 < b.attrs["valid"] <= b.attrs["rows"] for b in batches)
    (build,) = record.roots("build_models")
    assert len([i for i in record.children(build) if record.spans[i].name == "init"]) == 5
    # the phases are the timer's, and host I/O sits in it beside them
    timer = pipe.timer.totals
    assert {"host_inputs", "host_outputs", "vae_decode", "denoise"} <= set(timer)
    assert pipe.timer.counts["host_outputs"] == 2  # the copies' waits and the conversion
    for name in ("encode_reference", "denoise", "vae_decode", "host_inputs"):
        (i,) = [i for i, s in enumerate(record.spans) if s.name == name]
        assert record.spans[i].seconds == pytest.approx(timer[name], abs=2e-3)


def _batch(seed, f=2, h=32):
    rs = np.random.RandomState(seed)
    img = factory.MICRO["clip"]["image_size"]
    return {"pixel_values": rs.uniform(-1, 1, (1, f, h, h, 3)).astype(np.float32),
            "pixel_values_pose": rs.uniform(-1, 1, (1, f, h, h, 3)).astype(np.float32),
            "pixel_values_ref_img": rs.uniform(-1, 1, (1, h, h, 3)).astype(np.float32),
            "clip_ref_image": rs.randn(1, img, img, 3).astype(np.float32)}


def test_micro_training_records_every_span_and_host_syncs(tracer):
    settings = Stage2Settings(gradient_checkpointing=True, mixed_precision="no",
                              validation_steps=0)
    modules = factory.build_training_models(
        "micro", "cpu", seed=4, frozen_dtype=torch.float32, stage=2,
        gradient_checkpointing=True, scheduler_kwargs=settings.scheduler_kwargs())
    history = train(settings, modules, [_batch(s) for s in range(2)], max_steps=5,
                    device="cpu")
    record = tracer.stop()
    assert len(history) == 2
    assert _names(record) == TRAIN_SPANS
    steps = record.roots("step")  # no span for the fetch that found no batch
    assert [record.spans[i].attrs["index"] for i in steps] == [0, 1]
    for i in steps:
        kids = [record.spans[j].name for j in record.children(i)]
        assert kids == ["data", "forward", "backward", "clip", "optimizer", "sync"]
        assert record.count_under(i, "host_syncs") >= 2
        assert record.spans[i].seconds == pytest.approx(
            history[steps.index(i)]["seconds"], abs=0.05)
    assert record.counters["host_syncs"] >= 4
    (build,) = record.roots("build_training_models")
    assert record.path(record.children(record.children(build)[0])[0]) == (
        "build_training_models/build_models/init")


def test_k3_backward_opens_its_span(tracer):
    """K3's backward (autograd of the plain version) in a tracer span of its
    profiler range's name."""
    b, f, s, c, heads = 1, 4, 8, 16, 2
    q, k, v = (torch.randn(b * f, s, c, requires_grad=True) for _ in range(3))
    out = NatTemporal.apply(q, k, v, f, heads, math.log2(math.e) / math.sqrt(c // heads))
    with span("backward"):
        out.square().sum().backward()
    record = tracer.stop()
    (i,) = [i for i, s in enumerate(record.spans) if s.name == K3_BACKWARD]
    assert record.path(i) == f"backward/{K3_BACKWARD}"
    assert q.grad is not None and torch.isfinite(q.grad).all()
