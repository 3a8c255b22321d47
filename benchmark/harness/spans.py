"""The program's spans beside a device trace of the same run.

The port's tracer (``aniportrait_tpu_torch/utils/profiling.py``) records
spans in memory on ``torch.profiler``'s clock (the ``time.time_ns()``
base of its kineto events), each with the thread that opened it.  Here:

* :func:`attribute` puts each device operation of a trace to the innermost
  program span open when its runtime call (``cudaLaunchKernel``,
  ``cudaMemcpyAsync``, ...) began, found by the operation's correlation id.
  Kineto's thread id of a runtime call (1 on the card) is none of the
  tracer's, so of each thread's innermost span open then, the one begun
  last is taken: while the main thread waits in ``backward``, a launch from
  autograd's thread goes to K3's span if one is open there, else to
  ``backward``.
* :func:`idle_gaps` names the longest gaps between device operations
  ``"<span path> | <runtime call or no host operation>"``: the innermost
  span open on the main thread when the device went idle, and the
  innermost host event then (as ``trace.reduce`` names a gap).  A gap
  outside every span keeps the host event's name alone.

Events are plain tuples (:func:`events_of` reads them from a finished
``torch.profiler.profile``), so both run on made-up lists too.  A driver
would hand the tracer's record to the per-layer readers as ``layer.spans``
and ``attribute``'s list as ``layer.span_ops``.
"""

from __future__ import annotations

import bisect
from collections import namedtuple

from harness.trace import _merge

Host = namedtuple("Host", "start end name corr")
Device = namedtuple("Device", "start end name corr")
Op = namedtuple("Op", "start end name span launch")  # span: index or None; launch: Host

NO_HOST = "no host operation"


def events_of(prof):
    """(host events, device operations) of a finished ``torch.profiler``
    profile: the device operations as ``trace.reduce`` counts them (no
    host-range copies, no annotations, no empty intervals)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            device.append(e)
        else:
            host.append(Host(e.start_ns(), e.end_ns(), e.name(), e.correlation_id()))
    names = {h.name for h in host}
    ops = []
    for e in device:
        if e.name() in names or e.is_user_annotation() or e.end_ns() <= e.start_ns():
            continue
        corr = e.correlation_id() or e.linked_correlation_id()
        ops.append(Device(e.start_ns(), e.end_ns(), e.name(), corr))
    return host, ops


def _is_runtime_call(name: str) -> bool:
    return name.startswith("cu")


class _SpanIndex:
    """The record's spans by thread, sorted by start, for the innermost span
    open at a moment."""

    def __init__(self, record):
        self.record = record
        self.by_thread = {}
        for i, s in enumerate(record.spans):
            self.by_thread.setdefault(s.thread, []).append(i)
        for ids in self.by_thread.values():
            ids.sort(key=lambda i: record.spans[i].start_ns)
        self.starts = {t: [record.spans[i].start_ns for i in ids]
                       for t, ids in self.by_thread.items()}

    def open_on(self, thread, t: int):
        """Index of the innermost span of ``thread`` open at ``t``, or None.
        Spans of one thread nest, so it is the last one begun by ``t`` or
        one of its parents."""
        ids = self.by_thread.get(thread)
        if not ids:
            return None
        k = bisect.bisect_right(self.starts[thread], t) - 1
        i = ids[k] if k >= 0 else None
        spans = self.record.spans
        while i is not None and spans[i].end_ns <= t:
            i = spans[i].parent
        return i

    def at(self, t: int):
        """The innermost span open at ``t`` on any thread: of each thread's
        innermost, the one begun last."""
        found = [i for i in (self.open_on(th, t) for th in self.by_thread) if i is not None]
        return max(found, key=lambda i: self.record.spans[i].start_ns, default=None)


def attribute(host, device, record) -> list:
    """Each device operation as an :class:`Op`, with the index of the span
    that launched it (None: no span was open) and its runtime call (None:
    not in the trace)."""
    calls = {}
    for h in host:
        if h.corr and _is_runtime_call(h.name):
            calls.setdefault(h.corr, h)
    index = _SpanIndex(record)
    out = []
    for d in device:
        call = calls.get(d.corr)
        span = index.at(call.start) if call is not None else None
        out.append(Op(d.start, d.end, d.name, span, call))
    return out


def _innermost_host(host_sorted, starts, t: int) -> str:
    inner = [(h.end - h.start, h.name) for h in host_sorted[:bisect.bisect_right(starts, t)]
             if h.start <= t < h.end]
    return min(inner)[1] if inner else NO_HOST


def idle_gaps(host, device, record, n: int = 10) -> list:
    """The ``n`` longest gaps between device operations, longest first, as
    ``[name, seconds]``; see the module doc for the name."""
    busy = _merge((d.start, d.end) for d in device)
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1]) for i in range(len(busy) - 1)),
                  reverse=True)[:n]
    index = _SpanIndex(record)
    host_sorted = sorted(host, key=lambda h: h.start)
    starts = [h.start for h in host_sorted]
    named = []
    for length, at in gaps:
        call = _innermost_host(host_sorted, starts, at)
        i = index.open_on(record.main_thread, at)
        named.append([call if i is None else f"{record.path(i)} | {call}", length / 1e9])
    return named


def within(record, i, name: str) -> bool:
    """Whether span ``i`` or one of its parents is called ``name``."""
    while i is not None:
        if record.spans[i].name == name:
            return True
        i = record.spans[i].parent
    return False
