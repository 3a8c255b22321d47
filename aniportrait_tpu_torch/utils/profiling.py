"""The port's tracer: per-phase wall clock (``PhaseTimer``, the port of the
``PhaseTimer`` of ``aniportrait_tpu/utils/profiling.py``) and one
process-wide recorder of spans and counters (:data:`TRACER`).

``PhaseTimer`` accumulates wall seconds per named phase, always.  On a GPU
the caller synchronises inside the phase so that its time covers the
device work: ``Pose2VideoPipeline._sync`` ends each pipeline phase, and
those synchronisations stay, because ``pipeline.denoise_s.gen`` (the
benchmark's per-layer metric) reads the ``denoise`` total.

The tracer is off by default and is switched on and off through this API
only (:meth:`Tracer.start`, :meth:`Tracer.stop`); nothing reads the
environment.  Off, :func:`span` and :func:`count` cost one attribute test
and allocate nothing.  On, :func:`span` records name, start, end, parent,
thread and attributes in memory, on ``time.perf_counter_ns()``, and
:func:`count` adds to a counter, kept with the innermost open span.  A span
opened with no span open on its thread is a root (a pipeline ``request``, a
training ``step``, a set-up build), and every span under it carries its
index as ``root``; a span opened on another thread while a root is open
(autograd's backward thread, a staging worker) carries that root.  A
``PhaseTimer`` phase is also recorded as a span while the tracer is on.

:meth:`Tracer.record` reads out a :class:`Record` whose times are on the
``time.time_ns()`` base that ``torch.profiler``'s kineto events use, from
one (``time_ns``, ``perf_counter_ns``) pair taken when the tracer was
switched on, so spans and a profiler trace of the same run share a clock::

    from aniportrait_tpu_torch.utils import profiling

    profiling.TRACER.start()
    pipe(ref, poses, None, 512, 512, 16)
    record = profiling.TRACER.stop()
    [s.name for s in record.spans if s.parent is None]   # ['request']
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class PhaseTimer:
    """Accumulates wall-clock per named phase; while :data:`TRACER` is on,
    each phase is also a span of its name."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        with span(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.totals[name] += time.perf_counter() - t0
                self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": round(v, 4), "count": self.counts[k]}
            for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
        }

    def report(self) -> str:
        return json.dumps(self.summary())


@dataclass
class SpanRecord:
    """One span as read out: times in ns on the ``time.time_ns()`` base;
    ``parent`` and ``root`` are indices into :attr:`Record.spans` (``parent``
    None for a root or a span opened alone on another thread); ``thread``
    is ``threading.get_ident()`` of the thread that opened it; ``counts``
    the counters added while it was the innermost open span."""

    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    root: int
    thread: int
    attrs: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclass
class Record:
    """What the tracer recorded between :meth:`Tracer.start` and its read-out:
    spans in the order they opened, the counters' totals, and the thread that
    switched the tracer on (the main thread)."""

    spans: List[SpanRecord]
    counters: Dict[str, int]
    main_thread: int

    def children(self, i: int) -> List[int]:
        return [j for j, s in enumerate(self.spans) if s.parent == i]

    def self_ns(self, i: int) -> int:
        """The span's duration less the part of it that its children cover
        (children of one span do not overlap: they open and close on its
        thread)."""
        s = self.spans[i]
        return (s.end_ns - s.start_ns) - sum(
            self.spans[j].end_ns - self.spans[j].start_ns for j in self.children(i))

    def path(self, i: int) -> str:
        """``root/.../name`` of span ``i`` along its parents."""
        names = []
        while i is not None:
            names.append(self.spans[i].name)
            i = self.spans[i].parent
        return "/".join(reversed(names))

    def ancestors(self, i: int) -> List[int]:
        """Span ``i`` and its parents, innermost first."""
        out = []
        while i is not None:
            out.append(i)
            i = self.spans[i].parent
        return out

    def roots(self, name: str) -> List[int]:
        """Indices of the root spans called ``name``, in order."""
        return [i for i, s in enumerate(self.spans) if s.parent is None and s.root == i
                and s.name == name]

    def count_under(self, i: int, name: str) -> int:
        """Counter ``name`` added inside span ``i`` (its subtree and the spans
        that carry it as their root)."""
        total = 0
        for j, s in enumerate(self.spans):
            if name in s.counts and (s.root == i or i in self.ancestors(j)):
                total += s.counts[name]
        return total


class _Span:
    """An open span (the context manager :func:`span` returns when on)."""

    __slots__ = ("tracer", "name", "attrs", "start", "end", "parent", "root", "thread",
                 "counts")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.tracer, self.name, self.attrs = tracer, name, attrs
        self.end, self.counts = None, None

    def __enter__(self):
        tr = self.tracer
        stack = tr._stack()
        self.thread = threading.get_ident()
        if stack:
            self.parent = stack[-1]
            self.root = self.parent.root
        else:
            self.parent = None
            self.root = tr._open_roots[-1] if tr._open_roots else self
        stack.append(self)
        if self.root is self:
            tr._open_roots.append(self)
        tr._spans.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        tr = self.tracer
        stack = tr._stack()
        if stack and stack[-1] is self:
            stack.pop()
        if self.root is self and self in tr._open_roots:
            tr._open_roots.remove(self)
        return False


class Tracer:
    """The process-wide recorder (:data:`TRACER`); see the module doc."""

    def __init__(self):
        self.on = False
        self._reset()

    def _reset(self):
        self._spans: List[_Span] = []
        self._counters: Dict[str, int] = defaultdict(int)
        self._local = threading.local()
        self._open_roots: List[_Span] = []
        self._clock = (time.time_ns(), time.perf_counter_ns())
        self._main = threading.get_ident()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def start(self) -> None:
        """Switch on, dropping whatever an earlier session recorded; the
        calling thread is the record's main thread."""
        self.on = False
        self._reset()
        self.on = True

    def stop(self) -> Record:
        """Switch off and read out."""
        self.on = False
        return self.record()

    def span(self, name: str, attrs: dict) -> _Span:
        return _Span(self, name, attrs)

    def count(self, name: str, n: int) -> None:
        self._counters[name] += n
        stack = self._stack()
        inner = stack[-1] if stack else (self._open_roots[-1] if self._open_roots else None)
        if inner is not None:
            if inner.counts is None:
                inner.counts = {}
            inner.counts[name] = inner.counts.get(name, 0) + n

    def record(self) -> Record:
        """The spans so far, on the ``time.time_ns()`` base (a span still open
        ends at the read-out)."""
        wall0, perf0 = self._clock
        now = time.perf_counter_ns()
        spans = list(self._spans)
        index = {id(s): i for i, s in enumerate(spans)}
        out = []
        for s in spans:
            end = s.end if s.end is not None else now
            out.append(SpanRecord(
                name=s.name, start_ns=s.start - perf0 + wall0, end_ns=end - perf0 + wall0,
                parent=None if s.parent is None else index[id(s.parent)],
                root=index[id(s.root)], thread=s.thread, attrs=dict(s.attrs),
                counts=dict(s.counts or {})))
        return Record(spans=out, counters=dict(self._counters), main_thread=self._main)


TRACER = Tracer()


_OFF = contextlib.nullcontext()  # every span while off: one shared instance, nothing allocated


def span(name: str, **attrs):
    """``with span('denoise'):`` records a span while :data:`TRACER` is on."""
    if not TRACER.on:
        return _OFF
    return TRACER.span(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while :data:`TRACER` is on."""
    if TRACER.on:
        TRACER.count(name, n)
