"""Spans and byte counters inside the port, for whoever profiles it.

``span(name, **attrs)`` times one piece of work (``time.perf_counter``)
and records ``(id, name, t0, t1, thread, parent, attrs)``; the parent is
the innermost open span on the same thread, or the cause carried to the
thread (``carry``). ``count(name, n)`` records ``(name, t, n)``. The
records stay in memory: ``recorded()`` returns them, ``window(t0, t1)``
sums those that start inside ``[t0, t1)`` by name.

Recording follows ``torch.profiler``: a span or a count records only where
a profiler records on the calling thread (``torch.autograd.
_profiler_enabled()``, a thread-local state), or under a cause that was
recorded when it was carried. Otherwise ``span`` returns one shared no-op
object: no allocation, no ``record_function``, no file size read, one
check a call. A span opened on a thread the profiler records also enters
``torch.profiler.record_function("bossruns.<name>")``, so it stands in the
exported trace beside the device's kernels, on the trace's own clock.

The spans (where each is opened):

=================== =================================================
``sim.batch``       ``BossRunsSim.process_batch``: one batch, the
                    parent of what follows
``sim.prefetch``    the next batch's host work (``_prefetch_gated``,
                    ``_sample_parsed``), on the prefetch worker or
                    inline for an experiment's first batch
``sim.draw``        sampling the batch from the pool
``sim.paf``         parsing its full and truncated PAF records
``sim.coo``         the gated flow's coverage rows, read-start rows and
                    padding; the classic flow's read lengths, read-start
                    rows and packed batch
``coo.build``       ``io/coo_native.coverage_rows``: the compiled passes
                    over a call's record sets (attrs ``records``,
                    ``bases``, ``chunks``, ``workers``: 1 where every set
                    is one chunk on the calling thread)
``sim.align``       the classic flow's live alignment: the prefixes'
                    mapping, the decisions and the accepted reads' mapping
``sim.decide``      the classic flow's decisions and coverage rows' choice
``align.index``     the aligner's index, built or loaded, and its upload
``align.map``       one ``map_sequences`` call (attrs ``trunc``, ``reads``)
``align.encode``    the batch's text encoded and staged for the seeding
``align.dispatch``  the staged reads' upload and every seeding launch
                    (attr ``calls``: each call's reads and length bucket)
``align.pull``      one call's seeds: the wait for its seeding, its copy
``align.plan``      one call's candidates, windows and mapq
``align.extend``    one call's banded DP and its records
``engine.pack``     packing a wire into staging (with the wait for a
                    free staging buffer)
``engine.upload``   the wire's async copy, its host side
``engine.params``   ``make_params``
``engine.launch``   a step's graph input copy and replay, a capture or
                    the eager body (attr ``mode``)
``engine.pull_aux`` the step's scalars, which wait for the step
``mask.pull``       the strategy's copy to the host
``mask.split``      the per-contig arrays
``mask.write``      the strategy file the readfish side reads
``checkpoint.pull`` the state's copy to the host
``checkpoint.write`` the checkpoint's files (attrs ``workers``,
                    ``chunks``: the npz writer's pool and pieces)
=================== =================================================

The counters: ``bytes.d2h`` (bytes copied from the device: the aux
vector, the strategy, the checkpointed state, the aligner's seeds),
``bytes.disk`` (bytes written to files: the strategy file, the
checkpoint, the metrics lines, the read dumps) and the aligner's
``align.reads``, ``align.bases`` (the bases seeded), ``align.jobs`` (DP
jobs) and ``align.dp_cells`` (each job's query bases times its band's
width, 2 half + 1).
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from typing import NamedTuple

import torch

_profiling = torch.autograd._profiler_enabled
_tl = threading.local()   # stack: open span ids; cause: (parent id,) carried in
_records: list = []
_ids = itertools.count(1)


class Span(NamedTuple):
    id: int
    name: str
    t0: float
    t1: float
    thread: int
    parent: int | None
    attrs: dict | None


class Count(NamedTuple):
    name: str
    t: float
    n: int


class Window(NamedTuple):
    seconds: dict  # span name -> total seconds
    n: dict        # span name -> number of spans
    counts: dict   # counter name -> sum


def _cause():
    """``(parent id,)`` carried to this thread (``carry``), or None."""
    return getattr(_tl, "cause", None)


def _innermost():
    stack = getattr(_tl, "stack", None)
    if stack:
        return stack[-1]
    cause = _cause()
    return cause[0] if cause else None


def on() -> bool:
    """Whether spans and counts record on this thread now."""
    return _profiling() or _cause() is not None


class _Off:
    """What ``span`` returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def attr(self, key, value) -> None:
        pass


_OFF = _Off()


class _Live:
    __slots__ = ("name", "attrs", "id", "parent", "t0", "rf", "stack")

    def __init__(self, name: str, attrs: dict | None, profiled: bool):
        self.name, self.attrs = name, attrs
        self.rf = torch.profiler.record_function(f"bossruns.{name}") if profiled else None

    def attr(self, key, value) -> None:
        """Set an attribute once the span is open (a value known only then)."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    def __enter__(self):
        self.parent = _innermost()
        stack = getattr(_tl, "stack", None)
        if stack is None:
            stack = _tl.stack = []
        self.id = next(_ids)
        self.stack = stack
        stack.append(self.id)
        # the clock is read outside the annotation: a record holds what its
        # annotation costs, as any span around it does
        self.t0 = time.perf_counter()
        if self.rf is not None:
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        t1 = time.perf_counter()
        self.stack.pop()
        _records.append(Span(self.id, self.name, self.t0, t1, threading.get_ident(),
                             self.parent, self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager that records one span of ``name`` while recording
    is on (see the module's docstring), else the shared no-op."""
    profiled = _profiling()
    if not profiled and _cause() is None:
        return _OFF
    return _Live(name, attrs or None, profiled)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` while recording is on."""
    if on():
        _records.append(Count(name, time.perf_counter(), int(n)))


def count_files(*paths) -> None:
    """Count the files' sizes under ``bytes.disk`` while recording is on
    (the sizes are read only then)."""
    if on():
        count("bytes.disk", sum(os.path.getsize(p) for p in paths))


def carry(fn):
    """``fn`` wrapped to run, on any thread, under this thread's recording
    state and innermost span: the spans it opens name that span as their
    parent. While nothing records, ``fn`` itself."""
    if not on():
        return fn
    cause = (_innermost(),)

    def carried(*args, **kwargs):
        prev = _cause()
        _tl.cause = cause
        try:
            return fn(*args, **kwargs)
        finally:
            _tl.cause = prev
    return carried


def recorded() -> list:
    """Every record so far (``Span`` and ``Count``), in the order they closed."""
    return list(_records)


def window(t0: float, t1: float, under: str | None = None) -> Window:
    """Totals of the records that start in ``[t0, t1)`` (``perf_counter``
    seconds): each span name's seconds and number, each counter's sum.
    ``under``: only spans with an ancestor of that name."""
    recs = list(_records)
    spans = [r for r in recs if isinstance(r, Span)]
    if under is not None:
        by_id = {r.id: r for r in spans}

        def inside(r):
            p = by_id.get(r.parent)
            while p is not None:
                if p.name == under:
                    return True
                p = by_id.get(p.parent)
            return False
        spans = [r for r in spans if inside(r)]
    seconds, n, counts = {}, {}, {}
    for r in spans:
        if t0 <= r.t0 < t1:
            seconds[r.name] = seconds.get(r.name, 0.0) + (r.t1 - r.t0)
            n[r.name] = n.get(r.name, 0) + 1
    for r in recs:
        if isinstance(r, Count) and t0 <= r.t < t1:
            counts[r.name] = counts.get(r.name, 0) + r.n
    return Window(seconds, n, counts)
