"""Tracing hooks — the NVTX analog (``include/internal/nvtx.h:31-56``) —
and the span recorder behind them.

Every public op, and each phase inside one that a reader times, wraps its
body in :func:`trace_range`, which opens a
``torch.profiler.record_function`` range (visible in ``torch.profiler``
traces, where ``performance.device_op_attribution`` charges the kernels
to it) and, while CUDA is initialized, an NVTX range of the same name.

While a ``torch.profiler`` session is active, each range is also a *span*:
a record appended to an in-memory buffer that holds

* its name, and the index of its parent (the innermost span open on the
  same thread when it opened; None for a root);
* its host start and end (``time.perf_counter_ns``);
* the integer counts passed to :func:`trace_range` (an exchange's
  ``bytes``), or set in the dict it yields before the range closes (a
  Poisson solve's K5 launches);
* while CUDA is initialized, a start and an end
  ``torch.cuda.Event(enable_timing=True)`` recorded on the stream that was
  current when the span opened, so that its device time is the stream's
  time between the two.

Recording synchronises nothing.  :func:`spans` synchronises the device,
resolves the events once, as milliseconds from the buffer's first event,
and returns the records as :class:`Span` tuples; :func:`clear_spans`
empties the buffer.  The buffer keeps at most :data:`MAX_SPANS` records
and counts the spans it dropped beyond them (:func:`dropped_spans`).

Cost: with the profiler off a range costs one check of the profiler's
state over the ranges themselves: no event, no clock read, no record.
With it on, a span adds two clock reads and, on CUDA, two event records
on the stream (no device operation).  Under ``torch.compile``'s tracing
(``torch.compiler.is_compiling()``) a span records nothing.
``CUDECOMP_TPU_DISABLE_TRACING=1``, read at import, makes
:func:`trace_range` a no-op: no range and no span.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

from cudecomp_tpu_torch.utils import env

_DISABLED = env.tracing_disabled()
_profiler_enabled = torch._C._autograd._profiler_enabled

#: the library's trace ranges start with PREFIX; the exchanges' with
#: EXCHANGE_PREFIX (``performance.device_op_attribution`` counts the
#: device time inside those as communication)
PREFIX = "cudecomp_tpu_torch."
EXCHANGE_PREFIX = PREFIX + "exchange."

#: the most records the span buffer holds; later spans are counted only
MAX_SPANS = 1 << 16


class Span(NamedTuple):
    """One recorded span.  Device times are milliseconds from the
    buffer's first event, None without CUDA (or while the span is open)."""
    name: str
    parent: Optional[int]
    host_start_ns: int
    host_end_ns: Optional[int]
    counts: Dict[str, int]
    device_start_ms: Optional[float]
    device_end_ms: Optional[float]


class _Record:
    __slots__ = ("owner", "index", "name", "parent", "t0", "t1", "counts",
                 "stream", "events", "d0", "d1")


class _SpanBuffer:
    """The process's span records; each thread nests its own spans."""

    def __init__(self):
        self.local = threading.local()
        self.lock = threading.Lock()
        self.clear()

    def clear(self):
        with self.lock:
            self.records: List[_Record] = []
            self.dropped = 0
            self.origin = None   # the first event of the buffer

    def open(self, name: str, counts, cuda: bool) -> Optional[_Record]:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        r = _Record()
        r.name, r.counts = name, counts
        r.t0 = r.t1 = r.d0 = r.d1 = r.events = r.stream = None
        with self.lock:
            if len(self.records) >= MAX_SPANS:
                self.dropped += 1
                return None
            top = stack[-1] if stack else None
            r.owner, r.index = self.records, len(self.records)
            r.parent = (top.index if top is not None and top.owner is r.owner
                        else None)
            self.records.append(r)
        if cuda:
            r.stream = torch.cuda.current_stream()
            r.events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            r.events[0].record(r.stream)
            if self.origin is None:
                self.origin = r.events[0]
        stack.append(r)
        r.t0 = time.perf_counter_ns()
        return r

    def close(self, r: _Record) -> None:
        # the end event first: spans() resolves a record once t1 is set
        if r.events is not None:
            r.events[1].record(r.stream)
        r.t1 = time.perf_counter_ns()
        self.local.stack.remove(r)

    def spans(self) -> List[Span]:
        with self.lock:
            records, origin = list(self.records), self.origin
        pending = [r for r in records if r.events is not None
                   and r.t1 is not None]
        if pending:
            torch.cuda.synchronize()
            for r in pending:
                r.d0 = origin.elapsed_time(r.events[0])
                r.d1 = origin.elapsed_time(r.events[1])
                r.events = r.stream = None
        return [Span(r.name, r.parent, r.t0, r.t1, dict(r.counts), r.d0,
                     r.d1) for r in records]


_BUFFER = _SpanBuffer()


def spans() -> List[Span]:
    """The recorded spans, in the order they opened (a span's ``parent``
    indexes this list).  Synchronises the device when spans hold events
    not yet resolved."""
    return _BUFFER.spans()


def dropped_spans() -> int:
    """How many spans the full buffer dropped since it was last cleared."""
    return _BUFFER.dropped


def clear_spans() -> None:
    """Empty the span buffer and its drop count."""
    _BUFFER.clear()


@contextlib.contextmanager
def trace_range(name: str, **counts: int):
    """Named range for profiler traces and, on CUDA, for NVTX; a recorded
    span, with ``counts``, while the profiler is on.  Yields ``counts``,
    the span's own dict: a count known only once the work ran is set in
    it before the range closes."""
    if _DISABLED:
        yield counts
        return
    nvtx = torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        rec = (_BUFFER.open(name, counts, nvtx)
               if _profiler_enabled() and not torch.compiler.is_compiling()
               else None)
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield counts
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
            if rec is not None:
                _BUFFER.close(rec)
