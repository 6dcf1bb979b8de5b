"""The readings of the program's own spans: the records that
``cudecomp_tpu_torch.utils.tracing`` keeps while a ``torch.profiler``
session is on, read in the rank's process right after the traced window.

A span's device time is its end event minus its start event (the time
of the stream it opened on, idle time included); a span's self time is
that less the union of its children's intervals.  Readings are per
iteration of the traffic: divided by the number of root spans of the
traffic's iteration (:data:`ROOTS`).  A window reads nothing (None) where
that count is neither the traced iterations nor twice them (twice: the
harness retook a trace that lost records, and both windows were
recorded), where the buffer dropped spans, where any span lacks device
times (a CPU run), or where the program keeps no spans at all (a
checkout whose ``tracing`` has no ``spans()``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

PREFIX = "cudecomp_tpu_torch."
EXCHANGE_PREFIX = PREFIX + "exchange."

#: the root span of one iteration, by the traffic's driver
ROOTS = {"fft_roundtrip": PREFIX + "fft3d_inverse",
         "tg_step": PREFIX + "tg_step"}


def recorded():
    """``(spans, dropped)`` from the program, or None where it records
    no spans."""
    try:
        from cudecomp_tpu_torch.utils import tracing
        get, dropped = tracing.spans, tracing.dropped_spans
    except (ImportError, AttributeError):
        return None
    return get(), dropped()


def iterations(spans: Sequence, dropped: int, traced: int,
               root: str) -> Optional[int]:
    """How many iterations ``spans`` hold (roots named ``root``), or None
    where they cannot be read (see the module's docstring)."""
    if dropped or not spans:
        return None
    if any(s.device_start_ms is None or s.device_end_ms is None
           for s in spans):
        return None
    n = sum(1 for s in spans if s.parent is None and s.name == root)
    return n if n in (traced, 2 * traced) else None


def _ms(s) -> float:
    return s.device_end_ms - s.device_start_ms


def _ancestors(spans, i):
    p = spans[i].parent
    while p is not None:
        yield spans[p]
        p = spans[p].parent


def outermost(spans: Sequence, match: Callable[[str], bool],
              under: Optional[str] = None) -> List:
    """The spans whose name ``match``es and no ancestor's does; with
    ``under``, only those with an ancestor of that name."""
    out = []
    for i, s in enumerate(spans):
        if not match(s.name):
            continue
        up = [a.name for a in _ancestors(spans, i)]
        if any(match(a) for a in up) or (under is not None
                                         and under not in up):
            continue
        out.append(s)
    return out


def span_ms(spans: Sequence, match: Callable[[str], bool],
            under: Optional[str] = None) -> Optional[float]:
    """Device milliseconds in the :func:`outermost` spans that ``match``
    (so a span nested in another that matches is not counted twice);
    None where none does."""
    xs = outermost(spans, match, under)
    return sum(_ms(s) for s in xs) if xs else None


def self_ms(spans: Sequence, name: str) -> Optional[float]:
    """Device milliseconds of the spans named ``name`` less the union of
    their children's intervals (each clipped to its parent); None where
    no span has that name."""
    total, found = 0.0, False
    for i, s in enumerate(spans):
        if s.name != name:
            continue
        found = True
        kids = sorted((max(c.device_start_ms, s.device_start_ms),
                       min(c.device_end_ms, s.device_end_ms))
                      for c in spans if c.parent == i)
        covered, end = 0.0, s.device_start_ms
        for a, b in kids:
            a = max(a, end)
            if b > a:
                covered += b - a
                end = b
        total += _ms(s) - covered
    return total if found else None


def window(t) -> Optional[tuple]:
    """``(spans, n)``: the program's spans and the number of iterations
    they hold, for the traced window ``t`` (``harness.Traced``); None
    where they cannot be read."""
    got = recorded()
    if got is None:
        return None
    spans, dropped = got
    root = ROOTS.get(t.traffic.get("driver"))
    n = iterations(spans, dropped, t.iterations, root)
    return None if n is None else (spans, n)


def per_iteration(t, reading: Callable[[Sequence], Optional[float]]
                  ) -> Optional[float]:
    """``reading(spans)`` over the number of iterations of the traced
    window ``t``; None where the spans or the reading are."""
    w = window(t)
    v = None if w is None else reading(w[0])
    return None if v is None else v / w[1]


def named(name: str) -> Callable[[str], bool]:
    return lambda s: s == PREFIX + name


def exchange_gbps(spans: Sequence) -> Optional[float]:
    """The exchange spans' ``bytes`` over their device time, GB/s (1e9
    bytes); None where no exchange span counts its bytes."""
    xs = [s for s in outermost(spans, lambda n: n.startswith(EXCHANGE_PREFIX))
          if "bytes" in s.counts]
    seconds = sum(_ms(s) for s in xs) / 1e3
    if not xs or seconds <= 0:
        return None
    return sum(s.counts["bytes"] for s in xs) / seconds / 1e9
