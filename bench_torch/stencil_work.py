"""The work of one explicit stencil step, from the configuration alone,
and the readings of the heat steps' spans.

The bytes come from the configuration: those any implementation of the
pass must move, so the roofline reads the same work whatever runs it.
The program's own ``bytes`` count of the pass is read only to hold it to
that work (:func:`pass_bytes`).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

from bench_torch import spans, yardstick

ITEMSIZE = {"float32": 4, "float64": 8, "bfloat16": 2, "float16": 2}
#: the root span of one heat step (``ops/stencil.py``'s ``diffusion_step``)
ROOT = spans.PREFIX + "diffusion_step_axis0"
PASS = spans.PREFIX + "stencil_pass"


def step_bytes(gdims: Sequence[int], pdims: Sequence[int],
               itemsize: int) -> int:
    """Bytes one rank's stencil pass must move in a step on its X-pencil:
    it reads its share of the field once and writes it once, and reads the
    two ghost planes of each dim split over more than one rank."""
    _, shape, _ = yardstick.pencil(gdims, pdims, 0, False, 0)
    cells = math.prod(shape)
    split = [p > 1 for p in pdims]   # Y over pdims[0], Z over pdims[1]
    ghosts = sum(2 * cells // shape[d] for d, s in zip((1, 2), split) if s)
    return itemsize * (2 * cells + ghosts)


def _ms(s) -> float:
    return s.device_end_ms - s.device_start_ms


def _self_ms(s: Sequence, r: int) -> float:
    """Device time of span ``r`` less the union of its children's
    intervals, each clipped to it."""
    lo, hi = s[r].device_start_ms, s[r].device_end_ms
    covered, end = 0.0, lo
    for a, b in sorted((max(c.device_start_ms, lo), min(c.device_end_ms, hi))
                       for c in s if c.parent == r):
        a = max(a, end)
        if b > a:
            covered += b - a
            end = b
    return _ms(s[r]) - covered


def per_step(t, reading: Callable[[Sequence, int, List[int]],
                                  Optional[float]]) -> Optional[float]:
    """The mean over the steady heat steps of the traced window ``t``
    (``harness.Traced``) of ``reading(spans, root, mine)``: ``root`` the
    index of a step's :data:`ROOT` span, ``mine`` the indices of the spans
    under it.  The first step of each window is left out: the window opens
    on an idle device under a fresh profiler session, and that step's
    spans hold the host's first enqueue.  None where the spans cannot be
    read (``spans.iterations``), where a steady step has no
    ``stencil_pass`` span (a program without it), or where a reading is
    None."""
    got = spans.recorded()
    if got is None:
        return None
    s, dropped = got
    if spans.iterations(s, dropped, t.iterations, ROOT) is None:
        return None
    top = []
    for x in s:      # a span is recorded after its parent
        top.append(len(top) if x.parent is None else top[x.parent])
    roots = [i for i, x in enumerate(s) if x.parent is None and x.name == ROOT]
    vals = []
    for k, r in enumerate(roots):
        if k % t.iterations == 0:
            continue
        mine = [i for i in range(len(s)) if top[i] == r]
        if not any(s[i].name == PASS for i in mine):
            return None
        v = reading(s, r, mine)
        if v is None:
            return None
        vals.append(v)
    return sum(vals) / len(vals) if vals else None


def pass_ms(t) -> Optional[float]:
    """Device milliseconds a steady heat step in the ``stencil_pass``
    spans."""
    return per_step(t, lambda s, r, mine: sum(_ms(s[i]) for i in mine
                                              if s[i].name == PASS))


def self_ms(t) -> Optional[float]:
    """Device milliseconds a steady heat step in its :data:`ROOT` span
    outside the span's children."""
    return per_step(t, lambda s, r, mine: _self_ms(s, r))


def pass_bytes(t) -> Optional[float]:
    """The ``bytes`` the ``stencil_pass`` spans of a steady heat step
    count; None where a pass counts none."""
    def count(s, r, mine):
        xs = [s[i].counts.get("bytes") for i in mine if s[i].name == PASS]
        return None if None in xs else sum(xs)
    return per_step(t, count)
