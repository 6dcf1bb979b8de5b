"""The work of one CG iteration, from the configuration alone, and the
readings of the CG iterations' spans.

The bytes come from the configuration: those any implementation of the
standard iteration must move on the rank's X-pencil, so that the
roofline reads the same work whatever runs it.  The spans are read per
iteration: divided by the number of ``cg_iter`` roots of the traced
window (``spans.iterations``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

from bench_torch import spans, yardstick

ITEMSIZE = {"float32": 4, "float64": 8}
#: the root span of one CG iteration (``models/poisson.py``'s
#: ``PoissonSolver.cg_iterate``)
ROOT = spans.PREFIX + "cg_iter"
#: vectors a standard CG iteration must read or write: the matvec reads p
#: and writes Ap (p . Ap taken on the way), u += alpha p reads two and
#: writes one, r -= alpha Ap the same (r . r taken on the way), p = r +
#: beta p the same
VECTORS = 11


def iter_bytes(gdims: Sequence[int], pdims: Sequence[int],
               itemsize: int) -> int:
    """Bytes one rank must move in a CG iteration on its X-pencil: each of
    :data:`VECTORS` passes over its share of the grid once (the ghost
    planes of split dims, and the scalars, left out)."""
    _, shape, _ = yardstick.pencil(gdims, pdims, 0, False, 0)
    return VECTORS * itemsize * math.prod(shape)


def per_iteration_ms(t, name: str) -> Optional[float]:
    """Device milliseconds a CG iteration of the traced window ``t``
    (``harness.Traced``) in the outermost spans called ``name`` under the
    :data:`ROOT` spans (``name`` the root itself: the whole iteration);
    None where the spans cannot be read or none has that name."""
    got = spans.recorded()
    if got is None:
        return None
    s, dropped = got
    n = spans.iterations(s, dropped, t.iterations, ROOT)
    if n is None:
        return None
    v = spans.span_ms(s, spans.named(name),
                      None if spans.PREFIX + name == ROOT else ROOT)
    return None if v is None else v / n
