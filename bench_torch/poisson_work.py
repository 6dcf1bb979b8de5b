"""The work of K5 in one spectral Poisson solve, from the configuration
alone, and the readings of the solve's spans.

K5's bytes come from the configuration: the half spectrum's planes read
and written once by each of the solve's two (Y, Z) transforms, so that
the roofline reads the same work whatever implements the transform.  The
spans are read per solve: divided by the number of ``poisson_solve``
roots of the traced window (``spans.iterations``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

from bench_torch import spans

#: bytes of one complex spectral value, by the configuration's dtype
COMPLEX_ITEMSIZE = {"float32": 8, "float64": 16}
#: the root span of one solve (``models/poisson.py``'s
#: ``PoissonSolver.solve``)
ROOT = spans.PREFIX + "poisson_solve"
#: the (Y, Z) transforms of a solve: one forward, one inverse
TRANSFORMS = 2


def k5_bytes(gdims: Sequence[int], pdims: Sequence[int],
             itemsize: int) -> int:
    """Bytes one rank's (Y, Z) transforms must move in a solve: each of
    :data:`TRANSFORMS` reads and writes the rank's share of the r2c half
    spectrum, ``(X // 2 + 1) Y Z`` values, once."""
    points = (gdims[0] // 2 + 1) * gdims[1] * gdims[2]
    return TRANSFORMS * 2 * itemsize * points // math.prod(pdims)


def per_solve_ms(t, name: str) -> Optional[float]:
    """Device milliseconds a solve of the traced window ``t``
    (``harness.Traced``) in the outermost spans called ``name`` under the
    :data:`ROOT` spans (``name`` the root itself: the whole solve); None
    where the spans cannot be read or none has that name."""
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
