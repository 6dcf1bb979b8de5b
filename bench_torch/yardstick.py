"""The benchmark's arithmetic: rates, byte counts, pencil layouts and the
table of peaks.  Nothing here reads the program: the layouts follow
cuDecomp's definitions, and the tests hold them to the program's.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Optional, Sequence, Tuple

#: published peaks by ``torch.cuda.get_device_name()`` (NVIDIA's data
#: sheet, SXM part, dense rates, at the full 700 W power limit)
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "fp32_flops_per_s": 67e12,
        "tf32_flops_per_s": 495e12,
        "bf16_flops_per_s": 989e12,
    },
}


def peak(device_name: str, key: str) -> Optional[float]:
    """The published peak ``key`` of the named device, or None for a device
    the table does not hold."""
    return PEAKS.get(device_name, {}).get(key)


def fft_gflops(n_points: int, seconds_per_direction: float) -> float:
    """cuDecomp's FFT rate, 5 n log2(n) / t, with ``n`` the grid's points
    and ``t`` the seconds of one direction (``benchmark/benchmark.cu:658``)."""
    return 5.0 * n_points * math.log2(n_points) / seconds_per_direction / 1e9


def worst(values) -> float:
    """The largest of ``values``, or NaN where any is NaN (Python's
    ``max`` passes over a NaN)."""
    out = -math.inf
    for v in values:
        if math.isnan(v):
            return math.nan
        out = max(out, v)
    return out


def percentile(values: Sequence[float], q: int) -> float:
    """The ``q``-th percentile (1-99) of ``values``, by Python's inclusive
    quantiles."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


# -- pencils ------------------------------------------------------------------
#
# cuDecomp's pencils: an X-pencil holds X whole and splits Y over the
# process grid's rows (pr) and Z over its columns (pc); a Y-pencil splits X
# over pr and Z over pc; a Z-pencil X over pr and Y over pc.  Ranks are
# row-major on the (pr, pc) grid.  A pencil's tensor dim i holds global
# axis ``order[i]`` (C order: the last dim is contiguous); the natural
# order is (0, 1, 2), and the axis-contiguous order of pencil a is
# ((a + 1) % 3, (a + 2) % 3, a) (``src/cudecomp.cc:1120-1133``).

_SHARDS = {0: {1: 0, 2: 1}, 1: {0: 0, 2: 1}, 2: {0: 0, 1: 1}}


def mem_order(axis: int, axis_contiguous: bool) -> Tuple[int, int, int]:
    if axis_contiguous:
        return ((axis + 1) % 3, (axis + 2) % 3, axis)
    return (0, 1, 2)


def coords(rank: int, pdims: Sequence[int]) -> Tuple[int, int]:
    return divmod(rank, pdims[1])


def pencil(gdims: Sequence[int], pdims: Sequence[int], axis: int,
           axis_contiguous: bool, rank: int):
    """``(order, shape, lo)`` of this rank's pencil ``axis``: the memory
    order, the local tensor's shape and the global index of its first
    element per global axis.  Only even splits are laid out."""
    c = coords(rank, pdims)
    extent, lo = [], []
    for g in range(3):
        pd = _SHARDS[axis].get(g)
        parts = 1 if pd is None else pdims[pd]
        if gdims[g] % parts:
            raise ValueError(f"gdims {tuple(gdims)} do not split evenly over "
                             f"pdims {tuple(pdims)}")
        n = gdims[g] // parts
        extent.append(n)
        lo.append(0 if pd is None else c[pd] * n)
    order = mem_order(axis, axis_contiguous)
    return order, tuple(extent[g] for g in order), tuple(lo)


def natural(t, order):
    """A view of pencil tensor ``t`` (memory order ``order``) with its dims
    in global (X, Y, Z) order."""
    return t.permute(*[order.index(g) for g in range(3)])


def transposes_per_direction(pdims: Sequence[int],
                             axis_contiguous: bool) -> int:
    """Global transposes in one direction of cuDecomp's FFT: X->Y and
    Y->Z, each skipped where its process-grid factor is 1 and the two
    pencils' memory orders agree, so that the FFT stages around it fuse
    (``benchmark/benchmark.cu:294-356``)."""
    if axis_contiguous:
        return 2
    return int(pdims[0] > 1) + int(pdims[1] > 1)


def transpose_bytes_per_round_trip(gdims: Sequence[int], pdims: Sequence[int],
                                   itemsize: int,
                                   axis_contiguous: bool) -> int:
    """Bytes one rank's transposes must move in a forward and inverse
    round trip: each transpose reads and writes the rank's share of the
    field once."""
    share = math.prod(gdims) // (pdims[0] * pdims[1]) * itemsize
    return 2 * 2 * transposes_per_direction(pdims, axis_contiguous) * share
