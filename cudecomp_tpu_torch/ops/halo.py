"""Halo (ghost-cell) exchange engine (``cudecompUpdateHalos_``,
``include/internal/halo.h:40-315``).

Per-dim nearest-neighbour exchange of this rank's local pencil tensor,
with optional periodic wrap:

  * a dim that one rank holds whole: a periodic dim copies its own edge
    slabs into its halos (the reference's case 0, ``halo.h:164-193``); a
    non-periodic one has nothing to exchange;
  * a dim sharded over more than one rank: the two edge slabs travel to the
    neighbours and land in their halos.  ``HaloMethod.PPERMUTE`` sends them
    with paired ``ppermute`` shifts over the mesh dim's process group
    (:func:`halo_ring`); ``HaloMethod.PALLAS`` puts them with K3, the
    one-sided halo kernel
    (:func:`~cudecomp_tpu_torch.ops.peer_kernels.halo_exchange`), on a
    tensor off the CPU, and takes the ring on a CPU tensor, as the JAX
    package does off the TPU.  On uneven splits each rank sends from its own valid extent.
    At a non-periodic edge the rank keeps its old halo (the reference skips
    that side, ``halo.h:232-260``).

The halo slabs are written into the caller's tensor with slice assignment
and the same tensor is returned: the reference's buffer semantics
(``halo.h:61-70``).  While the performance report is on, each call
records one sample (``performance.maybe_record``).

Buffer layout (padded-pencil format, see ``geometry``): along a dim with
halo ``h`` and max split ``m`` the local tensor holds ``[low halo: 0..h)
[interior: h..h+valid) [zeros..h+m) [high halo: h+m..h+2h+m)
[padding...]``.
"""

from __future__ import annotations

import torch.distributed as dist

from cudecomp_tpu_torch import geometry, performance
from cudecomp_tpu_torch.config import CannotRun, HaloMethod
from cudecomp_tpu_torch.geometry import _check_extents
from cudecomp_tpu_torch.ops import peer_kernels
from cudecomp_tpu_torch.parallel.collectives import (neighbour_pairs,
                                                     ppermute_group)
from cudecomp_tpu_torch.utils.tracing import EXCHANGE_PREFIX, trace_range

_NAMES = ("x", "y", "z")


def update_halos(grid, arr, axis: int, halo_extents, halo_periods,
                 dim=None, padding=None, donate: bool = False):
    """Update the halo regions of this rank's pencil tensor in place
    (``cudecompUpdateHalos{X,Y,Z}``, ``include/cudecomp.h:661-715``).

    Args:
      grid: GridDescriptor.
      arr: this rank's local tensor in the pencil-``axis`` layout with halo
        regions (``grid.buffer_shape(axis, halo_extents, padding)``, plus
        any trailing component dims).
      axis: pencil axis (0=X, 1=Y, 2=Z).
      halo_extents: per-global-dim halo widths baked into the buffer.
      halo_periods: per-global-dim periodicity.
      dim: which global dim to update; None updates every dim with a
        nonzero halo extent, in order, so that edges and corners compose
        like successive reference calls.
      donate: accepted for parity with the JAX API; it has no effect, since
        the halos are always written into ``arr``.

    Returns ``arr``, with its halos updated.
    """
    cfg = grid.config
    halo = _check_extents(halo_extents, "halo_extents")
    pad = _check_extents(padding, "padding")
    periods = tuple(bool(p) for p in halo_periods)
    if len(periods) != 3:
        raise ValueError("halo_periods must have length 3")
    if axis not in (0, 1, 2):
        raise ValueError(f"axis out of range: {axis}")

    expected = geometry.pencil_buffer_shape(cfg, axis, halo, pad)
    if arr.dim() < 3 or tuple(arr.shape[:3]) != expected:
        raise ValueError(
            f"update_halos: input shape {tuple(arr.shape)} does not match "
            f"pencil layout {expected} (halos {halo}, padding {pad}; trailing "
            f"component dims are allowed)")
    if arr.device != grid.device:
        raise ValueError(f"input on {arr.device}, grid on {grid.device}")

    dims = [dim] if dim is not None else [d for d in range(3) if halo[d] > 0]
    for d in dims:
        if d not in (0, 1, 2):
            raise ValueError(f"dim out of range: {d}")
    dims = tuple(d for d in dims if halo[d] > 0)
    if not dims:
        return arr  # reference returns early on zero halo (cudecomp.cc:1930-1933)

    # every width is checked before any halo is written
    plans = [_dim_plan(grid, axis, d, halo) for d in dims]
    tag = "".join(map(str, dims))

    def run(a):
        for d, plan in zip(dims, plans):
            _update_dim(grid, a, d, periods[d], *plan)
        return a

    def perf_key():
        # the key and bytes of the JAX package's samples: one face slab
        # per direction and dim
        ms = geometry.max_splits(cfg, axis)
        slabs = 0
        for d in dims:
            other = [ms[g] for g in range(3) if g != d]
            slabs += halo[d] * other[0] * other[1]
        key = (f"update_halos_axis{axis}_dims{tag}", cfg.gdims, cfg.pdims,
               cfg.halo_method.value, performance.dtype_name(arr.dtype),
               tuple(halo), periods, tuple(pad), bool(donate))
        return key, int(2 * slabs * arr.element_size())

    with trace_range(f"cudecomp_tpu_torch.update_halos_{_NAMES[axis]}_dims"
                     f"{tag}"):
        return performance.maybe_record(perf_key, run, arr)


def _dim_plan(grid, axis: int, d: int, halo):
    """(array dim, halo width, max split, mesh dim position, ranks, splits)
    of global dim ``d``; raises on a halo wider than the smallest split."""
    cfg = grid.config
    h = halo[d]
    i_d = cfg.inv_mem_order(axis)[d]  # array dim holding global dim d
    m = geometry.max_splits(cfg, axis)[d]
    pd = geometry.shard_pdim_of_dim(axis, d)
    P = cfg.pdims[pd] if pd is not None else 1
    splits = ((cfg.gdims[d],) if pd is None
              else geometry._dist_splits(cfg, d, P))
    # reference rejects halos wider than (neighbour) pencils (halo.h:120-145)
    if h > min(splits):
        raise CannotRun(
            f"halo width {h} along dim {d} exceeds smallest pencil extent "
            f"{min(splits)}")
    return i_d, h, m, pd, P, splits


def _update_dim(grid, arr, d, periodic, i_d, h, m, pd, P, splits):
    """Exchange and write the two halo slabs of global dim ``d``."""

    def sl(start, stop):
        return (slice(None),) * i_d + (slice(start, stop),)

    if P == 1:
        if periodic:
            v = splits[0]
            arr[sl(0, h)] = arr[sl(v, v + h)]
            arr[sl(h + m, 2 * h + m)] = arr[sl(h, 2 * h)]
        return  # non-periodic: nothing to exchange, edge halos untouched

    group = grid.group(grid.axis_names[pd])
    if (grid.config.halo_method == HaloMethod.PALLAS
            and arr.device.type != "cpu"):
        with trace_range(EXCHANGE_PREFIX + "halo_pallas"):
            peer_kernels.halo_exchange(arr, group, i_d, h, m, splits,
                                       periodic)
    else:
        # also K3's plain version, which the CPU takes for HaloMethod.PALLAS
        halo_ring(arr, group, i_d, h, m, splits, periodic)


def halo_ring(arr, group, i_d: int, h: int, m: int, splits, periodic: bool):
    """Update the two halos of array dim ``i_d`` of ``arr`` in place with
    paired ``ppermute`` shifts over ``group``: width ``h``, max split ``m``,
    rank r's valid extent ``splits[r]``.  At a non-periodic edge the halo
    keeps its values."""
    P = len(splits)
    me = dist.get_rank(group)
    v = splits[me]

    def sl(start, stop):
        return (slice(None),) * i_d + (slice(start, stop),)

    up, down = neighbour_pairs(P, periodic)
    # my last h interior cells go up, my first h go down
    from_left = ppermute_group(arr[sl(v, v + h)], group, up)
    from_right = ppermute_group(arr[sl(h, 2 * h)], group, down)
    if periodic or me > 0:
        arr[sl(0, h)] = from_left
    if periodic or me < P - 1:
        arr[sl(h + m, 2 * h + m)] = from_right
