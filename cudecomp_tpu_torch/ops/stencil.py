"""Ghost-plane stencil pipeline: the halo -> stencil consumer path
(``cudecomp_tpu.ops.stencil``).

The reference's halo engine exists to serve stencil applications
(``include/internal/halo.h:40-315``).  Here the state stays in the plain
interior pencil layout (no halo regions), and each call

  * exchanges width-1 ghost planes as separate small tensors: a
    :func:`~cudecomp_tpu_torch.parallel.collectives.ppermute` shift over
    the mesh dim that shards a dim, the rank's own opposite edge plane for
    an unsharded periodic dim, zeros at a non-periodic edge (a rank that
    no neighbour sends to receives zeros: the Dirichlet-0 convention);
  * applies the stencil in one pass with K4 (``ops.stencil_kernel``), in
    ghost-plane mode where every tap is servable from the planes, and
    otherwise in valid mode over the ghost-extended block.

Every ``stencil_apply``, ``laplacian7`` and ``diffusion_step`` call on a
CUDA tensor launches K4 exactly once (a tensor ``dt`` adds an
elementwise axpy pass), and its backward once more.  :func:`halo_map` is
the width-generic escape hatch for user stencils.

Two spans time each pass from inside the public op's span:
``stencil_ghosts`` around the ghost exchange or extension (count
``bytes``: the ghost cells made or moved, 0 where every dim wraps inside
K4) and ``stencil_pass`` around the K4 launch (counts ``bytes``: the
block, ghost planes and output it reads and writes; ``points``: the
output cells).

Tap offsets index the BUFFER's memory dims, while ``halo_periods`` is
indexed by GLOBAL dims, as in the JAX package.  Sharded extents must
divide evenly (``update_halos`` serves uneven grids).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from cudecomp_tpu_torch import geometry
from cudecomp_tpu_torch.ops import stencil_kernel as K
from cudecomp_tpu_torch.parallel.collectives import neighbour_pairs, ppermute
from cudecomp_tpu_torch.utils.tracing import trace_range

__all__ = ["laplacian7", "diffusion_step", "halo_map", "stencil_apply"]


def _shard_dims(grid, axis: int):
    """Per memory dim: (mesh dim name or None, ranks along it)."""
    cfg = grid.config
    order = cfg.mem_order(axis)
    out = []
    for i in range(3):
        pd = geometry.shard_pdim_of_dim(axis, order[i])
        if pd is None:
            out.append((None, 1))
        else:
            out.append((grid.axis_names[pd], cfg.pdims[pd]))
    return tuple(out)


def _local_extents(grid, axis: int) -> Tuple[int, int, int]:
    """Per-rank interior extents in memory order; raises on non-divisible
    sharded extents (the ghost-plane pipeline has no pad-to-max
    machinery: use ``update_halos`` for ragged grids)."""
    cfg = grid.config
    order = cfg.mem_order(axis)
    ext = []
    for i, (_, P) in enumerate(_shard_dims(grid, axis)):
        g = cfg.gdims[order[i]]
        if g % P:
            raise ValueError(
                f"ghost-plane stencil requires divisible extents; global dim "
                f"{order[i]} has {g} over {P} shards (use update_halos for "
                f"uneven grids)")
        ext.append(g // P)
    return tuple(ext)


def _neighbour_slabs(ul, d, w, name, P, periodic, mesh):
    """The ``(lo, hi)`` ghost slabs of width ``w`` on both sides of memory
    dim ``d``: ``lo`` holds the left neighbour's last ``w`` planes, ``hi``
    the right neighbour's first ``w``.

    Sharded dims shift over their mesh dim (the wrap pairs are dropped for
    non-periodic dims, so the edge ranks receive zeros); unsharded dims
    wrap locally (periodic) or take zero slabs."""
    n = ul.shape[d]
    lo_slab = ul.narrow(d, 0, w)        # my low planes
    hi_slab = ul.narrow(d, n - w, w)    # my high planes
    if P == 1:
        if periodic:
            return hi_slab, lo_slab
        return torch.zeros_like(hi_slab), torch.zeros_like(lo_slab)
    up, down = neighbour_pairs(P, periodic)
    # my high planes travel up and become the neighbour's lo ghost
    return (ppermute(hi_slab, mesh, name, up),
            ppermute(lo_slab, mesh, name, down))


def _exchange_ghosts(ul, shard, periods_mem, mesh):
    """Per memory dim, the width-1 ``(lo, hi)`` ghost planes of this rank's
    block."""
    return [_neighbour_slabs(ul, d, 1, *shard[d], periods_mem[d], mesh)
            for d in range(3)]


def _extend_dim(ul, d, w, name, P, periodic, mesh):
    """Extend a local block by ``w`` ghost planes on both sides of dim
    ``d``."""
    lo, hi = _neighbour_slabs(ul, d, w, name, P, periodic, mesh)
    return torch.cat([lo, ul, hi], dim=d)


def _ghost_extend(ul, widths, shard, periods_mem, mesh):
    """The block extended dim by dim, so corner ghosts compose like
    successive reference halo calls."""
    for d in range(3):
        if widths[d]:
            name, P = shard[d]
            ul = _extend_dim(ul, d, widths[d], name, P, periods_mem[d], mesh)
    return ul


def _periods_mem(grid, axis, periods):
    order = grid.config.mem_order(axis)
    return tuple(periods[order[d]] for d in range(3))


def halo_map(grid, u, fn, axis: int = 0, width=1,
             halo_periods=(True, True, True)):
    """Apply a user stencil ``fn`` to this rank's block extended by ghost
    cells: the functional, width-generic form of the reference's
    halo'd-buffer contract (``cudecompUpdateHalos`` + user stencil,
    ``halo.h:40-315``) with no persistent halo regions in the user's
    tensors.

    ``u`` is this rank's halo-free pencil-``axis`` tensor; its block of
    shape ``(mx, my, mz)`` is extended to ``(mx+2wx, my+2wy, mz+2wz)``
    with neighbour data (``width`` is an int or a per-memory-dim triple;
    dims are extended in order, so corner and edge ghosts compose exactly
    like successive reference halo calls), and ``fn`` maps the extended
    block back to ``(mx, my, mz)``.  Trailing component dims pass through
    unsharded and unextended; ``fn`` sees them and may change them (vector
    -> scalar divergence, scalar -> vector gradient).  The output shape is
    probed by calling ``fn`` on a tensor on the ``meta`` device first.
    Non-periodic edges see zero ghosts (Dirichlet); sharded extents must
    divide evenly.  Every rank of the grid must call.
    """
    if axis not in (0, 1, 2):
        raise ValueError(f"axis out of range: {axis}")
    if u.dim() < 3:
        raise ValueError("halo_map expects a 3D pencil tensor (plus "
                         "optional trailing component dims)")
    widths = ((int(width),) * 3 if np.isscalar(width)
              else tuple(int(w) for w in width))
    if len(widths) != 3 or any(w < 0 for w in widths):
        raise ValueError(f"invalid width {width!r}")
    periods = tuple(bool(p) for p in halo_periods)
    if len(periods) != 3:
        raise ValueError("halo_periods must have length 3")
    expected = grid.buffer_shape(axis)
    if tuple(u.shape[:3]) != expected:
        raise ValueError(
            f"halo_map: input shape {tuple(u.shape)} does not match the "
            f"halo-free pencil layout {expected}")
    comp = tuple(u.shape[3:])
    interior = _local_extents(grid, axis)
    for d in range(3):
        if widths[d] > interior[d]:
            raise ValueError(
                f"ghost width {widths[d]} exceeds the local extent "
                f"{interior[d]} of memory dim {d} (halo.h:120-145 analog)")

    # ``fn`` may change the trailing component dims: probe its output shape
    # on the meta device, before any exchange
    ext_shape = tuple(interior[d] + 2 * widths[d] for d in range(3)) + comp
    probe = fn(torch.empty(ext_shape, dtype=u.dtype, device="meta"))
    if tuple(probe.shape[:3]) != interior:
        raise ValueError(
            f"halo_map fn returned spatial shape {tuple(probe.shape)}; "
            f"expected the interior block extents {interior} (+ any "
            f"trailing component dims)")
    want = tuple(probe.shape)

    with trace_range(f"cudecomp_tpu_torch.halo_map_axis{axis}"):
        ue = _ghost_extend(u, widths, _shard_dims(grid, axis),
                           _periods_mem(grid, axis, periods), grid.mesh)
        out = fn(ue)
    if tuple(out.shape) != want:
        raise ValueError(f"halo_map fn returned shape {tuple(out.shape)}; "
                         f"expected the interior block shape {want}")
    return out


def _tap_ok(offset, wrap) -> bool:
    """Whether ghost-plane mode serves the tap (JAX's ``tap_ok``,
    ``stencil.py:433-440``): wrap dims compose freely, an x-ghost plane at
    any tap, a y/z ghost plane at pure face taps only."""
    nz = [d for d, o in enumerate(offset) if o]
    gyz = [d for d in nz if d in (1, 2) and not wrap[d]]
    return not gyz or (len(gyz) == 1 and len(nz) == 1)


def _stencil_apply_impl(grid, u, w, axis, periods):
    """One K4 launch: ghost-plane mode when every tap is servable, valid
    mode over the ghost-extended block otherwise."""
    if len(periods) != 3:
        raise ValueError("halo_periods must have length 3")
    if axis not in (0, 1, 2):
        raise ValueError(f"axis out of range: {axis}")
    if u.dim() != 3:
        raise ValueError("stencil_apply expects a plain 3D pencil tensor")
    expected = grid.buffer_shape(axis)
    if tuple(u.shape) != expected:
        raise ValueError(
            f"stencil_apply: input shape {tuple(u.shape)} does not match "
            f"the halo-free pencil layout {expected}")
    _local_extents(grid, axis)  # rejects uneven shards before any exchange
    shard = _shard_dims(grid, axis)
    periods_mem = _periods_mem(grid, axis, periods)
    wrap = tuple(shard[d][1] == 1 and periods_mem[d] for d in range(3))
    u = u.contiguous()
    item, cells = u.element_size(), u.numel()
    if all(_tap_ok(off, wrap) for off, _ in K.taps(w)):
        # the planes of each dim that does not wrap inside K4
        ghost_bytes = item * sum(2 * cells // u.shape[d] for d in range(3)
                                 if not wrap[d])
        with trace_range("cudecomp_tpu_torch.stencil_ghosts",
                         bytes=ghost_bytes):
            ghosts = _exchange_ghosts(u, shard, periods_mem, grid.mesh)
            planes = tuple(None if wrap[d]
                           else tuple(p.contiguous() for p in ghosts[d])
                           for d in range(3))
        with trace_range("cudecomp_tpu_torch.stencil_pass",
                         bytes=2 * item * cells + ghost_bytes, points=cells):
            return K.stencil27(u, w, planes)
    # corner taps across a ghost y/z dim: the ghost-extended block
    ext_cells = math.prod(n + 2 for n in u.shape)
    with trace_range("cudecomp_tpu_torch.stencil_ghosts",
                     bytes=item * (ext_cells - cells)):
        ue = _ghost_extend(u, (1, 1, 1), shard, periods_mem, grid.mesh)
    with trace_range("cudecomp_tpu_torch.stencil_pass",
                     bytes=item * (ext_cells + cells), points=cells):
        return K.stencil27(ue, w)


class _StencilApply(torch.autograd.Function):
    """A linear stencil whose adjoint is the stencil with reflected taps
    ``w[::-1, ::-1, ::-1]``: exact for periodic wrap and for Dirichlet
    zero ghosts alike (the zero-ghost operator's transpose)."""

    @staticmethod
    def forward(ctx, u, grid, axis, periods, w_bytes):
        ctx.key = (grid, axis, periods, w_bytes)
        w = np.frombuffer(w_bytes, dtype=np.float64).reshape(3, 3, 3)
        return _stencil_apply_impl(grid, u, w, axis, periods)

    @staticmethod
    def backward(ctx, g):
        grid, axis, periods, w_bytes = ctx.key
        w = np.frombuffer(w_bytes, dtype=np.float64).reshape(3, 3, 3)
        w_adj = np.ascontiguousarray(w[::-1, ::-1, ::-1]).tobytes()
        return (_stencil_apply_fn(grid, axis, periods, w_adj)(g),
                None, None, None, None)


@lru_cache(maxsize=256)
def _stencil_apply_fn(grid, axis, periods, w_bytes: bytes):
    """Cached differentiable apply for one (grid, weights) configuration;
    adjoint = reflected taps (see :class:`_StencilApply`)."""

    def f(u):
        return _StencilApply.apply(u, grid, axis, periods, w_bytes)

    return f


def stencil_apply(grid, u, weights, axis: int = 0,
                  halo_periods=(True, True, True)):
    """Apply a compact 3x3x3 stencil to this rank's halo-free pencil
    tensor: ``out[i,j,k] = sum weights[1+dx,1+dy,1+dz] * u[i+dx, j+dy,
    k+dz]`` with periodic or Dirichlet-zero boundaries per dim.

    Tap offsets index the BUFFER's memory dims (for the natural layout
    these are global X/Y/Z; under ``transpose_axis_contiguous`` or
    ``transpose_mem_order`` map your taps through
    ``grid.config.mem_order(axis)``), while ``halo_periods`` is indexed by
    GLOBAL dims, matching ``update_halos``.

    ``weights`` is a host array; zero taps cost nothing.  One K4 pass
    serves every tap set: in ghost-plane mode when each tap is servable
    from the ghost planes (every face-only tap set on any mesh; dense sets
    when y and z are local and periodic), in valid mode over the
    ghost-extended block otherwise.  Differentiable: the backward is the
    stencil with reflected offsets, one more K4 pass.
    """
    w = K.as_weights(weights)
    periods = tuple(bool(p) for p in halo_periods)
    with trace_range(f"cudecomp_tpu_torch.stencil_apply_axis{axis}"):
        return _stencil_apply_fn(grid, axis, periods, w.tobytes())(u)


@lru_cache(maxsize=256)
def _diff_apply_fn(grid, axis, periods, alpha, beta):
    """Differentiable ``alpha*I + beta*L`` apply for one (grid, operator),
    as the face-tap stencil {centre: alpha - 6*beta, faces: beta}; cached
    so repeated calls skip the weight rebuild.  Self-adjoint, so the
    reflected-tap backward reuses the same apply."""
    w = np.zeros((3, 3, 3), np.float64)
    for d in range(3):
        lo = [1, 1, 1]
        hi = [1, 1, 1]
        lo[d], hi[d] = 0, 2
        w[tuple(lo)] = w[tuple(hi)] = beta
    w[1, 1, 1] = alpha - 6.0 * beta
    return _stencil_apply_fn(grid, axis, periods, w.tobytes())


def laplacian7(grid, u, axis: int = 0, halo_periods=(True, True, True)):
    """7-point Laplacian of this rank's halo-free pencil tensor (unit grid
    spacing): one ghost-plane exchange and one K4 pass.  Non-periodic
    edges use zero (Dirichlet) ghost planes.  Differentiable
    (self-adjoint)."""
    periods = tuple(bool(p) for p in halo_periods)
    with trace_range(f"cudecomp_tpu_torch.laplacian7_axis{axis}"):
        return _diff_apply_fn(grid, axis, periods, 0.0, 1.0)(u)


def diffusion_step(grid, u, dt, axis: int = 0,
                   halo_periods=(True, True, True)):
    """One explicit diffusion step ``u + dt * lap(u)``, the axpy folded
    into K4's weights (one pass).  A ``dt`` that is a tensor takes the
    two-pass ``u + dt * laplacian7(u)``, as a traced ``dt`` does in the JAX
    package.  Differentiable."""
    periods = tuple(bool(p) for p in halo_periods)
    with trace_range(f"cudecomp_tpu_torch.diffusion_step_axis{axis}"):
        if isinstance(dt, torch.Tensor):
            return u + dt * laplacian7(grid, u, axis, periods)
        return _diff_apply_fn(grid, axis, periods, 1.0, float(dt))(u)
