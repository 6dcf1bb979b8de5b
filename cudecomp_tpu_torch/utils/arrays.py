"""Conversion between plain global tensors and this rank's local pencil in
the padded-pencil format, plus masking.

The padded-pencil format (see ``geometry``): every rank's local tensor has
the maximum split size along each sharded dim; ranks owning fewer elements
leave zeros at the tail.  Halo regions sit at fixed offsets computed from
the *maximum* extent: along a global axis with halo ``h`` and max split
``m`` the layout is ``[low halo: 0..h) [interior: h..h+valid) [pad zeros:
h+valid..h+m) [high halo: h+m..h+m+h) [extra padding ...]``.

These helpers are for IO and testing; the hot path never calls them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from cudecomp_tpu_torch import geometry
from cudecomp_tpu_torch.geometry import _check_extents


def _interior_slices(cfg, axis, coords, halo, pad):
    """(slices into the local tensor, slices into the global tensor by
    global axis) of the valid interior of the rank at ``coords``."""
    order = cfg.mem_order(axis)
    pinfo = geometry.get_pencil_info(cfg, axis, coords, halo, pad)
    lo_g, hi_g = pinfo.lo_g, pinfo.hi_g
    sl_local, sl_global = [], [None] * 3
    for i in range(3):
        g = order[i]
        valid = hi_g[g] - lo_g[g] + 1
        sl_local.append(slice(halo[g], halo[g] + valid))
        sl_global[g] = slice(lo_g[g], lo_g[g] + valid)
    return tuple(sl_local), tuple(sl_global)


def scatter_global(grid, x_global, axis: int, halo_extents=None,
                   padding=None, fill_halos: bool = False) -> torch.Tensor:
    """This rank's local pencil ``axis`` of a global tensor (natural
    [X, Y, Z] order, shape ``gdims``, a tensor or a numpy array), on the
    grid's device.  Padding regions are zero; halo regions are zero too,
    or, with ``fill_halos=True``, hold the (periodic) global data,
    corners included."""
    cfg = grid.config
    halo = _check_extents(halo_extents, "halo_extents")
    pad = _check_extents(padding, "padding")
    x = torch.as_tensor(x_global)
    if tuple(x.shape) != cfg.gdims:
        raise ValueError(f"global array shape {tuple(x.shape)} != gdims "
                         f"{cfg.gdims}")
    shape = geometry.pencil_buffer_shape(cfg, axis, halo, pad)
    buf = torch.zeros(shape, dtype=x.dtype, device=x.device)
    sl_local, sl_global = _interior_slices(cfg, axis, grid.coords, halo, pad)
    buf[sl_local] = x[sl_global].permute(cfg.mem_order(axis))
    if fill_halos:
        _fill_halos(buf, x, cfg, axis, grid.coords, halo, pad)
    return buf.to(grid.device)


def _fill_halos(buf, x, cfg, axis, coords, halo, pad):
    """Fill the halo regions (corners included) of ``buf`` with periodic
    global data: per tensor dim, the (buffer position, global index) lists
    of the low halo, the interior and the high halo (the dead zone between
    ``valid`` and the max split stays zero), assigned in one gather."""
    order = cfg.mem_order(axis)
    ms = geometry.max_splits(cfg, axis)
    pinfo = geometry.get_pencil_info(cfg, axis, coords, halo, pad)
    pos, idx = [], [None] * 3
    for i in range(3):
        g = order[i]
        h, n, lo = halo[g], cfg.gdims[g], pinfo.lo_g[g]
        valid = pinfo.hi_g[g] - lo + 1
        pos.append(torch.tensor(list(range(0, h + valid))
                                + list(range(h + ms[g], h + ms[g] + h))))
        idx[g] = torch.tensor([(lo - h + k) % n for k in range(h)]
                              + [lo + k for k in range(valid)]
                              + [(lo + valid + k) % n for k in range(h)])
    src = x[idx[0][:, None, None], idx[1][None, :, None], idx[2][None, None]]
    buf[pos[0][:, None, None], pos[1][None, :, None],
        pos[2][None, None]] = src.permute(order)


def _mesh_rank(grid, coords) -> int:
    """Process-group rank of the grid rank at (pr, pc)."""
    names = grid.mesh.mesh_dim_names
    idx = tuple(c for n, c in zip(grid.axis_names, coords) if n in names)
    return int(grid.mesh.mesh[idx])


def gather_global(grid, local: torch.Tensor, axis: int, halo_extents=None,
                  padding=None) -> torch.Tensor:
    """Reassemble every rank's local pencil ``axis`` into the global tensor
    (natural [X, Y, Z] order, shape ``gdims`` plus trailing component
    dims) on the local tensor's device.  Halo and padding regions are
    dropped.  With more than one rank this is a collective over the default
    process group, which the grid's mesh must span."""
    cfg = grid.config
    halo = _check_extents(halo_extents, "halo_extents")
    pad = _check_extents(padding, "padding")
    comp = tuple(local.shape[3:])
    pr_n, pc_n = cfg.pdims
    if grid.mesh is None:
        parts = {(0, 0): local}
    else:
        if dist.get_world_size() != grid.mesh.size():
            raise ValueError("gather_global needs a mesh over the whole "
                             "default process group")
        send = local.contiguous()
        wire = torch.view_as_real(send) if send.is_complex() else send
        bufs = [torch.empty_like(wire) for _ in range(dist.get_world_size())]
        dist.all_gather(bufs, wire)
        if send.is_complex():
            bufs = [torch.view_as_complex(b) for b in bufs]
        parts = {(pr, pc): bufs[_mesh_rank(grid, (pr, pc))]
                 for pr in range(pr_n) for pc in range(pc_n)}
    # local dims are in memory order; inv_mem_order puts them in global order
    perm = cfg.inv_mem_order(axis) + tuple(range(3, 3 + len(comp)))
    out = torch.zeros(cfg.gdims + comp, dtype=local.dtype, device=local.device)
    for coords, data in parts.items():
        sl_local, sl_global = _interior_slices(cfg, axis, coords, halo, pad)
        out[sl_global] = data[sl_local].permute(perm)
    return out


def valid_interior_mask(grid, axis: int, halo_extents=None,
                        padding=None) -> torch.Tensor:
    """Boolean tensor of this rank's local pencil shape on the grid's
    device: True on the valid interior, False on padding and halos."""
    cfg = grid.config
    halo = _check_extents(halo_extents, "halo_extents")
    pad = _check_extents(padding, "padding")
    shape = geometry.pencil_buffer_shape(cfg, axis, halo, pad)
    mask = torch.zeros(shape, dtype=torch.bool, device=grid.device)
    sl_local, _ = _interior_slices(cfg, axis, grid.coords, halo, pad)
    mask[sl_local] = True
    return mask
