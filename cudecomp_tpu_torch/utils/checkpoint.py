"""Checkpoint and restore of distributed pencil fields
(``cudecomp_tpu.utils.checkpoint``), in the JAX package's on-disk format.

A checkpoint is a directory: one ``shard_{pr}_{pc}.npy`` per process-grid
coordinate holding that rank's valid interior in natural global-axis order
(halos, padding and the pad-to-max tails stripped; trailing component
dims kept), plus ``meta.json`` (gdims, axis, pdims, gdims_dist,
halo_extents, padding, dtype), written last as the commit record.  Either
package reads what the other wrote, onto any pdims and layout: each rank
assembles its block from the saved shards that overlap it, memory-mapped.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from cudecomp_tpu_torch import geometry
from cudecomp_tpu_torch.config import GridConfig
from cudecomp_tpu_torch.geometry import _check_extents
from cudecomp_tpu_torch.parallel.collectives import all_reduce_grid


def _grid_barrier(grid) -> None:
    """Wait for every rank of ``grid`` (a sum over the grid's mesh dims)."""
    if grid.mesh is not None:
        all_reduce_grid(torch.zeros(1, device=grid.device), grid)


def save_pencil(path: str, grid, local: torch.Tensor, axis: int,
                halo_extents=None, padding=None) -> None:
    """Persist this rank's pencil ``axis`` tensor ``local`` into the
    checkpoint directory ``path``.  Every rank of the grid must call; the
    rank at coords (0, 0) writes ``meta.json`` once every shard is on
    disk."""
    cfg = grid.config
    halo = _check_extents(halo_extents, "halo_extents")
    pad = _check_extents(padding, "padding")
    order = cfg.mem_order(axis)
    expected = geometry.pencil_buffer_shape(cfg, axis, halo, pad)
    if tuple(local.shape[:3]) != tuple(expected):
        raise ValueError(f"save_pencil: tensor shape {tuple(local.shape)} "
                         f"does not match pencil {axis}'s layout {expected}")
    os.makedirs(path, exist_ok=True)
    pr, pc = grid.coords
    pinfo = geometry.get_pencil_info(cfg, axis, (pr, pc), halo, pad)
    data = local.detach().cpu().numpy()
    sl = []
    for i in range(3):
        g = order[i]
        valid = pinfo.hi_g[g] - pinfo.lo_g[g] + 1
        sl.append(slice(halo[g], halo[g] + valid))
    interior = data[tuple(sl) + (Ellipsis,)]
    perm = [order.index(g) for g in range(3)] + list(range(3, interior.ndim))
    np.save(os.path.join(path, f"shard_{pr}_{pc}.npy"),
            np.transpose(interior, axes=perm))

    _grid_barrier(grid)  # every shard exists before meta.json
    if (pr, pc) == (0, 0):
        meta = {
            "gdims": list(cfg.gdims),
            "axis": axis,
            "pdims": list(cfg.pdims),
            "gdims_dist": (list(cfg.gdims_dist)
                           if cfg.gdims_dist is not None else None),
            "halo_extents": list(halo),
            "padding": list(pad),
            "dtype": str(data.dtype),
        }
        tmp = os.path.join(path, "meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2)
        os.replace(tmp, os.path.join(path, "meta.json"))
    _grid_barrier(grid)  # meta.json exists when any rank returns


class _ShardReader:
    """Assembles global index selections from saved shard files
    (memory-mapped: only the requested regions are read)."""

    def __init__(self, path: str, meta: dict):
        self.path = path
        self.cfg = GridConfig(gdims=tuple(meta["gdims"]),
                              pdims=tuple(meta["pdims"]),
                              gdims_dist=(tuple(meta["gdims_dist"])
                                          if meta.get("gdims_dist") else None))
        self.axis = meta["axis"]
        self._files = {}

    def _block(self, pr, pc):
        key = (pr, pc)
        if key not in self._files:
            f = os.path.join(self.path, f"shard_{pr}_{pc}.npy")
            self._files[key] = np.load(f, mmap_mode="r")
        return self._files[key]

    @property
    def comp_shape(self):
        """Trailing component dims of the saved field."""
        return self._block(0, 0).shape[3:]

    def gather(self, idx_lists, comp_shape, dtype):
        """Global-order block for per-dim integer index lists."""
        out = np.zeros(tuple(len(ix) for ix in idx_lists) + tuple(comp_shape),
                       dtype=dtype)
        idx_arrays = [np.asarray(ix) for ix in idx_lists]
        for pr in range(self.cfg.pdims[0]):
            for pc in range(self.cfg.pdims[1]):
                pinfo = geometry.get_pencil_info(self.cfg, self.axis,
                                                 (pr, pc))
                sels, srcs = [], []
                for d in range(3):
                    lo, hi = pinfo.lo_g[d], pinfo.hi_g[d]
                    sel = np.nonzero((idx_arrays[d] >= lo)
                                     & (idx_arrays[d] <= hi))[0]
                    if sel.size == 0:
                        break
                    sels.append(sel)
                    srcs.append(idx_arrays[d][sel] - lo)
                else:
                    out[np.ix_(*sels)] = self._block(pr, pc)[np.ix_(*srcs)]
        return out


def load_pencil(path: str, grid, axis: int = None, halo_extents=None,
                padding=None, fill_halos: bool = False) -> torch.Tensor:
    """This rank's pencil tensor of the checkpoint at ``path``, on the
    grid's device.  The grid may have other pdims and layouts than the one
    that saved it; ``axis``, ``halo_extents`` and ``padding`` default to
    the saved ones.  With ``fill_halos=True`` the halo regions hold the
    (periodic) global data."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    cfg = grid.config
    if tuple(meta["gdims"]) != cfg.gdims:
        raise ValueError(f"checkpoint gdims {meta['gdims']} != grid gdims "
                         f"{cfg.gdims}")
    axis = meta["axis"] if axis is None else axis
    halo = _check_extents(halo_extents if halo_extents is not None
                          else meta["halo_extents"], "halo_extents")
    pad = _check_extents(padding if padding is not None
                         else meta["padding"], "padding")
    dtype = np.dtype(meta["dtype"])
    order = cfg.mem_order(axis)
    ms = geometry.max_splits(cfg, axis)
    local_shape = geometry.pencil_buffer_shape(cfg, axis, halo, pad)
    reader = _ShardReader(path, meta)
    comp_shape = reader.comp_shape

    pinfo = geometry.get_pencil_info(cfg, axis, grid.coords, halo, pad)
    buf = np.zeros(tuple(local_shape) + comp_shape, dtype=dtype)
    pos_lists, idx_lists = [], []
    for g in range(3):  # global-axis order
        h, n, lo = halo[g], cfg.gdims[g], pinfo.lo_g[g]
        valid = pinfo.hi_g[g] - lo + 1
        if fill_halos and h > 0:
            pos = (list(range(0, h + valid))
                   + list(range(h + ms[g], h + ms[g] + h)))
            idx = ([(lo - h + k) % n for k in range(h)]
                   + [lo + k for k in range(valid)]
                   + [(lo + valid + k) % n for k in range(h)])
        else:
            pos = list(range(h, h + valid))
            idx = list(range(lo, lo + valid))
        pos_lists.append(pos)
        idx_lists.append(idx)
    src = reader.gather(idx_lists, comp_shape, dtype)        # global order
    src = np.transpose(src, axes=list(order)
                       + list(range(3, 3 + len(comp_shape))))  # memory order
    buf[np.ix_(*[pos_lists[g] for g in order])] = src
    return torch.from_numpy(buf).to(grid.device)
