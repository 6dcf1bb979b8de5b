"""Pencil geometry — pure, device-free decomposition math.

The reference's splits/pencil-shape formulas, exactly
(``include/internal/common.h:579-589`` getSplits,
``src/cudecomp.cc:1317-1379`` cudecompGetPencilInfoVersioned,
``src/cudecomp.cc:1710-1755`` cudecompGetShiftedRank,
``src/cudecomp.cc:1411-1459`` workspace sizing):

  * splitting N over p chunks gives the first ``N % p`` chunks one extra
    element;
  * with ``gdims_dist`` the grid is distributed as if it had the (smaller)
    ``gdims_dist`` extents and the excess ``gdims - gdims_dist`` is tacked
    onto the *last populated* pencil;
  * X-pencils shard (Y, Z) over (Pr, Pc); Y-pencils shard (X, Z); Z-pencils
    shard (X, Y).

Buffer format: every rank allocates its local pencil at the **padded
pencil** shape — the maximum split along each sharded dim — and ranks that
own fewer elements leave the tail as zeros.  ``PencilInfo`` reports the
per-rank valid region exactly like the reference; ``pencil_buffer_shape``
the uniform local tensor shape.  The uniform shape is what lets one
``all_to_all_single`` move equal blocks, and it matches the per-device
shard of ``cudecomp_tpu`` element for element.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

from cudecomp_tpu_torch.config import GridConfig, RankOrder

Triple = Tuple[int, int, int]


# ---------------------------------------------------------------------------
# splits
# ---------------------------------------------------------------------------

def get_splits(n: int, nchunks: int, excess: int = 0) -> Tuple[int, ...]:
    """Split ``n`` into ``nchunks`` parts, remainder to the lowest chunks;
    ``excess`` goes to the last *populated* chunk (common.h:579-589)."""
    if nchunks <= 0:
        raise ValueError(f"nchunks must be positive, got {nchunks}")
    if excess and n <= 0:
        raise ValueError(f"excess={excess} requires n > 0, got n={n}")
    base, rem = divmod(n, nchunks)
    splits = [base + (1 if i < rem else 0) for i in range(nchunks)]
    if excess:
        splits[min(n, nchunks) - 1] += excess
    return tuple(splits)


def get_split_offsets(n: int, nchunks: int) -> Tuple[int, ...]:
    """Global start offset of each chunk, ``pidx*d + min(pidx, mod)``
    (``src/cudecomp.cc:1358``); the excess never shifts offsets."""
    base, rem = divmod(n, nchunks)
    return tuple(i * base + min(i, rem) for i in range(nchunks))


def _dist_splits(cfg: GridConfig, gdim_idx: int, nchunks: int) -> Tuple[int, ...]:
    """Splits of global dim ``gdim_idx`` honoring the gdims_dist excess."""
    nd = cfg.effective_gdims_dist[gdim_idx]
    excess = cfg.gdims[gdim_idx] - nd
    return get_splits(nd, nchunks, excess)


def pencil_shard_dims(axis: int) -> Tuple[int, int]:
    """The two global dims sharded for pencil ``axis``, in (pr, pc) order."""
    others = [d for d in range(3) if d != axis]
    return (others[0], others[1])


def shard_pdim_of_dim(axis: int, dim: int) -> Optional[int]:
    """Which process-grid dim (0=pr, 1=pc) shards global dim ``dim`` for
    pencil ``axis``; None when ``dim == axis`` (src/cudecomp.cc:1734-1742)."""
    if dim == axis:
        return None
    a, _ = pencil_shard_dims(axis)
    return 0 if dim == a else 1


# ---------------------------------------------------------------------------
# PencilInfo
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PencilInfo:
    """Per-rank pencil description (``cudecompPencilInfo_t``,
    ``include/cudecomp.h:103-116``).

    ``shape``, ``lo``, ``hi`` are in **memory order** (tensor dims, last
    contiguous); ``halo_extents`` and ``padding`` are indexed by global
    axis.  ``shape`` includes ``2*halo + padding`` per dim while
    ``lo``/``hi`` are the interior global bounds (``hi`` inclusive).
    """

    axis: int
    order: Triple                 # tensor dim i holds global axis order[i]
    shape: Triple                 # per-rank shape incl. halos+padding (mem order)
    lo: Triple                    # interior global start (mem order)
    hi: Triple                    # interior global end, inclusive (mem order)
    halo_extents: Triple          # by global axis
    padding: Triple               # by global axis
    size: int                     # product(shape)

    @property
    def interior_shape(self) -> Triple:
        return tuple(h - l + 1 for l, h in zip(self.lo, self.hi))  # type: ignore

    def _by_global(self, v) -> Triple:
        out = [0, 0, 0]
        for i, a in enumerate(self.order):
            out[a] = v[i]
        return tuple(out)  # type: ignore[return-value]

    @property
    def shape_g(self) -> Triple:
        """``shape`` indexed by global axis (getShapeG, common.h:375-381)."""
        return self._by_global(self.shape)

    @property
    def lo_g(self) -> Triple:
        return self._by_global(self.lo)

    @property
    def hi_g(self) -> Triple:
        return self._by_global(self.hi)


def _check_extents(v, name: str) -> Triple:
    if v is None:
        return (0, 0, 0)
    t = tuple(int(x) for x in v)
    if len(t) != 3 or any(x < 0 for x in t):
        raise ValueError(f"{name} must be 3 nonnegative ints, got {v!r}")
    return t  # type: ignore[return-value]


def coords_of_rank(cfg: GridConfig, rank: int) -> Tuple[int, int]:
    """Process-grid coords (pr, pc) of a linear rank under the rank order."""
    pr_n, pc_n = cfg.pdims
    if not 0 <= rank < pr_n * pc_n:
        raise ValueError(f"rank {rank} out of range for pdims {cfg.pdims}")
    if cfg.rank_order == RankOrder.ROW_MAJOR:
        return rank // pc_n, rank % pc_n
    return rank % pr_n, rank // pr_n


def rank_of_coords(cfg: GridConfig, pr: int, pc: int) -> int:
    pr_n, pc_n = cfg.pdims
    if cfg.rank_order == RankOrder.ROW_MAJOR:
        return pr * pc_n + pc
    return pc * pr_n + pr


def get_pencil_info(
    cfg: GridConfig,
    axis: int,
    coords: Tuple[int, int],
    halo_extents: Optional[Sequence[int]] = None,
    padding: Optional[Sequence[int]] = None,
) -> PencilInfo:
    """Per-rank pencil info (``src/cudecomp.cc:1317-1379``)."""
    if axis not in (0, 1, 2):
        raise ValueError(f"axis out of range: {axis}")
    if cfg.autotune_pdims:
        raise ValueError("pdims not set (autotune pending); cannot query pencils")
    if not (0 <= coords[0] < cfg.pdims[0] and 0 <= coords[1] < cfg.pdims[1]):
        raise ValueError(f"coords {tuple(coords)} out of range for pdims {cfg.pdims}")
    halo = _check_extents(halo_extents, "halo_extents")
    pad = _check_extents(padding, "padding")

    order = cfg.mem_order(axis)
    inv = cfg.inv_mem_order(axis)

    shape = [0, 0, 0]
    lo = [0, 0, 0]
    hi = [0, 0, 0]
    size = 1
    j = 0
    for i in range(3):  # i = global axis
        ord_i = inv[i]  # tensor dim holding global axis i
        if i != axis:
            pidx = coords[j]
            nd = cfg.effective_gdims_dist[i]
            d, mod = divmod(nd, cfg.pdims[j])
            s = d + (1 if pidx < mod else 0)
            if pidx == min(cfg.pdims[j], nd) - 1:
                s += cfg.gdims[i] - nd
            shape[ord_i] = s
            lo[ord_i] = pidx * d + min(pidx, mod)
            j += 1
        else:
            shape[ord_i] = cfg.gdims[i]
            lo[ord_i] = 0
        hi[ord_i] = lo[ord_i] + shape[ord_i] - 1
        shape[ord_i] += 2 * halo[i] + pad[i]
        size *= shape[ord_i]

    return PencilInfo(
        axis=axis,
        order=order,
        shape=tuple(shape),  # type: ignore[arg-type]
        lo=tuple(lo),        # type: ignore[arg-type]
        hi=tuple(hi),        # type: ignore[arg-type]
        halo_extents=halo,
        padding=pad,
        size=size,
    )


def max_splits(cfg: GridConfig, axis: int) -> Triple:
    """Max (uniform) interior extents per global axis for a pencil: the
    maximum split on the sharded dims, the full extent on the pencil axis
    (per-dim ``getGlobalMaxPencilSize``, common.h:349-366)."""
    out = [0, 0, 0]
    j = 0
    for i in range(3):
        if i != axis:
            out[i] = max(_dist_splits(cfg, i, cfg.pdims[j]))
            j += 1
        else:
            out[i] = cfg.gdims[i]
    return tuple(out)  # type: ignore[return-value]


def pencil_buffer_shape(
    cfg: GridConfig,
    axis: int,
    halo_extents: Optional[Sequence[int]] = None,
    padding: Optional[Sequence[int]] = None,
) -> Triple:
    """Uniform local tensor shape of pencil ``axis`` in memory order."""
    halo = _check_extents(halo_extents, "halo_extents")
    pad = _check_extents(padding, "padding")
    ms = max_splits(cfg, axis)
    order = cfg.mem_order(axis)
    return tuple(ms[order[i]] + 2 * halo[order[i]] + pad[order[i]]
                 for i in range(3))  # type: ignore[return-value]


def global_buffer_shape(
    cfg: GridConfig,
    axis: int,
    halo_extents: Optional[Sequence[int]] = None,
    padding: Optional[Sequence[int]] = None,
) -> Triple:
    """Shape of all ranks' local tensors laid side by side (memory order):
    the local shape times the number of ranks along each sharded dim."""
    local = pencil_buffer_shape(cfg, axis, halo_extents, padding)
    order = cfg.mem_order(axis)
    out = []
    for i in range(3):
        pd = shard_pdim_of_dim(axis, order[i])
        out.append(local[i] * (cfg.pdims[pd] if pd is not None else 1))
    return tuple(out)  # type: ignore[return-value]


def global_max_pencil_size(cfg: GridConfig, axis: int) -> int:
    """Max pencil size across ranks in elements, without halos
    (``getGlobalMaxPencilSize``, common.h:349-366)."""
    ms = max_splits(cfg, axis)
    return ms[0] * ms[1] * ms[2]


_WORKSPACE_ALIGN_BYTES = 256


def _align_count(count: int, elem_bytes: int = 4) -> int:
    """Round an element count up to a 256-byte boundary for the given
    element width (``alignCountToBytes``, src/cudecomp.cc:1421-1427)."""
    per = max(_WORKSPACE_ALIGN_BYTES // elem_bytes, 1)
    return (count + per - 1) // per * per


def transpose_workspace_size(cfg: GridConfig, elem_bytes: int = 4) -> int:
    """Element count ``cudecompGetTransposeWorkspaceSize`` would allocate
    (``src/cudecomp.cc:1411-1432``), for parity and memory estimates."""
    mx = global_max_pencil_size(cfg, 0)
    my = global_max_pencil_size(cfg, 1)
    mz = global_max_pencil_size(cfg, 2)
    w_xy = _align_count(mx, elem_bytes) + my
    w_yx = _align_count(my, elem_bytes) + mx
    w_yz = _align_count(my, elem_bytes) + mz
    w_zy = _align_count(mz, elem_bytes) + my
    return max(w_xy, w_yx, w_yz, w_zy)


def halo_workspace_size(
    cfg: GridConfig, axis: int, halo_extents: Sequence[int],
    coords: Tuple[int, int] = (0, 0), elem_bytes: int = 4,
) -> int:
    """``cudecompGetHaloWorkspaceSize`` (``src/cudecomp.cc:1434-1459``): 4
    aligned slots of the largest halo slab for the rank at ``coords``."""
    pinfo = get_pencil_info(cfg, axis, coords, halo_extents=halo_extents)
    sg = pinfo.shape_g
    he = pinfo.halo_extents
    sizes = [
        4 * _align_count(sg[1] * sg[2] * he[0], elem_bytes),
        4 * _align_count(sg[0] * sg[2] * he[1], elem_bytes),
        4 * _align_count(sg[0] * sg[1] * he[2], elem_bytes),
    ]
    return max(sizes)


# ---------------------------------------------------------------------------
# neighbors
# ---------------------------------------------------------------------------

def get_shifted_rank(
    cfg: GridConfig,
    axis: int,
    dim: int,
    displacement: int,
    periodic: bool,
    rank: int,
) -> int:
    """Rank of the neighbor ``displacement`` away along global dim ``dim``
    for pencil ``axis``; -1 if out of domain and not periodic
    (``src/cudecomp.cc:1710-1755``)."""
    if axis not in (0, 1, 2):
        raise ValueError(f"axis out of range: {axis}")
    if dim not in (0, 1, 2):
        raise ValueError(f"dim out of range: {dim}")
    if displacement == 0:
        return rank
    if dim == axis:
        return rank if periodic else -1
    pd = shard_pdim_of_dim(axis, dim)
    coords = list(coords_of_rank(cfg, rank))
    shifted = coords[pd] + displacement
    n = cfg.pdims[pd]
    if not periodic and (shifted < 0 or shifted >= n):
        return -1
    coords[pd] = shifted % n
    return rank_of_coords(cfg, coords[0], coords[1])


# ---------------------------------------------------------------------------
# process-grid factorizations (autotune candidates)
# ---------------------------------------------------------------------------

def squarest_pdims(nranks: int) -> Tuple[int, int]:
    """The squarest factor pair (pr, pc) of ``nranks``."""
    pr = math.isqrt(nranks)
    while nranks % pr:
        pr -= 1
    return pr, nranks // pr


def pdim_candidates(nranks: int) -> Tuple[Tuple[int, int], ...]:
    """All (Pr, Pc) factor pairs of ``nranks``, from slab (1, N) to (N, 1)
    (``src/autotune.cc:82-106``)."""
    return tuple((pr, nranks // pr) for pr in range(1, nranks + 1)
                 if nranks % pr == 0)
