"""Grid configuration — the analog of ``cudecompGridDescConfig_t``.

Reference parity: ``include/cudecomp.h:128-238`` defines the config struct
(gdims, gdims_dist, pdims, transpose_comm_backend, transpose_axis_contiguous,
transpose_mem_order, halo_comm_backend).  Here the same information is a
frozen dataclass whose fields and enum values are those of
``cudecomp_tpu.config``, so one spec builds a grid in either package
(:meth:`GridConfig.from_dict`).

Memory-order convention (a C-order/Fortran-order mirror of the reference):

  * Local pencil tensors are C-order (row-major); the LAST dimension is
    contiguous.
  * ``mem_order[i]`` for a pencil gives the *global axis* (0=X, 1=Y, 2=Z)
    stored in tensor dimension ``i``; dimension 2 is contiguous.
  * Natural order is ``(0, 1, 2)`` — tensor indexed ``[x, y, z]``, Z
    contiguous.
  * ``transpose_axis_contiguous[ax] = True`` selects the cyclic order that
    puts the pencil axis contiguous: ``((ax+1)%3, (ax+2)%3, ax)``
    (reference ``docs/basic_usage.rst:143-166``, ``src/cudecomp.cc:1120-1133``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Mapping, Optional, Tuple

Triple = Tuple[int, int, int]


class TransposeMethod(enum.Enum):
    """Exchange strategy for global transposes (``cudecompTransposeCommBackend_t``
    analog, ``include/cudecomp.h:48-59``).  Only ``ALL_TO_ALL`` runs an
    exchange in this package so far; the others are accepted and raise
    ``NotImplementedError`` once an exchange over more than one rank would
    run (``parallel.collectives``)."""

    #: one ``torch.distributed.all_to_all_single`` over the axis group
    ALL_TO_ALL = "all_to_all"
    RING = "ring"
    RING_XOR = "ring_xor"
    RING_PIPELINED = "ring_pipelined"
    RING_HIER = "ring_hier"
    PALLAS_A2A = "pallas_a2a"


class HaloMethod(enum.Enum):
    """Exchange strategy for halo updates (``cudecompHaloCommBackend_t``)."""

    PPERMUTE = "ppermute"
    PALLAS = "pallas"


class RankOrder(enum.Enum):
    """How linear ranks map onto the (pr, pc) process grid
    (``include/internal/common.h:318-346``)."""

    ROW_MAJOR = "row_major"  # rank = pr * Pc + pc   (reference default)
    COL_MAJOR = "col_major"  # rank = pc * Pr + pr


def _as_triple(v, name: str) -> Triple:
    t = tuple(int(x) for x in v)
    if len(t) != 3:
        raise ValueError(f"{name} must have length 3, got {v!r}")
    return t  # type: ignore[return-value]


_VALID_ORDERS = {
    (0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0),
}


def default_mem_order(axis: int, axis_contiguous: bool) -> Triple:
    """Memory order for a pencil: natural or cyclic axis-contiguous
    (``src/cudecomp.cc:1120-1133`` under the C-order convention)."""
    if axis_contiguous:
        return ((axis + 1) % 3, (axis + 2) % 3, axis)
    return (0, 1, 2)


def _enum_value(v):
    """An enum member of either package, or its value, as the plain value."""
    return v.value if isinstance(v, enum.Enum) else v


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Static description of a decomposed 3D grid.

    Attributes:
      gdims: global grid extents (X, Y, Z).
      pdims: process grid (Pr, Pc); ``Pr * Pc`` ranks.  ``(0, 0)`` asks for
        autotuning, which this package cannot do yet (``make_grid`` raises).
      gdims_dist: distribute as if the grid had these (smaller) extents, with
        the excess on the last populated pencil (``include/cudecomp.h:137``).
      transpose_axis_contiguous: per pencil axis, whether transposes produce
        the cyclic axis-contiguous layout.
      transpose_mem_order: explicit per-pencil memory orders; wins over
        ``transpose_axis_contiguous`` (``include/cudecomp.h:145-149``).
      rank_order: mapping of linear ranks to the process grid.
      transpose_method / halo_method: exchange strategies.
    """

    gdims: Triple
    pdims: Tuple[int, int] = (0, 0)
    gdims_dist: Optional[Triple] = None
    transpose_axis_contiguous: Tuple[bool, bool, bool] = (False, False, False)
    transpose_mem_order: Optional[Tuple[Triple, Triple, Triple]] = None
    rank_order: RankOrder = RankOrder.ROW_MAJOR
    transpose_method: TransposeMethod = TransposeMethod.ALL_TO_ALL
    halo_method: HaloMethod = HaloMethod.PPERMUTE

    def __post_init__(self):
        object.__setattr__(self, "gdims", _as_triple(self.gdims, "gdims"))
        pd = tuple(int(x) for x in self.pdims)
        if len(pd) != 2:
            raise ValueError(f"pdims must have length 2, got {self.pdims!r}")
        object.__setattr__(self, "pdims", pd)
        if any(g <= 0 for g in self.gdims):
            raise ValueError(f"gdims must be positive, got {self.gdims}")
        if any(p < 0 for p in pd) or (pd[0] == 0) != (pd[1] == 0):
            raise ValueError(
                f"pdims must both be positive, or both 0 for autotuning; got {pd}")
        if self.gdims_dist is not None:
            gd = _as_triple(self.gdims_dist, "gdims_dist")
            if any(d <= 0 for d in gd):
                raise ValueError(f"gdims_dist must be positive, got {gd}")
            if any(d > g for d, g in zip(gd, self.gdims)):
                raise ValueError(
                    f"gdims_dist entries must be <= gdims entries: {gd} vs {self.gdims}")
            object.__setattr__(self, "gdims_dist", gd)
        ac = tuple(bool(b) for b in self.transpose_axis_contiguous)
        if len(ac) != 3:
            raise ValueError("transpose_axis_contiguous must have length 3")
        object.__setattr__(self, "transpose_axis_contiguous", ac)
        if self.transpose_mem_order is not None:
            mo = tuple(_as_triple(o, "transpose_mem_order[i]")
                       for o in self.transpose_mem_order)
            if len(mo) != 3:
                raise ValueError("transpose_mem_order must give 3 pencil orders")
            for o in mo:
                if o not in _VALID_ORDERS:
                    raise ValueError(f"invalid memory order permutation {o}")
            object.__setattr__(self, "transpose_mem_order", mo)
        object.__setattr__(self, "rank_order",
                           RankOrder(_enum_value(self.rank_order)))
        object.__setattr__(self, "transpose_method",
                           TransposeMethod(_enum_value(self.transpose_method)))
        object.__setattr__(self, "halo_method",
                           HaloMethod(_enum_value(self.halo_method)))

    @classmethod
    def from_dict(cls, spec: Mapping) -> "GridConfig":
        """Build from a field mapping such as ``dataclasses.asdict`` of a
        ``cudecomp_tpu.config.GridConfig``.  Enum fields may be given as
        their values or as members of either package's enums; unknown
        keys raise ``TypeError``."""
        return cls(**{k: _enum_value(v) for k, v in spec.items()})

    # -- derived, all static Python ---------------------------------------------

    @property
    def effective_gdims_dist(self) -> Triple:
        return self.gdims_dist if self.gdims_dist is not None else self.gdims

    def mem_order(self, axis: int) -> Triple:
        """Memory order for pencil ``axis`` (tensor dim -> global axis)."""
        if self.transpose_mem_order is not None:
            return self.transpose_mem_order[axis]
        return default_mem_order(axis, self.transpose_axis_contiguous[axis])

    def inv_mem_order(self, axis: int) -> Triple:
        """Inverse permutation: global axis -> tensor dim."""
        o = self.mem_order(axis)
        inv = [0, 0, 0]
        for i, a in enumerate(o):
            inv[a] = i
        return tuple(inv)  # type: ignore[return-value]

    @property
    def autotune_pdims(self) -> bool:
        return self.pdims == (0, 0)
