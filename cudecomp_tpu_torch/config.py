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
from typing import Mapping, Optional, Sequence, Tuple

Triple = Tuple[int, int, int]


class TransposeMethod(enum.Enum):
    """Exchange strategy for global transposes (``cudecompTransposeCommBackend_t``
    analog, ``include/cudecomp.h:48-59``; ``parallel.collectives``)."""

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


class CannotRun(ValueError):
    """A transpose or halo method refusing the grid and tensors it was
    given, on every rank alike and before any exchange: a CUDA tensor over
    a gloo group, a halo wider than a rank's pencil, a kernel workspace
    over more ranks than it serves.  The autotuner records such a
    candidate as skipped with its error; any other error stops the
    sweep."""


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
      pdims: process grid (Pr, Pc); ``Pr * Pc`` ranks.  ``(0, 0)`` asks
        ``make_grid`` to autotune it.
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

    def with_pdims(self, pdims: Sequence[int]) -> "GridConfig":
        return dataclasses.replace(self, pdims=tuple(int(p) for p in pdims))

    @property
    def autotune_pdims(self) -> bool:
        return self.pdims == (0, 0)


@dataclasses.dataclass(frozen=True)
class AutotuneOptions:
    """Autotuner knobs (``cudecompGridDescAutotuneOptions_t``,
    ``include/cudecomp.h:186-238``): the fields and defaults of
    ``cudecomp_tpu.config.AutotuneOptions``.

    Attributes:
      n_warmup / n_trials: per-candidate timing protocol
        (``src/autotune.cc:541-626``: 3 warm-up calls and 5 trials).
      transpose_op_weights: weights of (XToY, YToZ, ZToY, YToX) in the
        score (``autotune.cc:631-680``).  Uniform weights time the chained
        round trip; weights uniform within each pair (w0 == w1, w2 == w3)
        time the pairs X2Y;Y2Z and Z2Y;Y2X; other weights time each op of
        nonzero weight on its own and score ``sum(w_i * t_i)``.
      autotune_transpose_method / autotune_halo_method: sweep the exchange
        strategy as well as pdims.
      skip_threshold: drop a candidate whose probe (one warm-up call and
        one trial) exceeds ``skip_threshold * best_time`` before its full
        protocol (``autotune.cc:578-602``); 0 probes nothing.
      methods / halo_methods: explicit candidate strategies (None: every
        one that can run on the grid's device and process group).
      pr_range / pc_range: inclusive clamps on the process-grid factors
        (``CUDECOMP_AUTOTUNE_P_{ROW,COL}_RANGE``).
      dtype: trial tensor dtype, a ``torch.dtype`` (None: float32; pass
        the production dtype to tune with its payloads,
        ``autotune.cc:377-483``).
      n_components: trailing component dims of size 2 appended to trial
        tensors (1 = a split-complex payload).
      autotune_layouts: also sweep the pencil layout (natural and
        axis-contiguous), as the reference's benchmark sweeps
        ``transpose_axis_contiguous``.
      halo_extents / halo_periods / halo_axis / halo_padding: the halo
        trials' update (``cudecomp.h:218``).
      grid_mode: "transpose" (default) chooses the process grid by
        transpose round trips, "halo" by halo updates on ``halo_axis``
        pencils (``cudecomp.h:172``, ``src/cudecomp.cc:1200-1211``).
      allow_uneven_decompositions: when False, skip process grids that
        split a pencil axis unevenly (``cudecomp.h:175``).
      transpose_input_halo_extents / ..._output_halo_extents /
        ..._input_padding / ..._output_padding: per-op trial payloads, 4
        triples (X2Y, Y2Z, Z2Y, Y2X) (``cudecomp.h:195-208``).
    """

    n_warmup: int = 3
    n_trials: int = 5
    transpose_op_weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    autotune_transpose_method: bool = True
    autotune_halo_method: bool = False
    dtype: Optional[object] = None
    n_components: int = 0
    autotune_layouts: bool = False
    skip_threshold: float = 0.0
    methods: Optional[Tuple[TransposeMethod, ...]] = None
    halo_methods: Optional[Tuple[HaloMethod, ...]] = None
    pr_range: Optional[Tuple[int, int]] = None
    pc_range: Optional[Tuple[int, int]] = None
    halo_extents: Triple = (0, 0, 0)
    halo_periods: Tuple[bool, bool, bool] = (True, True, True)
    halo_axis: int = 0
    halo_padding: Triple = (0, 0, 0)
    grid_mode: str = "transpose"
    allow_uneven_decompositions: bool = True
    transpose_input_halo_extents: Optional[Tuple[Triple, ...]] = None
    transpose_output_halo_extents: Optional[Tuple[Triple, ...]] = None
    transpose_input_padding: Optional[Tuple[Triple, ...]] = None
    transpose_output_padding: Optional[Tuple[Triple, ...]] = None

    def __post_init__(self):
        if self.grid_mode not in ("transpose", "halo"):
            raise ValueError(
                f"grid_mode must be 'transpose' or 'halo', got "
                f"{self.grid_mode!r}")
        if len(self.transpose_op_weights) != 4:
            # here, not in the sweep, where the candidate-skip would turn
            # it into a misleading 'every candidate failed'
            raise ValueError(
                f"transpose_op_weights must give 4 weights (X2Y, Y2Z, "
                f"Z2Y, Y2X), got {self.transpose_op_weights!r}")
        object.__setattr__(self, "halo_extents",
                           _as_triple(self.halo_extents, "halo_extents"))
        object.__setattr__(self, "halo_padding",
                           _as_triple(self.halo_padding, "halo_padding"))
        if len(self.halo_periods) != 3:
            raise ValueError(
                f"halo_periods must have length 3, got "
                f"{self.halo_periods!r}")
        for name in ("transpose_input_halo_extents",
                     "transpose_output_halo_extents",
                     "transpose_input_padding", "transpose_output_padding"):
            val = getattr(self, name)
            if val is None:
                continue
            try:
                n = len(val)
            except TypeError:
                n = -1
            if n != 4:
                raise ValueError(
                    f"{name} must give 4 per-op triples (X2Y, Y2Z, Z2Y, "
                    f"Y2X), got {val!r}")
            val = tuple(_as_triple(v, f"{name}[i]") for v in val)
            object.__setattr__(self, name, val)
