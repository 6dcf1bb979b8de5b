"""cuDecomp-named compatibility layer: every public reference entry point
under its original name (``cudecomp_tpu.compat``).

The native API (``cudecomp_tpu_torch/__init__.py``) is the recommended
surface; this module lets an application written against the reference C
API (``include/cudecomp.h``, the ``cudecomp*`` entry points of
cudecomp.h:249-715) port call for call: the same names, the same argument
order and the same struct field names, with C error codes replaced by
Python exceptions and the GPU-specific arguments (streams, workspaces,
dtype tags on buffers) accepted and ignored, as each function documents.

Mapping rules:

* A handle carries the device that ``cudecompInit`` resolved (``"cuda"``
  unless the caller asks for another); process groups are the caller's
  (``torch.distributed.init_process_group``), as the reference's MPI
  communicator is.  Grid descriptors are native :class:`GridDescriptor`
  objects.
* Config and options "structs" are mutable dataclasses with the
  reference's field names (``cudecomp.h:128-238``), translated to the
  native frozen dataclasses at ``cudecompGridDescCreate``.
* Communication backends map by algorithmic role onto the port's
  strategies:

  ====================================  ==================================
  reference backend                     port strategy
  ====================================  ==================================
  CUDECOMP_TRANSPOSE_COMM_MPI_A2A       ALL_TO_ALL (NCCL or gloo)
  CUDECOMP_TRANSPOSE_COMM_MPI_P2P       RING (NCCL or gloo point-to-point)
  CUDECOMP_TRANSPOSE_COMM_MPI_P2P_PL    RING_PIPELINED
  CUDECOMP_TRANSPOSE_COMM_NCCL          RING_XOR
  CUDECOMP_TRANSPOSE_COMM_NCCL_PL       RING_PIPELINED
  CUDECOMP_TRANSPOSE_COMM_NVSHMEM       PALLAS_A2A (K2 on symmetric memory)
  CUDECOMP_TRANSPOSE_COMM_NVSHMEM_PL    PALLAS_A2A
  CUDECOMP_TRANSPOSE_COMM_NVSHMEM_SM    PALLAS_A2A
  CUDECOMP_HALO_COMM_MPI[_BLOCKING]     HaloMethod.PPERMUTE
  CUDECOMP_HALO_COMM_NCCL               HaloMethod.PPERMUTE
  CUDECOMP_HALO_COMM_NVSHMEM[_BLOCKING] HaloMethod.PALLAS (K3)
  ====================================  ==================================

* Transposes return the new tensor (``output``, ``work`` and ``stream``
  are accepted for source compatibility and ignored); the halo entries
  update the input in place and return it.
* ``cudecompMalloc``/``cudecompFree`` are documented no-ops (PyTorch's
  caching allocator owns buffers); the workspace-size queries return the
  reference's element counts (src/cudecomp.cc:1411-1459 formulas).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from cudecomp_tpu_torch import geometry, grid as _grid
from cudecomp_tpu_torch.config import (AutotuneOptions, GridConfig,
                                       HaloMethod, RankOrder,
                                       TransposeMethod)
from cudecomp_tpu_torch.ops import halo as _halo
from cudecomp_tpu_torch.ops import transpose as _transpose

# -- enums (cudecomp.h:44-96) -------------------------------------------------

CUDECOMP_RESULT_SUCCESS = 0  # informational; failures raise exceptions

CUDECOMP_TRANSPOSE_COMM_MPI_P2P = 1
CUDECOMP_TRANSPOSE_COMM_MPI_P2P_PL = 2
CUDECOMP_TRANSPOSE_COMM_MPI_A2A = 3
CUDECOMP_TRANSPOSE_COMM_NCCL = 4
CUDECOMP_TRANSPOSE_COMM_NCCL_PL = 5
CUDECOMP_TRANSPOSE_COMM_NVSHMEM = 6
CUDECOMP_TRANSPOSE_COMM_NVSHMEM_PL = 7
CUDECOMP_TRANSPOSE_COMM_NVSHMEM_SM = 8

CUDECOMP_HALO_COMM_MPI = 1
CUDECOMP_HALO_COMM_MPI_BLOCKING = 2
CUDECOMP_HALO_COMM_NCCL = 3
CUDECOMP_HALO_COMM_NVSHMEM = 4
CUDECOMP_HALO_COMM_NVSHMEM_BLOCKING = 5

CUDECOMP_FLOAT = -1
CUDECOMP_DOUBLE = -2
CUDECOMP_FLOAT_COMPLEX = -3
CUDECOMP_DOUBLE_COMPLEX = -4

CUDECOMP_AUTOTUNE_GRID_TRANSPOSE = 0
CUDECOMP_AUTOTUNE_GRID_HALO = 1

CUDECOMP_RANK_ORDER_DEFAULT = 0
CUDECOMP_RANK_ORDER_ROW_MAJOR = 1
CUDECOMP_RANK_ORDER_COL_MAJOR = 2

_TRANSPOSE_BACKEND_MAP = {
    CUDECOMP_TRANSPOSE_COMM_MPI_P2P: TransposeMethod.RING,
    CUDECOMP_TRANSPOSE_COMM_MPI_P2P_PL: TransposeMethod.RING_PIPELINED,
    CUDECOMP_TRANSPOSE_COMM_MPI_A2A: TransposeMethod.ALL_TO_ALL,
    CUDECOMP_TRANSPOSE_COMM_NCCL: TransposeMethod.RING_XOR,
    CUDECOMP_TRANSPOSE_COMM_NCCL_PL: TransposeMethod.RING_PIPELINED,
    CUDECOMP_TRANSPOSE_COMM_NVSHMEM: TransposeMethod.PALLAS_A2A,
    CUDECOMP_TRANSPOSE_COMM_NVSHMEM_PL: TransposeMethod.PALLAS_A2A,
    CUDECOMP_TRANSPOSE_COMM_NVSHMEM_SM: TransposeMethod.PALLAS_A2A,
}
_HALO_BACKEND_MAP = {
    CUDECOMP_HALO_COMM_MPI: HaloMethod.PPERMUTE,
    CUDECOMP_HALO_COMM_MPI_BLOCKING: HaloMethod.PPERMUTE,
    CUDECOMP_HALO_COMM_NCCL: HaloMethod.PPERMUTE,
    CUDECOMP_HALO_COMM_NVSHMEM: HaloMethod.PALLAS,
    CUDECOMP_HALO_COMM_NVSHMEM_BLOCKING: HaloMethod.PALLAS,
}
_DTYPE_MAP = {
    CUDECOMP_FLOAT: torch.float32,
    CUDECOMP_DOUBLE: torch.float64,
    CUDECOMP_FLOAT_COMPLEX: torch.complex64,
    CUDECOMP_DOUBLE_COMPLEX: torch.complex128,
}
# candidate strategies contributed by each vendor family when its
# disable_* flag is off (the autotune.cc:108-144 candidate filter)
_FAMILY_METHODS = {
    "mpi": (TransposeMethod.ALL_TO_ALL, TransposeMethod.RING,
            TransposeMethod.RING_PIPELINED),
    "nccl": (TransposeMethod.RING_XOR, TransposeMethod.RING_HIER,
             TransposeMethod.RING_PIPELINED),
    "nvshmem": (TransposeMethod.PALLAS_A2A,),
}
_FAMILY_HALO_METHODS = {
    "mpi": (HaloMethod.PPERMUTE,),
    "nccl": (HaloMethod.PPERMUTE,),
    "nvshmem": (HaloMethod.PALLAS,),
}


@dataclasses.dataclass
class cudecompHandle_t:
    """Handle (cudecomp.h:101): the device ``cudecompInit`` resolved."""

    device: torch.device = None


# -- "structs" (mutable, reference field names) --------------------------------

_ZERO3 = (0, 0, 0)
_ZERO43 = ((0, 0, 0),) * 4


@dataclasses.dataclass
class cudecompGridDescConfig_t:
    """Mutable mirror of the reference config struct (cudecomp.h:128-156);
    set fields, then pass to :func:`cudecompGridDescCreate`."""

    gdims: Sequence[int] = _ZERO3
    gdims_dist: Sequence[int] = _ZERO3
    pdims: Sequence[int] = (0, 0)
    rank_order: int = CUDECOMP_RANK_ORDER_DEFAULT
    transpose_comm_backend: int = CUDECOMP_TRANSPOSE_COMM_MPI_P2P
    transpose_axis_contiguous: Sequence[bool] = (False, False, False)
    transpose_mem_order: Optional[Sequence[Sequence[int]]] = None
    halo_comm_backend: int = CUDECOMP_HALO_COMM_MPI


@dataclasses.dataclass
class cudecompGridDescAutotuneOptions_t:
    """Mutable mirror of the autotune options struct (cudecomp.h:161-238)."""

    n_warmup_trials: int = 3
    n_trials: int = 5
    grid_mode: int = CUDECOMP_AUTOTUNE_GRID_TRANSPOSE
    #: reference default is CUDECOMP_DOUBLE; None keeps the library's
    #: trial-dtype default (float32), as the JAX package does
    dtype: Optional[int] = None
    allow_uneven_decompositions: bool = True
    disable_mpi_backends: bool = False
    disable_nccl_backends: bool = False
    disable_nvshmem_backends: bool = False
    skip_threshold: float = 0.0
    autotune_transpose_backend: bool = False
    #: accepted for source compatibility, ignored: the trials allocate
    #: their own tensors (there is no user workspace to alias)
    transpose_use_inplace_buffers: Sequence[bool] = (False,) * 4
    transpose_op_weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0)
    transpose_input_halo_extents: Sequence[Sequence[int]] = _ZERO43
    transpose_output_halo_extents: Sequence[Sequence[int]] = _ZERO43
    transpose_input_padding: Sequence[Sequence[int]] = _ZERO43
    transpose_output_padding: Sequence[Sequence[int]] = _ZERO43
    autotune_halo_backend: bool = False
    halo_extents: Sequence[int] = _ZERO3
    halo_periods: Sequence[bool] = (False, False, False)
    halo_axis: int = 0
    halo_padding: Sequence[int] = _ZERO3


# -- lifecycle (cudecomp.h:249-313) --------------------------------------------

def cudecompInit(mpi_comm=None, device="cuda") -> cudecompHandle_t:
    """``cudecompInit`` (cudecomp.h:249).  Returns a handle carrying
    ``grid.init(device)``'s device (CUDA unless asked otherwise; a CUDA
    device without CUDA raises).  ``mpi_comm`` is accepted and ignored:
    the caller's ``torch.distributed`` process group plays its role."""
    return cudecompHandle_t(device=_grid.init(device))


def cudecompFinalize(handle: cudecompHandle_t) -> None:
    """``cudecompFinalize`` (cudecomp.h:268): drops cached plans."""
    _grid.finalize()


def cudecompGridDescConfigSetDefaults() -> cudecompGridDescConfig_t:
    """``cudecompGridDescConfigSetDefaults`` (cudecomp.h:330): returns the
    defaulted struct instead of filling one by pointer."""
    return cudecompGridDescConfig_t()


def cudecompGridDescAutotuneOptionsSetDefaults() -> (
        cudecompGridDescAutotuneOptions_t):
    """``cudecompGridDescAutotuneOptionsSetDefaults`` (cudecomp.h:350)."""
    return cudecompGridDescAutotuneOptions_t()


def _native_config(config: cudecompGridDescConfig_t) -> GridConfig:
    gdims = tuple(int(v) for v in config.gdims)
    if not all(g > 0 for g in gdims):
        raise ValueError(f"config.gdims must be set positive; got {gdims}")
    gdist = tuple(int(v) for v in config.gdims_dist)
    rank_order = (RankOrder.COL_MAJOR
                  if config.rank_order == CUDECOMP_RANK_ORDER_COL_MAJOR
                  else RankOrder.ROW_MAJOR)
    mem_order = config.transpose_mem_order
    if mem_order is not None:
        mem_order = tuple(tuple(int(v) for v in row) for row in mem_order)
    return GridConfig(
        gdims=gdims,
        gdims_dist=None if gdist == _ZERO3 else gdist,
        pdims=tuple(int(v) for v in config.pdims),
        rank_order=rank_order,
        transpose_axis_contiguous=tuple(
            bool(v) for v in config.transpose_axis_contiguous),
        transpose_mem_order=mem_order,
        transpose_method=_TRANSPOSE_BACKEND_MAP[config.transpose_comm_backend],
        halo_method=_HALO_BACKEND_MAP[config.halo_comm_backend],
    )


def _enabled_methods(options, table) -> Optional[tuple]:
    fams = [f for f, flag in
            (("mpi", options.disable_mpi_backends),
             ("nccl", options.disable_nccl_backends),
             ("nvshmem", options.disable_nvshmem_backends)) if not flag]
    if len(fams) == 3:
        return None  # nothing disabled: the library's default candidates
    if not fams:
        raise ValueError("all backend families disabled for autotuning "
                         "(reference rejects this too)")
    out: List = []
    for f in fams:
        for m in table[f]:
            if m not in out:
                out.append(m)
    return tuple(out)


def _native_options(options: cudecompGridDescAutotuneOptions_t,
                    ) -> AutotuneOptions:
    def per_op(v):
        t = tuple(tuple(int(x) for x in row) for row in v)
        return None if t == _ZERO43 else t

    return AutotuneOptions(
        n_warmup=int(options.n_warmup_trials),
        n_trials=int(options.n_trials),
        grid_mode=("halo" if options.grid_mode == CUDECOMP_AUTOTUNE_GRID_HALO
                   else "transpose"),
        dtype=(None if options.dtype is None
               else _DTYPE_MAP[options.dtype]),
        allow_uneven_decompositions=bool(options.allow_uneven_decompositions),
        skip_threshold=float(options.skip_threshold),
        autotune_transpose_method=bool(options.autotune_transpose_backend),
        autotune_halo_method=bool(options.autotune_halo_backend),
        methods=_enabled_methods(options, _FAMILY_METHODS),
        halo_methods=_enabled_methods(options, _FAMILY_HALO_METHODS),
        transpose_op_weights=tuple(
            float(w) for w in options.transpose_op_weights),
        transpose_input_halo_extents=per_op(
            options.transpose_input_halo_extents),
        transpose_output_halo_extents=per_op(
            options.transpose_output_halo_extents),
        transpose_input_padding=per_op(options.transpose_input_padding),
        transpose_output_padding=per_op(options.transpose_output_padding),
        halo_extents=tuple(int(v) for v in options.halo_extents),
        halo_periods=tuple(bool(v) for v in options.halo_periods),
        halo_axis=int(options.halo_axis),
        halo_padding=tuple(int(v) for v in options.halo_padding),
    )


_REVERSE_TRANSPOSE_MAP = {
    TransposeMethod.RING: CUDECOMP_TRANSPOSE_COMM_MPI_P2P,
    TransposeMethod.RING_PIPELINED: CUDECOMP_TRANSPOSE_COMM_MPI_P2P_PL,
    TransposeMethod.ALL_TO_ALL: CUDECOMP_TRANSPOSE_COMM_MPI_A2A,
    TransposeMethod.RING_XOR: CUDECOMP_TRANSPOSE_COMM_NCCL,
    TransposeMethod.RING_HIER: CUDECOMP_TRANSPOSE_COMM_NCCL,
    TransposeMethod.PALLAS_A2A: CUDECOMP_TRANSPOSE_COMM_NVSHMEM,
}
_REVERSE_HALO_MAP = {
    HaloMethod.PPERMUTE: CUDECOMP_HALO_COMM_MPI,
    HaloMethod.PALLAS: CUDECOMP_HALO_COMM_NVSHMEM,
}


def _device_of(handle) -> torch.device:
    return handle.device if handle is not None else _grid.init("cuda")


def cudecompGridDescCreate(handle: cudecompHandle_t,
                           config: cudecompGridDescConfig_t,
                           options: Optional[
                               cudecompGridDescAutotuneOptions_t] = None,
                           mesh=None):
    """``cudecompGridDescCreate`` (cudecomp.h:296): ``make_grid(config,
    handle.device, mesh=mesh, autotune_options=options)`` (a None handle
    means CUDA).  Like the reference, which copies the possibly autotuned
    configuration back into the caller's struct (src/cudecomp.cc:
    1248-1265), it updates ``config`` in place with the winning pdims and
    backends.  ``mesh`` (a DeviceMesh with dims ``('pr', 'pc')``) stands
    in for the JAX package's ``devices``; without it a grid of more than
    one rank builds its mesh over the default process group."""
    native_opts = _native_options(options) if options is not None else None
    g = _grid.make_grid(_native_config(config), _device_of(handle),
                        mesh=mesh, autotune_options=native_opts)
    config.pdims = tuple(g.pdims)
    config.transpose_comm_backend = _REVERSE_TRANSPOSE_MAP[
        g.config.transpose_method]
    config.halo_comm_backend = _REVERSE_HALO_MAP[g.config.halo_method]
    return g


def cudecompGridDescDestroy(handle: cudecompHandle_t, grid_desc) -> None:
    """``cudecompGridDescDestroy`` (cudecomp.h:313).  Descriptors are
    garbage-collected; call :func:`cudecompFinalize` (or the native
    ``clear_plan_caches``) to release cached plans eagerly."""


def cudecompGetGridDescConfig(handle: cudecompHandle_t,
                              grid_desc) -> cudecompGridDescConfig_t:
    """``cudecompGetGridDescConfig`` (cudecomp.h:497)."""
    cfg = grid_desc.config
    return cudecompGridDescConfig_t(
        gdims=cfg.gdims,
        gdims_dist=cfg.effective_gdims_dist,
        pdims=cfg.pdims,
        rank_order=(CUDECOMP_RANK_ORDER_COL_MAJOR
                    if cfg.rank_order == RankOrder.COL_MAJOR
                    else CUDECOMP_RANK_ORDER_ROW_MAJOR),
        transpose_comm_backend=_REVERSE_TRANSPOSE_MAP[cfg.transpose_method],
        transpose_axis_contiguous=cfg.transpose_axis_contiguous,
        transpose_mem_order=tuple(cfg.mem_order(ax) for ax in range(3)),
        halo_comm_backend=_REVERSE_HALO_MAP[cfg.halo_method],
    )


# -- queries (cudecomp.h:358-545) ----------------------------------------------

def cudecompGetPencilInfo(handle: cudecompHandle_t, grid_desc, axis: int,
                          halo_extents=None, padding=None, rank=None):
    """``cudecompGetPencilInfo`` (cudecomp.h:383): the native
    :class:`PencilInfo` (the field names of ``cudecompPencilInfo_t``),
    this rank's unless ``rank`` is given."""
    return grid_desc.pencil_info(axis, rank=rank,
                                 halo_extents=halo_extents, padding=padding)


def cudecompGetTransposeWorkspaceSize(handle: cudecompHandle_t, grid_desc,
                                      elem_bytes: int = 4) -> int:
    """``cudecompGetTransposeWorkspaceSize`` (cudecomp.h:401), in
    elements.  Diagnostic only: the exchanges allocate their own."""
    return geometry.transpose_workspace_size(grid_desc.config,
                                             elem_bytes=elem_bytes)


def cudecompGetHaloWorkspaceSize(handle: cudecompHandle_t, grid_desc,
                                 axis: int, halo_extents,
                                 elem_bytes: int = 4) -> int:
    """``cudecompGetHaloWorkspaceSize`` (cudecomp.h:420), in elements."""
    return geometry.halo_workspace_size(grid_desc.config, axis, halo_extents,
                                        elem_bytes=elem_bytes)


def cudecompGetDataTypeSize(dtype: int) -> int:
    """``cudecompGetDataTypeSize`` (cudecomp.h:430)."""
    return torch.empty((), dtype=_DTYPE_MAP[dtype]).element_size()


def cudecompMalloc(handle: cudecompHandle_t, grid_desc, nbytes: int) -> None:
    """``cudecompMalloc`` (cudecomp.h:447): a no-op; build tensors on
    ``grid_desc.device`` of ``grid_desc.buffer_shape(axis)``."""
    return None


def cudecompFree(handle: cudecompHandle_t, grid_desc, buffer) -> None:
    """``cudecompFree`` (cudecomp.h:462): a no-op (garbage collection)."""
    return None


def cudecompGetShiftedRank(handle: cudecompHandle_t, grid_desc, axis: int,
                           dim: int, displacement: int, periodic: bool,
                           rank: Optional[int] = None) -> int:
    """``cudecompGetShiftedRank`` (cudecomp.h:517).  ``rank`` defaults to
    this process's rank in the default process group, or 0 without one
    (the reference uses the calling rank); -1 means off-domain, as in the
    reference."""
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return grid_desc.shifted_rank(axis, dim, displacement, periodic, rank)


# -- operations (cudecomp.h:545-715) -------------------------------------------

def _transpose_entry(fn, grid_desc, input, output, work, dtype,
                     input_halo_extents, output_halo_extents,
                     input_padding, output_padding, stream):
    del output, work, dtype, stream  # the result is returned
    return fn(grid_desc, input,
              input_halo_extents=input_halo_extents,
              output_halo_extents=output_halo_extents,
              input_padding=input_padding,
              output_padding=output_padding)


def cudecompTransposeXToY(handle, grid_desc, input, output=None, work=None,
                          dtype=None, input_halo_extents=None,
                          output_halo_extents=None, input_padding=None,
                          output_padding=None, stream=None):
    """``cudecompTransposeXToY`` (cudecomp.h:545): RETURNS the y-pencil
    tensor (``output``/``work``/``dtype``/``stream`` accepted, ignored)."""
    return _transpose_entry(_transpose.transpose_x_to_y, grid_desc, input,
                            output, work, dtype, input_halo_extents,
                            output_halo_extents, input_padding,
                            output_padding, stream)


def cudecompTransposeYToZ(handle, grid_desc, input, output=None, work=None,
                          dtype=None, input_halo_extents=None,
                          output_halo_extents=None, input_padding=None,
                          output_padding=None, stream=None):
    """``cudecompTransposeYToZ`` (cudecomp.h:574)."""
    return _transpose_entry(_transpose.transpose_y_to_z, grid_desc, input,
                            output, work, dtype, input_halo_extents,
                            output_halo_extents, input_padding,
                            output_padding, stream)


def cudecompTransposeZToY(handle, grid_desc, input, output=None, work=None,
                          dtype=None, input_halo_extents=None,
                          output_halo_extents=None, input_padding=None,
                          output_padding=None, stream=None):
    """``cudecompTransposeZToY`` (cudecomp.h:603)."""
    return _transpose_entry(_transpose.transpose_z_to_y, grid_desc, input,
                            output, work, dtype, input_halo_extents,
                            output_halo_extents, input_padding,
                            output_padding, stream)


def cudecompTransposeYToX(handle, grid_desc, input, output=None, work=None,
                          dtype=None, input_halo_extents=None,
                          output_halo_extents=None, input_padding=None,
                          output_padding=None, stream=None):
    """``cudecompTransposeYToX`` (cudecomp.h:632)."""
    return _transpose_entry(_transpose.transpose_y_to_x, grid_desc, input,
                            output, work, dtype, input_halo_extents,
                            output_halo_extents, input_padding,
                            output_padding, stream)


def _halo_entry(axis, grid_desc, input, work, dtype, halo_extents,
                halo_periods, dim, padding, stream):
    del work, dtype, stream
    return _halo.update_halos(grid_desc, input, axis, halo_extents,
                              halo_periods, dim=dim, padding=padding)


def cudecompUpdateHalosX(handle, grid_desc, input, work=None, dtype=None,
                         halo_extents=None, halo_periods=None, dim=None,
                         padding=None, stream=None):
    """``cudecompUpdateHalosX`` (cudecomp.h:661): updates the x-pencil
    tensor's halos in place and returns it.  ``dim=None`` updates every
    dim with a nonzero halo (the reference's loop of per-dim calls)."""
    return _halo_entry(0, grid_desc, input, work, dtype, halo_extents,
                       halo_periods, dim, padding, stream)


def cudecompUpdateHalosY(handle, grid_desc, input, work=None, dtype=None,
                         halo_extents=None, halo_periods=None, dim=None,
                         padding=None, stream=None):
    """``cudecompUpdateHalosY`` (cudecomp.h:688)."""
    return _halo_entry(1, grid_desc, input, work, dtype, halo_extents,
                       halo_periods, dim, padding, stream)


def cudecompUpdateHalosZ(handle, grid_desc, input, work=None, dtype=None,
                         halo_extents=None, halo_periods=None, dim=None,
                         padding=None, stream=None):
    """``cudecompUpdateHalosZ`` (cudecomp.h:715)."""
    return _halo_entry(2, grid_desc, input, work, dtype, halo_extents,
                       halo_periods, dim, padding, stream)
