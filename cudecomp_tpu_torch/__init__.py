"""cudecomp_tpu_torch — the pencil-decomposition library in PyTorch and CUDA.

The port of ``cudecomp_tpu`` (JAX, TPU) to PyTorch on an NVIDIA H100; the
JAX package stays the reference and the tests hold this package to it.

  * the process grid is a ``torch.distributed`` DeviceMesh with dims
    ``('pr', 'pc')`` (none for a ``(1, 1)`` grid), and each rank holds its
    own local pencil tensor on an explicit ``torch.device``;
  * transposes exchange with ``all_to_all_single`` over one mesh dim, or,
    with ``TransposeMethod.PALLAS_A2A``, with K2, the one-sided all-to-all
    CUDA kernel (``ops.peer_kernels``), which puts into torch symmetric
    memory that every rank of the group maps, so that ranks may share one
    card over gloo; the slab path's local permute is the K1 CUDA kernel
    (``ops.cuda_kernels``);
  * the distributed FFT runs ``torch.fft`` (cuFFT) between transposes;
  * halo updates and the stencil path's ghost planes travel by
    ``batch_isend_irecv`` neighbour shifts, or, with ``HaloMethod.PALLAS``,
    by K3, the one-sided halo kernel (``ops.peer_kernels``); the stencils
    are the K4 CUDA kernel (``ops.stencil_kernel``);
  * the spectral operators and solvers run on the distributed FFT; with
    ``CUDECOMP_TPU_FFT_FUSED2=1`` a split-complex plan runs the (1, 2)
    pair of an eligible 3D stage through the K5 CUDA kernel
    (``ops.dft2``).

  * ``make_grid`` with pdims ``(0, 0)`` runs the autotuner (``autotune``),
    which times the candidate process grids, transpose methods (the
    all-to-all, the per-peer rings, the pipelined transpose and the
    kernel exchange, where each can run), layouts and halo methods on the
    grid's device; the performance report (``performance``) records each
    transpose and halo update while it is on.

Ported so far: config, geometry, grid and mesh, every exchange strategy,
the four transposes, the distributed FFT, the halo engine, the
ghost-plane stencil path, the spectral operators, the Poisson (spectral
and CG), Taylor-Green and projection solvers, checkpoints, the autotuner,
the performance report and timing, and the benchmark.
"""

from cudecomp_tpu_torch.config import (
    AutotuneOptions,
    CannotRun,
    GridConfig,
    HaloMethod,
    RankOrder,
    TransposeMethod,
)
from cudecomp_tpu_torch.geometry import (
    PencilInfo,
    get_pencil_info,
    get_shifted_rank,
    get_split_offsets,
    get_splits,
    global_buffer_shape,
    halo_workspace_size,
    pencil_buffer_shape,
    transpose_workspace_size,
)
from cudecomp_tpu_torch.grid import (GridDescriptor, clear_plan_caches,
                                     finalize, init, make_grid)
from cudecomp_tpu_torch.ops.fft import DistributedFFT, fft3d, ifft3d
from cudecomp_tpu_torch.ops.halo import update_halos
from cudecomp_tpu_torch.ops.spectral import (SpectralOperators, dealias_mask,
                                             wavenumber_fields)
from cudecomp_tpu_torch.ops.stencil import (diffusion_step, halo_map,
                                            laplacian7, stencil_apply)
from cudecomp_tpu_torch import models
from cudecomp_tpu_torch.ops.transpose import (
    transpose_x_to_y,
    transpose_y_to_x,
    transpose_y_to_z,
    transpose_z_to_y,
)
from cudecomp_tpu_torch.autotune import AutotuneResult, autotune
from cudecomp_tpu_torch import performance
from cudecomp_tpu_torch.performance import (perf_report_enable, profile_trace,
                                            segment_roundtrip)
from cudecomp_tpu_torch.utils import checkpoint
from cudecomp_tpu_torch.utils.arrays import (gather_global, scatter_global,
                                             valid_interior_mask)

__version__ = "0.1.0"

__all__ = [
    "GridConfig",
    "TransposeMethod",
    "HaloMethod",
    "RankOrder",
    "AutotuneOptions",
    "CannotRun",
    "PencilInfo",
    "get_splits",
    "get_split_offsets",
    "get_pencil_info",
    "get_shifted_rank",
    "pencil_buffer_shape",
    "global_buffer_shape",
    "transpose_workspace_size",
    "halo_workspace_size",
    "GridDescriptor",
    "make_grid",
    "clear_plan_caches",
    "init",
    "finalize",
    "transpose_x_to_y",
    "transpose_y_to_x",
    "transpose_y_to_z",
    "transpose_z_to_y",
    "update_halos",
    "laplacian7",
    "diffusion_step",
    "halo_map",
    "stencil_apply",
    "models",
    "DistributedFFT",
    "fft3d",
    "ifft3d",
    "SpectralOperators",
    "wavenumber_fields",
    "dealias_mask",
    "autotune",
    "AutotuneResult",
    "performance",
    "perf_report_enable",
    "profile_trace",
    "segment_roundtrip",
    "checkpoint",
    "scatter_global",
    "gather_global",
    "valid_interior_mask",
]
