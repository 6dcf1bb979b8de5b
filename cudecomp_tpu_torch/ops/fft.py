"""Distributed 3D FFT layered on the transpose engine.

The reference FFT benchmark skeleton (``benchmark/benchmark.cu:294-412,
501-611``): per-axis FFTs along each pencil's full axis interleaved with
global transposes,

    FFT_x -> X2Y -> FFT_y -> Y2Z -> FFT_z      (forward)
    iFFT_z -> Z2Y -> iFFT_y -> Y2X -> iFFT_x   (inverse)

with the reference's slab fusions (``benchmark.cu:294-356``): when a
transpose is communication-free and the memory orders agree, adjacent FFT
stages fuse into one multi-axis local FFT and the transpose is skipped.

The local FFTs are ``torch.fft`` (cuFFT on the GPU, as the reference
benchmark uses).  R2C/C2R uses the twin complex grid of the benchmark
(``benchmark.cu:238-252``): X extent ``X//2 + 1``, same Y/Z decomposition.
With ``CUDECOMP_TPU_FFT_FUSED2=1`` a ``split_complex`` plan runs the dims
(1, 2) of an eligible 3D stage through K5, the fused 2-axis DFT
(``ops/dft2.py``), where the JAX package runs its Pallas ``dft2_fused``.

Layouts: ``split_complex=False`` takes and returns complex tensors;
``split_complex=True`` takes and returns float tensors with a trailing dim
of 2 (re, im), which is exactly ``torch.view_as_real`` of the complex
tensor, so no copy is made either way; the plane forms take and return
``(r, i)`` tuples.  Normalization follows ``torch.fft``'s default
(``norm="backward"``: the inverse scales by 1/N), as the JAX package does.
"""

from __future__ import annotations

import dataclasses

import torch

from cudecomp_tpu_torch.config import GridConfig
from cudecomp_tpu_torch.grid import GridDescriptor
from cudecomp_tpu_torch.ops import transpose as tr
from cudecomp_tpu_torch.ops.dft2 import dft2, dft2_eligible
from cudecomp_tpu_torch.utils.tracing import trace_range


def _fft_axes(grid, axis, global_axes):
    """Tensor dims (in the pencil's memory order) holding the global axes."""
    inv = grid.config.inv_mem_order(axis)
    return tuple(inv[a] for a in global_axes)


def complex_grid_config(cfg: GridConfig) -> GridConfig:
    """Twin complex-grid config for R2C: X extent becomes X//2 + 1."""
    gx = cfg.gdims[0] // 2 + 1
    gd = None
    if cfg.gdims_dist is not None:
        gd = (min(cfg.gdims_dist[0], gx), cfg.gdims_dist[1], cfg.gdims_dist[2])
    return dataclasses.replace(cfg, gdims=(gx, cfg.gdims[1], cfg.gdims[2]),
                               gdims_dist=gd)


def plan_stages(cfg: GridConfig):
    """Forward plan of a (complex-grid) config: ('fft', pencil_axis,
    global_axes) and ('transpose', ax, dir) steps, with slab fusions.  A
    transpose is local when its process-grid factor is 1 AND the memory
    orders agree; then the two FFT stages around it fuse."""
    pr, pc = cfg.pdims
    xy_local = pr == 1 and cfg.mem_order(0) == cfg.mem_order(1)
    yz_local = pc == 1 and cfg.mem_order(1) == cfg.mem_order(2)

    if xy_local and yz_local:
        return [("fft", 0, (0, 1, 2))]           # single local 3D FFT
    if xy_local:
        return [("fft", 0, (0, 1)), ("transpose", 1, +1), ("fft", 2, (2,))]
    if yz_local:
        return [("fft", 0, (0,)), ("transpose", 0, +1), ("fft", 1, (1, 2))]
    return [("fft", 0, (0,)), ("transpose", 0, +1), ("fft", 1, (1,)),
            ("transpose", 1, +1), ("fft", 2, (2,))]


def _as_complex(x: torch.Tensor) -> torch.Tensor:
    if x.dim() < 1 or x.shape[-1] != 2:
        raise ValueError(f"split-complex input must have trailing dim 2, "
                         f"got shape {tuple(x.shape)}")
    return torch.view_as_complex(x.contiguous())


def _zero_dc_nyquist_imag_(xh: torch.Tensor, dim: int, n: int) -> None:
    """In place: zero the imaginary parts of the DC and (even n) Nyquist
    bins along ``dim``.  c2r treats them as real by Hermitian symmetry
    (``cudecomp_tpu/ops/mxu_fft.py:662-666``); cuFFT's C2R makes no such
    promise for input that is not Hermitian, so they are zeroed here."""
    parts = torch.view_as_real(xh)
    parts.select(dim, 0)[..., 1] = 0
    if n % 2 == 0:
        parts.select(dim, n // 2)[..., 1] = 0


@dataclasses.dataclass(frozen=True)
class DistributedFFT:
    """A planned distributed 3D FFT over a grid descriptor.

    ``forward`` maps this rank's X-pencil physical-space tensor to its
    Z-pencil spectral tensor; ``inverse`` maps back.  For ``real=True`` the
    forward input is a real X-pencil on ``grid`` and the spectrum lives on
    ``complex_grid`` (X extent X//2+1).

    ``precision`` and ``gauss`` pin the TPU matmul FFT's policy in the JAX
    package; they mean nothing to cuFFT, and any value but None raises.
    """

    grid: GridDescriptor
    real: bool = False
    split_complex: bool = False
    precision: str = None
    gauss: bool = None

    def __post_init__(self):
        if self.precision is not None or self.gauss is not None:
            raise ValueError(
                "precision and gauss steer the TPU matmul FFT; cuFFT has no "
                f"such policy (got precision={self.precision!r}, "
                f"gauss={self.gauss!r})")

    @property
    def complex_grid(self) -> GridDescriptor:
        if not self.real:
            return self.grid
        return dataclasses.replace(
            self.grid, config=complex_grid_config(self.grid.config))

    def _stages(self):
        return plan_stages(self.complex_grid.config)

    # -- execution on complex tensors -----------------------------------------

    def _fftn(self, x, dims, inverse):
        """FFT over ``dims``.  A ``split_complex`` plan runs dims (1, 2) of
        a 3D stage through K5 first when :func:`~cudecomp_tpu_torch.ops.
        dft2.dft2_eligible` holds, then the remaining dims, as JAX's
        ``fft_planes`` does (``mxu_fft.py:488-492``)."""
        if self.split_complex and {1, 2} <= set(dims) and dft2_eligible(x):
            x = dft2(x.contiguous(), inverse)
            dims = tuple(d for d in dims if d not in (1, 2))
            if not dims:
                return x
        return (torch.fft.ifftn if inverse else torch.fft.fftn)(x, dim=dims)

    def _forward_complex(self, x):
        cgrid = self.complex_grid
        first_fft = True
        for kind, a, *rest in self._stages():
            if kind == "fft":
                if self.real and first_fft:
                    x = self._rfft_stage(cgrid, x, rest[0])
                else:
                    x = self._fftn(x, _fft_axes(cgrid, a, rest[0]), False)
                first_fft = False
            else:
                op = tr.transpose_x_to_y if a == 0 else tr.transpose_y_to_z
                x = op(cgrid, x)
        return x

    def _inverse_complex(self, xh, owned: bool):
        """``owned``: whether ``xh`` may be written (c2r zeroes two bins)."""
        cgrid = self.complex_grid
        x = xh
        rev = list(reversed(self._stages()))
        last_fft_idx = max(i for i, s in enumerate(rev) if s[0] == "fft")
        for i, (kind, a, *rest) in enumerate(rev):
            if kind == "fft":
                if self.real and i == last_fft_idx:
                    return self._irfft_stage(cgrid, x, rest[0],
                                             owned or i > 0)
                x = self._fftn(x, _fft_axes(cgrid, a, rest[0]), True)
            else:
                op = tr.transpose_y_to_x if a == 0 else tr.transpose_z_to_y
                x = op(cgrid, x)
        return x

    def _rfft_stage(self, cgrid, x, global_axes):
        """First forward stage for R2C: rfft along X plus FFTs over any
        other fused axes (the padded-pencil format is preserved)."""
        x_dim = self.grid.config.inv_mem_order(0)[0]
        xh = torch.fft.rfft(x, dim=x_dim)
        other = [a for a in global_axes if a != 0]
        if other:
            xh = self._fftn(xh, _fft_axes(cgrid, 0, other), False)
        return xh

    def _irfft_stage(self, cgrid, xh, global_axes, owned):
        """Last inverse stage for C2R: inverse of :meth:`_rfft_stage`."""
        other = [a for a in global_axes if a != 0]
        if other:
            xh = self._fftn(xh, _fft_axes(cgrid, 0, other), True)
        elif not owned:
            xh = xh.clone()
        x_dim = self.grid.config.inv_mem_order(0)[0]
        n = self.grid.config.gdims[0]
        _zero_dc_nyquist_imag_(xh, x_dim, n)
        return torch.fft.irfft(xh, n=n, dim=x_dim)

    # -- public forms ------------------------------------------------------------

    def forward(self, x):
        """Physical X-pencil -> spectral Z-pencil."""
        with trace_range("cudecomp_tpu_torch.fft3d_forward"):
            if self.split_complex and not self.real:
                x = _as_complex(x)
            y = self._forward_complex(x)
            return torch.view_as_real(y) if self.split_complex else y

    def inverse(self, xh):
        """Spectral Z-pencil -> physical X-pencil."""
        with trace_range("cudecomp_tpu_torch.fft3d_inverse"):
            if self.split_complex:
                xh = _as_complex(xh)
            y = self._inverse_complex(xh, owned=False)
            if self.split_complex and not self.real:
                return torch.view_as_real(y)
            return y

    def _require_planes(self):
        if not self.split_complex:
            raise ValueError("plane-form FFT requires split_complex=True")

    def forward_planes(self, x):
        """Plane-form forward.  c2c: ``x = (r, i)``; r2c (``real=True``):
        ``x`` is the real X-pencil.  Returns spectral planes ``(r, i)``
        (views of one complex tensor)."""
        self._require_planes()
        with trace_range("cudecomp_tpu_torch.fft3d_forward"):
            y = self._forward_complex(x if self.real else torch.complex(*x))
            return y.real, y.imag

    def inverse_planes(self, planes):
        """Plane-form inverse of :meth:`forward_planes`: spectral planes
        ``(r, i)`` to ``(r, i)`` planes (c2c) or the real X-pencil."""
        self._require_planes()
        with trace_range("cudecomp_tpu_torch.fft3d_inverse"):
            y = self._inverse_complex(torch.complex(*planes), owned=True)
            return y if self.real else (y.real, y.imag)


def fft3d(grid, x, real: bool = False, split_complex: bool = False):
    """One-shot forward distributed FFT (see :class:`DistributedFFT`)."""
    return DistributedFFT(grid=grid, real=real,
                          split_complex=split_complex).forward(x)


def ifft3d(grid, xh, real: bool = False, split_complex: bool = False):
    """One-shot inverse distributed FFT."""
    return DistributedFFT(grid=grid, real=real,
                          split_complex=split_complex).inverse(xh)
