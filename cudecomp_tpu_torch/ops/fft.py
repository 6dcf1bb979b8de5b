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
(``ops/dft2.py``), where the JAX package runs its Pallas ``dft2_fused``;
the plan's ``fused2`` field, when set, pins that choice for the plan.
:func:`autotune_fft` is the plan-time search: on cuFFT the one per-plan
policy is whether an eligible stage's (1, 2) pair runs through K5, so it
gate-checks and times ``fused2=False`` and ``fused2=True`` and pins the
fastest that passes (the JAX package searches the TPU matmul FFT's
``(precision, gauss)`` policies, which mean nothing to cuFFT).

Layouts: ``split_complex=False`` takes and returns complex tensors;
``split_complex=True`` takes and returns float tensors with a trailing dim
of 2 (re, im), which is exactly ``torch.view_as_real`` of the complex
tensor, so no copy is made either way; the plane forms take and return
``(r, i)`` tuples.  Normalization follows ``torch.fft``'s default
(``norm="backward"``: the inverse scales by 1/N), as the JAX package does.
Every form is differentiable (``torch.fft``, K5's and K1's Functions and
the exchanges' own).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cudecomp_tpu_torch.config import CannotRun, GridConfig
from cudecomp_tpu_torch.grid import GridDescriptor
from cudecomp_tpu_torch.ops import transpose as tr
from cudecomp_tpu_torch.ops.dft2 import dft2, dft2_fits
from cudecomp_tpu_torch.parallel.collectives import all_reduce_grid
from cudecomp_tpu_torch.utils.env import fft_fused2
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
    ``fused2`` is the port's plan policy: whether a ``split_complex``
    plan runs the (1, 2) pair of a 3D stage that K5 takes through K5
    (None: as ``CUDECOMP_TPU_FFT_FUSED2`` says, read per call).
    """

    grid: GridDescriptor
    real: bool = False
    split_complex: bool = False
    precision: str = None
    gauss: bool = None
    fused2: Optional[bool] = None

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

    def _takes_k5(self) -> bool:
        """Whether this plan runs eligible (1, 2) pairs through K5: a
        ``split_complex`` plan, and ``fused2`` (or the environment's
        opt-in when it is None)."""
        if not self.split_complex:
            return False
        return fft_fused2() if self.fused2 is None else bool(self.fused2)

    def _fftn(self, x, dims, inverse):
        """FFT over ``dims``.  A plan that takes K5 (:meth:`_takes_k5`)
        runs dims (1, 2) of a 3D stage through K5 first when
        :func:`~cudecomp_tpu_torch.ops.dft2.dft2_fits` holds, then the
        remaining dims, as JAX's ``fft_planes`` does
        (``mxu_fft.py:488-492``)."""
        if {1, 2} <= set(dims) and self._takes_k5() and dft2_fits(x):
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


# -- FFT plan autotuning ----------------------------------------------------------


@dataclasses.dataclass
class FFTTrialRecord:
    """One candidate of :func:`autotune_fft`: its ``fused2`` policy, the
    gate's round-trip error, whether it passed, the trial times averaged
    over the ranks and their mean; ``reason`` says why a candidate did
    not run (``err`` and ``avg_s`` are then inf)."""
    fused2: bool
    err: float
    gate_passed: bool
    times_s: tuple
    avg_s: float
    reason: Optional[str] = None


@dataclasses.dataclass
class FFTAutotuneResult:
    plan: "DistributedFFT"
    trials: list
    best_time_s: float

    def report(self) -> str:
        lines = ["CUDECOMP_TPU: FFT plan autotune (avg s | gate):"]
        for t in self.trials:
            if t.reason is not None:
                status = f"not run: {t.reason}"
            else:
                status = (f"{t.avg_s:.6f} | err {t.err:.2e} "
                          f"{'PASS' if t.gate_passed else 'FAIL'}")
            lines.append(f"  fused2={int(t.fused2)} {status}")
        lines.append(f"  -> selected fused2={int(self.plan.fused2)} "
                     f"({self.best_time_s:.6f} s)")
        return "\n".join(lines)


def _k5_stage(plan: DistributedFFT) -> None:
    """Raise :class:`~cudecomp_tpu_torch.config.CannotRun` unless ``plan``
    (complex64 data) has a 3D stage whose dims (1, 2) K5 takes."""
    if not plan.split_complex:
        raise CannotRun("K5 runs only in split_complex plans")
    cgrid = plan.complex_grid
    for kind, a, *rest in plan._stages():
        if kind != "fft" or not {1, 2} <= set(_fft_axes(cgrid, a, rest[0])):
            continue
        probe = torch.empty(cgrid.buffer_shape(a), dtype=torch.complex64,
                            device="meta")
        if dft2_fits(probe):
            return
    shapes = [cgrid.buffer_shape(a) for kind, a, *rest in plan._stages()
              if kind == "fft"]
    raise CannotRun(f"no 3D FFT stage with dims (1, 2) inside K5's gate "
                    f"(N1 <= 256, N1 % 8 == 0, N2 in (128, 256)); the "
                    f"stages' pencils are {shapes}")


def _max_over_grid(v: torch.Tensor, grid) -> float:
    """The max of the scalar ``v`` over every rank of ``grid`` (a CPU
    tensor on gloo)."""
    if grid.mesh is not None and "gloo" in str(dist.get_backend()):
        v = v.cpu()
    return float(all_reduce_grid(v.clone(), grid, op=dist.ReduceOp.MAX))


def autotune_fft(grid, real: bool = False, *, candidates=None,
                 gate: float = 5e-4, n_warmup: int = 2, n_trials: int = 3,
                 iters: int = 8, seed: int = 0) -> FFTAutotuneResult:
    """Plan-time FFT policy search (``cudecomp_tpu.ops.fft.autotune_fft``):
    gate-check each candidate ``fused2`` policy, time those that pass, and
    pin the fastest into the returned plan.  Every rank of ``grid`` must
    call.

    For each candidate the plane-carried forward+inverse cycle of a
    ``split_complex`` plan is (a) gate-checked: one round trip on
    standard-normal float32 data must return within ``gate`` max abs
    error over the ranks, the reference benchmark's single-precision
    tolerance (``benchmark.cu:23-27``); (b) timed with
    ``performance.time_fn(..., iters=)`` on the grid's device.  Trial
    times are averaged over the ranks (``autotune._allreduce_trials``), so
    every rank picks alike.  On an uneven grid the data is zero outside
    the valid interior, which the round trip preserves.  The data comes
    from ``torch.Generator(device=grid.device)`` seeded with ``seed``, on
    the grid's own device.

    Default candidates ``(False, True)``: cuFFT alone, then K5 for the
    (1, 2) pair of every 3D stage it takes.  A ``True`` candidate with no
    such stage does not run and is recorded with its reason, as is any
    candidate that raises ``CannotRun``; any other error propagates.
    Raises ``RuntimeError`` naming each candidate and its error when none
    passes.
    """
    from cudecomp_tpu_torch import performance as perf
    from cudecomp_tpu_torch.autotune import _allreduce_trials
    from cudecomp_tpu_torch.utils.arrays import valid_interior_mask

    if candidates is None:
        candidates = (False, True)
    shape = grid.buffer_shape(0)
    gen = torch.Generator(device=grid.device).manual_seed(seed)

    def normal():
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=grid.device)

    # padding slots of an uneven decomposition are zeroed by the transposes;
    # random data there would fail every candidate's gate
    mask = None
    if grid.global_shape(0) != grid.config.gdims:
        mask = valid_interior_mask(grid, 0)

    def masked(v):
        return v if mask is None else v * mask

    data = masked(normal()) if real else (masked(normal()), masked(normal()))

    trials: List[FFTTrialRecord] = []
    best: Optional[Tuple[float, DistributedFFT]] = None
    for fused2 in candidates:
        fused2 = bool(fused2)
        plan = DistributedFFT(grid=grid, real=real, split_complex=True,
                              fused2=fused2)

        def cycle(v, plan=plan):
            return plan.inverse_planes(plan.forward_planes(v))

        try:
            if fused2:
                _k5_stage(plan)
            out = cycle(data)
            if real:
                local = (out - data).abs().max()
            else:
                local = torch.maximum((out[0] - data[0]).abs().max(),
                                      (out[1] - data[1]).abs().max())
            err = _max_over_grid(local, grid)
            passed = bool(err < gate)
            times = ()
            if passed:
                times = tuple(_allreduce_trials(perf.time_fn(
                    cycle, data, n_warmup=n_warmup, n_trials=n_trials,
                    iters=iters, device=grid.device)))
        except CannotRun as e:
            trials.append(FFTTrialRecord(fused2, float("inf"), False, (),
                                         float("inf"), reason=str(e)))
            continue
        avg = float(np.mean(times)) if times else float("inf")
        trials.append(FFTTrialRecord(fused2, err, passed, times, avg))
        if passed and (best is None or avg < best[0]):
            best = (avg, plan)

    if best is None:
        raise RuntimeError(
            f"autotune_fft: no candidate policy passed the {gate:g} "
            f"round-trip gate: " + "; ".join(
                f"(fused2={int(t.fused2)}) "
                + (f"not run: {t.reason}" if t.reason is not None
                   else f"err={t.err:g}") for t in trials))
    return FFTAutotuneResult(plan=best[1], trials=trials,
                             best_time_s=best[0])
