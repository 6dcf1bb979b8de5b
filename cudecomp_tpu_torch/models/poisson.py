"""Poisson solver on the pencil decomposition (``cudecomp_tpu.models.
poisson``), the analog of the reference's ``examples/fortran/poisson/
poisson.f90``.

:meth:`PoissonSolver.solve` solves ``lap(u) = f`` (periodic) by a forward
FFT, a multiply by ``-1/|k|^2`` (zero mode pinned to 0), or by the inverse
symbol of the discrete 7-point Laplacian, and an inverse FFT.  The scale
field is built once per solver in float64 (with the r2c halving and the
padded Z-pencil layout) and cast once per state dtype, so a complex64
spectrum stays complex64.  :meth:`PoissonSolver.solve_cg` is the
matrix-free conjugate-gradient solve of the discrete equation, whose
matvec is one K4 stencil pass.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from cudecomp_tpu_torch.grid import GridDescriptor
from cudecomp_tpu_torch.ops.fft import DistributedFFT
from cudecomp_tpu_torch.parallel.collectives import all_reduce_grid
from cudecomp_tpu_torch.utils.tracing import trace_range


@dataclasses.dataclass(frozen=True)
class PoissonSolver:
    """Periodic Poisson solver: ``solve(f)`` returns u with ``lap(u) = f``
    and zero mean.  Works in complex (default) or split-complex mode; with
    ``real=True`` (the default) ``f`` is a real X-pencil tensor."""

    grid: GridDescriptor
    lengths: Tuple[float, float, float] = (2 * np.pi, 2 * np.pi, 2 * np.pi)
    real: bool = True
    split_complex: bool = False
    # init=False: dataclasses.replace() must not carry a populated cache
    # into a solver with other parameters
    _cache: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False, init=False)

    @property
    def plan(self) -> DistributedFFT:
        return DistributedFFT(grid=self.grid, real=self.real,
                              split_complex=self.split_complex)

    def _sops(self):
        from cudecomp_tpu_torch.ops.spectral import SpectralOperators
        return SpectralOperators(plan=self.plan, lengths=self.lengths,
                                 dtype=np.float64)

    def _inv_k2(self):
        """``-1/|k|^2`` (zero mode 0) over this rank's spectral block,
        float64: ``solve`` divides by ``-|k|^2``."""
        cached = self._cache.get("inv_k2")
        if cached is None:
            cached = -self._sops().inv_k_squared()
            self._cache["inv_k2"] = cached
        return cached

    def _inv_symbol_fd(self):
        """Inverse symbol of the DISCRETE 7-point Laplacian: the DFT
        diagonalizes ``lap_h`` with per-axis eigenvalues
        ``-(4/h_d^2) sin^2(k_d h_d / 2)`` (zero mode pinned), so one FFT
        pair solves the FD system exactly (what ``solve_cg`` iterates
        toward).  float64."""
        cached = self._cache.get("inv_fd")
        if cached is None:
            sym = None
            for k, n, L in zip(self._sops().wavenumbers(),
                               self.grid.config.gdims, self.lengths):
                h = L / n
                term = (4.0 / (h * h)) * torch.sin(k * h / 2.0) ** 2
                sym = term if sym is None else sym + term
            cached = torch.where(sym > 0,
                                 -1.0 / torch.where(sym > 0, sym, 1.0), 0.0)
            self._cache["inv_fd"] = cached
        return cached

    def _scale(self, discrete: bool, dtype: torch.dtype) -> torch.Tensor:
        """The spectral scale in ``dtype`` (cast once, then cached)."""
        key = ("scale", bool(discrete), dtype)
        cached = self._cache.get(key)
        if cached is None:
            field = self._inv_symbol_fd() if discrete else self._inv_k2()
            cached = field.to(dtype)
            self._cache[key] = cached
        return cached

    def _solve_with(self, plan, f, discrete: bool):
        if self.split_complex and self.real:
            # plane-carried: the scale applies per plane
            rh, ih = plan.forward_planes(f)
            s = self._scale(discrete, rh.dtype)
            return plan.inverse_planes((rh * s, ih * s))
        fh = plan.forward(f)
        if self.split_complex:
            return plan.inverse(fh * self._scale(discrete, fh.dtype)[..., None])
        return plan.inverse(fh * self._scale(discrete, fh.real.dtype))

    def solve(self, f, discrete: bool = False):
        """``f``: this rank's X-pencil tensor on ``grid`` (real if
        ``real=True``; complex, or float with a trailing (re, im) dim of 2
        when ``split_complex``, if not).

        With ``discrete=True`` the scale is the inverse symbol of the
        discrete 7-point Laplacian instead of ``-1/|k|^2``: the result
        solves ``lap_h(u) = f`` exactly in one FFT pair."""
        with trace_range("cudecomp_tpu_torch.poisson_solve"):
            return self._solve_with(self.plan, f, discrete)

    def jitted(self):
        """A solve function with the plan and the continuous scale built
        in (PyTorch runs eagerly: a plain closure, for parity with the JAX
        package's jitted solve)."""
        plan = self.plan
        self._inv_k2()

        def solve(f):
            return self._solve_with(plan, f, False)

        return solve

    def _sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the whole grid: a local sum, then the ranks' sum."""
        return all_reduce_grid(torch.sum(t), self.grid)

    def _mean(self, t: torch.Tensor) -> torch.Tensor:
        return self._sum(t) / float(np.prod(self.grid.config.gdims))

    def solve_cg(self, f, tol: float = 1e-8, maxiter: int = 1000,
                 check_every: int = 64):
        """Matrix-free conjugate-gradient solve of the DISCRETE 7-point
        Poisson equation ``lap_h(u) = f`` (periodic, zero mean) for this
        rank's X-pencil tensor ``f``.

        The matvec is one K4 stencil pass per iteration: ``laplacian7``
        scaled by ``-1/h^2`` for uniform spacings, a weighted 7-tap
        ``stencil_apply`` (``1/h_d^2`` per dim) otherwise.  CG is valid
        because the operator is symmetric and positive semi-definite on
        the mean-zero subspace.  The dot products are local sums plus one
        sum over the grid's ranks.

        The host checks convergence once per ``check_every`` iterations
        (one scalar read from the device); in between, the iterations run
        without a host sync, and division guards keep a state that
        converged mid-chunk stationary.  So the solve may overshoot
        convergence by up to ``check_every - 1`` iterations.

        Returns ``(u, iters, rel_residual)``, the last two Python scalars.
        """
        from cudecomp_tpu_torch.ops.stencil import laplacian7, stencil_apply
        cfg = self.grid.config
        hs = [self.lengths[d] / cfg.gdims[d] for d in range(3)]
        periods = (True, True, True)
        check_every = max(1, min(int(check_every), int(maxiter)))

        if np.allclose(hs, hs[0]):
            inv_h2 = 1.0 / (hs[0] * hs[0])

            def matvec(v):
                return (-inv_h2) * laplacian7(self.grid, v, 0, periods)
        else:
            # anisotropic 7-point weights, laid out in MEMORY order
            # (stencil offsets are memory-dim offsets)
            order = cfg.mem_order(0)
            w = np.zeros((3, 3, 3))
            for d in range(3):
                inv = 1.0 / (hs[order[d]] ** 2)
                idx_lo = [1, 1, 1]
                idx_hi = [1, 1, 1]
                idx_lo[d], idx_hi[d] = 0, 2
                w[tuple(idx_lo)] = w[tuple(idx_hi)] = inv
                w[1, 1, 1] -= 2.0 * inv
            w = -w  # matvec is -lap (PSD)

            def matvec(v):
                return stencil_apply(self.grid, v, w, 0, periods)

        def guarded_div(num, den):
            ok = den > 0
            return torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)

        def step(u, r, p, rs):
            ap = matvec(p)
            alpha = guarded_div(rs, self._sum(p * ap))
            u = u + alpha * p
            r = r - alpha * ap
            rs_new = self._sum(r * r)
            beta = guarded_div(rs_new, rs)
            return u, r, r + beta * p, rs_new

        with trace_range("cudecomp_tpu_torch.poisson_solve_cg"):
            b = -(f - self._mean(f))
            rs = self._sum(b * b)
            bnorm_h = float(torch.sqrt(rs))
            u, r, p = torch.zeros_like(b), b, b
            it = 0
            rs_h = bnorm_h * bnorm_h  # rs0: reported when maxiter < 1
            while it < maxiter:
                for _ in range(check_every):
                    u, r, p, rs = step(u, r, p, rs)
                it += check_every
                rs_h = float(rs)
                if np.sqrt(rs_h) <= tol * bnorm_h:
                    break
            return (u - self._mean(u), it,
                    float(np.sqrt(rs_h)) / max(bnorm_h, 1e-300))
