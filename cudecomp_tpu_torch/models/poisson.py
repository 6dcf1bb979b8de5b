"""Poisson solver on the pencil decomposition (``cudecomp_tpu.models.
poisson``).

:meth:`PoissonSolver.solve_cg` is the matrix-free conjugate-gradient solve
of the discrete 7-point Poisson equation, whose matvec is one K4 stencil
pass.  The spectral solve (``solve``, ``jitted`` and the spectral inverse
symbols) needs ``ops/spectral.py``, which the port does not have yet: they
raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from cudecomp_tpu_torch.grid import GridDescriptor
from cudecomp_tpu_torch.parallel.collectives import all_reduce_grid
from cudecomp_tpu_torch.utils.tracing import trace_range

_SPECTRAL = ("the spectral Poisson solve needs ops/spectral.py, the next "
             "slice of the cudecomp_tpu_torch port (ROADMAP Queue 1, item "
             "9); use solve_cg")


@dataclasses.dataclass(frozen=True)
class PoissonSolver:
    """Periodic Poisson solver for ``lap(u) = f`` with zero mean."""

    grid: GridDescriptor
    lengths: Tuple[float, float, float] = (2 * np.pi, 2 * np.pi, 2 * np.pi)

    def _inv_k2(self):
        raise NotImplementedError(_SPECTRAL)

    def _inv_symbol_fd(self):
        raise NotImplementedError(_SPECTRAL)

    def solve(self, f, discrete: bool = False):
        raise NotImplementedError(_SPECTRAL)

    def jitted(self):
        raise NotImplementedError(_SPECTRAL)

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
