"""Poisson solver on the pencil decomposition (``cudecomp_tpu.models.
poisson``), the analog of the reference's ``examples/fortran/poisson/
poisson.f90``.

:meth:`PoissonSolver.solve` solves ``lap(u) = f`` (periodic) by a forward
FFT, a multiply by ``-1/|k|^2`` (zero mode pinned to 0), or by the inverse
symbol of the discrete 7-point Laplacian, and an inverse FFT.  The scale
field is built once per solver in float64 (with the r2c halving and the
padded Z-pencil layout) and cast once per state dtype, so a complex64
spectrum stays complex64.  The solver's ``fused2`` pins its FFT plan's K5
policy (None: ``CUDECOMP_TPU_FFT_FUSED2``, read per call).  A solve is a
``poisson_solve`` span, which counts ``kernel``: the K5 launches it made
(2 for a ``split_complex`` solve that takes K5, 0 without it and on the
CPU, where K5's plain version runs).  The spectral multiply inside it is
a ``poisson_scale`` span, which counts ``bytes``: what its products read
and write.  :meth:`PoissonSolver.solve_cg` is the
matrix-free conjugate-gradient solve of the discrete equation, whose
matvec is one K4 stencil pass; it runs the public, resumable iteration
:meth:`PoissonSolver.cg_init` / :meth:`PoissonSolver.cg_iterate` on a
:class:`CGState`.

Each CG iteration is a ``cg_iter`` span holding, in order, ``cg_matvec``
(one K4 pass, ``1/h^2`` folded into its weights), ``cg_dot`` (``p .
Ap``), ``cg_update`` (alpha, ``u``, ``r`` and ``r . r``), ``cg_update``
(beta and ``p``) and, on the host check's iterations, ``cg_check`` (the
host read of ``r . r``).  On a CUDA state the dot and the two updates
are one C3 pass each (``ops/cg_kernel.py``; a state C3 cannot take
raises), on the CPU the formulas ``_cg_dot``, ``_cg_update`` and
``_cg_direction``.
``cg_iter`` counts ``kernel`` (1 where C3 ran, 0 on the formulas) and,
like the dot and the updates, ``bytes``: what their passes over the grid
read and write (a scalar's bytes left out), 13 vectors an iteration with
C3 and 24 on the formulas.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from cudecomp_tpu_torch.grid import GridDescriptor
from cudecomp_tpu_torch.ops import cg_kernel as C3
from cudecomp_tpu_torch.ops import dft2 as dft2_ops
from cudecomp_tpu_torch.ops.fft import DistributedFFT
from cudecomp_tpu_torch.parallel.collectives import all_reduce_grid
from cudecomp_tpu_torch.utils.tracing import PREFIX, trace_range


class CGState(NamedTuple):
    """A CG solve in progress (:meth:`PoissonSolver.cg_init`,
    :meth:`PoissonSolver.cg_iterate`).

    ``u``, ``r``, ``p``: the iterate, its recurrence residual and the
    search direction, this rank's X-pencil tensors; ``rs``: ``r . r`` over
    the grid, a 0-d tensor on the device; ``alpha``: the step length of
    the iteration that made the state (None at the start); ``it``: the
    iterations done; ``rs_host``: ``r . r`` as the host last read it
    (``|b|^2`` at the start); ``bnorm``: ``|b|``, read at the start."""
    u: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rs: torch.Tensor
    alpha: Optional[torch.Tensor]
    it: int
    rs_host: float
    bnorm: float

    @property
    def rel_residual(self) -> float:
        """``|r| / |b|`` at the host's last read."""
        return float(np.sqrt(self.rs_host)) / max(self.bnorm, 1e-300)


def _product_bytes(a: torch.Tensor, s: torch.Tensor) -> int:
    """Bytes ``a * s`` reads and writes, at the operands' element sizes
    (a plane that views a complex tensor is read at stride 2, which moves
    about twice its share)."""
    return (2 * a.numel() * a.element_size()
            + s.numel() * s.element_size())


def _guarded_div(num, den):
    """``num / den``, 0 where ``den`` is not positive: a state that
    converged between two host checks stays where it is."""
    ok = den > 0
    return torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)


@functools.lru_cache(maxsize=64)
def _cg_weights(op, mantissa: int) -> np.ndarray:
    """The CG matvec's 7-tap weights (``-lap_h``) as K4 takes them: faces
    ``-1/h_d^2``, the centre minus their sum.  ``op`` is ``1/h^2`` (a
    float) for uniform spacings, else ``1/h_d^2`` per memory dim;
    ``mantissa`` the bits of the precision K4 computes in (53 in
    float64, 24 otherwise).

    Each face is rounded to a multiple of a power of two ``q`` for which
    the centre stays below ``2^(mantissa - 1) q``: every weight, and
    every partial sum of them, is then exact in that precision, and the
    operator takes a constant field to exactly 0, as ``-lap_h`` does.
    Rounded each to its nearest float instead, the weights of a 1024^3
    box of side 2 pi miss by 0.0039 in float32 (centre 159364.44, faces
    -26560.74): the operator shifts by 0.4% of its smallest nonzero
    eigenvalue and the constant mode turns negative.  The rounding
    scales a uniform operator by at most ``12 * 2^-mantissa``."""
    inv = (op,) * 3 if isinstance(op, float) else op
    q = 2.0 ** (math.ceil(math.log2(2 * sum(inv))) + 1 - mantissa)
    w = np.zeros((3, 3, 3))
    for d in range(3):
        lo, hi = [1, 1, 1], [1, 1, 1]
        lo[d], hi[d] = 0, 2
        w[tuple(lo)] = w[tuple(hi)] = -round(inv[d] / q) * q
    w[1, 1, 1] = -w.sum()
    w.setflags(write=False)  # shared by every call through the cache
    return w


# The plain versions of C3's passes (``ops/cg_kernel.py``): the local
# parts of an iteration's vector work, in the order the kernel runs it.

def _cg_dot(p, ap):
    """``p . Ap``, this rank's part."""
    return torch.sum(p * ap)


def _cg_update(u, p, r, ap, rs, pap):
    """alpha, then ``u + alpha p``, ``r - alpha Ap`` and this rank's part
    of the new ``r . r``: ``(u, r, alpha, rr)``."""
    alpha = _guarded_div(rs, pap)
    u = u + alpha * p
    r = r - alpha * ap
    return u, r, alpha, torch.sum(r * r)


def _cg_direction(r, p, rs_new, rs):
    """beta, then ``r + beta p``."""
    return r + _guarded_div(rs_new, rs) * p


@dataclasses.dataclass(frozen=True)
class PoissonSolver:
    """Periodic Poisson solver: ``solve(f)`` returns u with ``lap(u) = f``
    and zero mean.  Works in complex (default) or split-complex mode; with
    ``real=True`` (the default) ``f`` is a real X-pencil tensor."""

    grid: GridDescriptor
    lengths: Tuple[float, float, float] = (2 * np.pi, 2 * np.pi, 2 * np.pi)
    real: bool = True
    split_complex: bool = False
    #: the FFT plan's K5 policy (:class:`DistributedFFT`'s ``fused2``):
    #: None leaves it to ``CUDECOMP_TPU_FFT_FUSED2``, read per call; True
    #: pins K5 for a ``split_complex`` solver wherever ``dft2_fits`` holds
    fused2: Optional[bool] = None
    # init=False: dataclasses.replace() must not carry a populated cache
    # into a solver with other parameters
    _cache: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False, init=False)

    @property
    def plan(self) -> DistributedFFT:
        return DistributedFFT(grid=self.grid, real=self.real,
                              split_complex=self.split_complex,
                              fused2=self.fused2)

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
            with trace_range(PREFIX + "poisson_scale",
                             bytes=2 * _product_bytes(rh, s)):
                planes = (rh * s, ih * s)
            return plan.inverse_planes(planes)
        fh = plan.forward(f)
        if self.split_complex:
            s = self._scale(discrete, fh.dtype)[..., None]
        else:
            s = self._scale(discrete, fh.real.dtype)
        with trace_range(PREFIX + "poisson_scale",
                         bytes=_product_bytes(fh, s)):
            fh = fh * s
        return plan.inverse(fh)

    def solve(self, f, discrete: bool = False):
        """``f``: this rank's X-pencil tensor on ``grid`` (real if
        ``real=True``; complex, or float with a trailing (re, im) dim of 2
        when ``split_complex``, if not).

        With ``discrete=True`` the scale is the inverse symbol of the
        discrete 7-point Laplacian instead of ``-1/|k|^2``: the result
        solves ``lap_h(u) = f`` exactly in one FFT pair."""
        with trace_range(PREFIX + "poisson_solve", kernel=0) as counts:
            n0 = dft2_ops.launch_count
            u = self._solve_with(self.plan, f, discrete)
            counts["kernel"] = dft2_ops.launch_count - n0
            return u

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

    def _cg_matvec(self):
        """The CG operator ``-lap_h``: one weighted 7-tap K4 pass, the
        ``1/h_d^2`` folded into its weights (:func:`_cg_weights`, for the
        precision of the vector it is given).  ``_cache["cg_op"]`` holds
        ``1/h^2`` (a float) for uniform spacings, else ``1/h_d^2`` per
        memory dim (stencil offsets are memory-dim offsets)."""
        from cudecomp_tpu_torch.ops.stencil import stencil_apply
        periods = (True, True, True)
        op = self._cache.get("cg_op")
        if op is None:
            cfg = self.grid.config
            hs = [self.lengths[d] / cfg.gdims[d] for d in range(3)]
            op = (1.0 / (hs[0] * hs[0]) if np.allclose(hs, hs[0]) else
                  tuple(1.0 / hs[d] ** 2 for d in cfg.mem_order(0)))
            self._cache["cg_op"] = op

        def matvec(v):
            # K4 sums in float64 for a float64 tensor, else in float32
            bits = 53 if v.dtype == torch.float64 else 24
            return stencil_apply(self.grid, v, _cg_weights(op, bits), 0,
                                 periods)
        return matvec

    def cg_init(self, f) -> CGState:
        """The state a CG solve of ``lap_h(u) = f`` starts from (see
        :meth:`solve_cg`): ``b = -(f - mean(f))``, ``u = 0``, ``r = p =
        b``, contiguous whatever the strides of ``f``.  Reads ``|b|`` on
        the host once."""
        b = (-(f - self._mean(f))).contiguous()
        rs = self._sum(b * b)
        bnorm = float(torch.sqrt(rs))
        return CGState(torch.zeros_like(b), b, b, rs, None, 0,
                       bnorm * bnorm, bnorm)

    def cg_iterate(self, state: CGState, check_every: int = 64) -> CGState:
        """One CG iteration from ``state``: the state after it.  Nothing
        of ``state`` is written, so a caller may keep it; ``alpha`` and
        ``rs`` are new 0-d tensors every iteration.

        The iteration enqueues its work without a host sync, except on
        iterations whose count is a multiple of ``check_every``: there the
        host reads ``r . r`` into ``rs_host`` (the ``cg_check`` span).
        ``alpha = (r . r) / (p . Ap)`` and ``beta`` are guarded
        divisions, so that a state that converged between two host checks
        stays where it is.  On a CUDA state the dot and the updates are
        C3's three passes (which raise on a state they cannot take), on the
        CPU their formulas."""
        matvec = self._cg_matvec()
        u, r, p, rs = state.u, state.r, state.p, state.rs
        fused = u.is_cuda
        dot, update, direction = ((C3.dot, C3.update, C3.direction)
                                  if fused else
                                  (_cg_dot, _cg_update, _cg_direction))
        v = p.numel() * p.element_size()
        # vectors read and written: the matvec 2; with C3 the dot 2, the
        # first update 6, the second 3; on the formulas a product and a
        # sum for the dot (4), two products, two sums and r * r with its
        # sum for the first update (13), a product and a sum for p (5)
        dot_v, update_v, dir_v = (2, 6, 3) if fused else (4, 13, 5)
        it, rs_host = state.it + 1, state.rs_host
        with trace_range(PREFIX + "cg_iter", kernel=int(fused),
                         bytes=(2 + dot_v + update_v + dir_v) * v):
            with trace_range(PREFIX + "cg_matvec"):
                ap = matvec(p)
            with trace_range(PREFIX + "cg_dot", bytes=dot_v * v):
                pap = all_reduce_grid(dot(p, ap), self.grid)
            with trace_range(PREFIX + "cg_update", bytes=update_v * v):
                u, r, alpha, rr = update(u, p, r, ap, rs, pap)
                del ap  # before p's pass allocates the new p
                rs_new = all_reduce_grid(rr, self.grid)
            with trace_range(PREFIX + "cg_update", bytes=dir_v * v):
                p = direction(r, p, rs_new, rs)
            if it % check_every == 0:
                with trace_range(PREFIX + "cg_check"):
                    rs_host = float(rs_new)
        return CGState(u, r, p, rs_new, alpha, it, rs_host, state.bnorm)

    def solve_cg(self, f, tol: float = 1e-8, maxiter: int = 1000,
                 check_every: int = 64):
        """Matrix-free conjugate-gradient solve of the DISCRETE 7-point
        Poisson equation ``lap_h(u) = f`` (periodic, zero mean) for this
        rank's X-pencil tensor ``f``: :meth:`cg_init`, then
        :meth:`cg_iterate` in chunks of ``check_every``.

        The matvec is one K4 stencil pass per iteration, the weighted
        7-tap stencil of ``-lap_h`` (``1/h_d^2`` per dim in its
        weights).  CG is valid
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
        check_every = max(1, min(int(check_every), int(maxiter)))
        with trace_range("cudecomp_tpu_torch.poisson_solve_cg"):
            state = self.cg_init(f)
            while state.it < maxiter:
                for _ in range(check_every):
                    state = self.cg_iterate(state, check_every)
                if np.sqrt(state.rs_host) <= tol * state.bnorm:
                    break
            return (state.u - self._mean(state.u), state.it,
                    state.rel_residual)
