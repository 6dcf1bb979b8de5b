"""Fractional-step finite-difference incompressible Navier-Stokes solver
(``cudecomp_tpu.models.incompressible``).

The reference library's production consumers are finite-difference CFD
codes that compose its primitives per timestep: halo exchanges for the
stencils, transposes for the pressure-Poisson solve.  This model is that
consumer:

  * advection + diffusion on collocated central differences, in one
    ghost-cell pass (:func:`~cudecomp_tpu_torch.ops.stencil.halo_map`,
    whose fns here change the trailing component dims);
  * an EXACT discrete Leray projection: ``div_h(grad_h)`` is diagonalized
    by the DFT with per-axis symbol ``-(sin(k_d h_d)/h_d)^2``, so one
    distributed FFT round trip projects the velocity to a discretely
    divergence-free field;
  * explicit RK2/RK4 time stepping on the projected right-hand side.

For the extruded 2D Taylor-Green vortex the discrete advection term is a
pure discrete gradient, so the projection removes it exactly and the
trajectory is the linear ODE ``du/dt = nu * lap7_h(u)``: the velocity
equals ``R(z)^n * u0`` (``R`` the RK stability polynomial, ``z`` the
discrete viscous eigenvalue times ``dt``) to roundoff.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from cudecomp_tpu_torch.grid import GridDescriptor
from cudecomp_tpu_torch.ops.fft import DistributedFFT
from cudecomp_tpu_torch.ops.spectral import SpectralOperators
from cudecomp_tpu_torch.ops.stencil import halo_map
from cudecomp_tpu_torch.parallel.collectives import all_reduce_grid
from cudecomp_tpu_torch.utils.arrays import scatter_global
from cudecomp_tpu_torch.utils.tracing import trace_range

_PERIODS = (True, True, True)
_TWO_PI = 2.0 * np.pi


def extruded_tg_velocity(gdims):
    """2D Taylor-Green vortex extruded in z on [0, 2*pi)^3: an exact
    Navier-Stokes solution (u, v decay as ``exp(-2 nu t)``, w = 0), and
    discretely divergence-free under central differences."""
    xs = [np.arange(n) * _TWO_PI / n for n in gdims]
    x, y, _ = np.meshgrid(*xs, indexing="ij")
    u = -np.cos(x) * np.sin(y)
    v = np.sin(x) * np.cos(y)
    return u, v, np.zeros_like(u)


def rk_stability(scheme: str, z: float) -> float:
    """Stability polynomial R(z) of the explicit scheme: the exact per-step
    amplification of a discrete eigenfield."""
    if scheme == "rk2":
        return 1.0 + z + z * z / 2.0
    if scheme == "rk4":
        return 1.0 + z + z**2 / 2.0 + z**3 / 6.0 + z**4 / 24.0
    raise ValueError(f"unknown scheme {scheme!r}")


@dataclasses.dataclass(frozen=True)
class ProjectionSolver:
    """Periodic incompressible NS solver on the pencil decomposition.

    State is the PHYSICAL velocity: this rank's X-pencil real tensor of
    shape ``grid.buffer_shape(0) + (3,)`` with components indexed by
    GLOBAL axis.  ``split_complex=True`` runs the pressure FFTs in
    plane-carried ``(re, im)`` form.
    """

    grid: GridDescriptor
    nu: float = 1.0 / 100.0
    lengths: Tuple[float, float, float] = (_TWO_PI, _TWO_PI, _TWO_PI)
    split_complex: bool = False
    scheme: str = "rk4"  # "rk2" | "rk4"

    def __post_init__(self):
        rk_stability(self.scheme, 0.0)  # validate early

    @property
    def plan(self) -> DistributedFFT:
        return DistributedFFT(grid=self.grid, real=True,
                              split_complex=self.split_complex)

    # -- static fields -----------------------------------------------------------

    def setup(self):
        """The static-fields dict: the FFT plan and the inverse symbol of
        the composed discrete ``div_h(grad_h)``,
        ``-1 / sum_d (sin(k_d h_d)/h_d)^2`` (float64) with every zero of
        the symbol (the mean mode and the pure-Nyquist corners, where the
        central-difference divergence itself vanishes) pinned to 0."""
        plan = self.plan
        cfg = self.grid.config
        sops = SpectralOperators(plan=plan, lengths=self.lengths,
                                 dtype=np.float64)
        s = None
        for g, k in enumerate(sops.wavenumbers()):
            h = self.lengths[g] / cfg.gdims[g]
            sk = torch.sin(k * h)
            # sin(k h) is exactly 0 at the mean and Nyquist modes, but the
            # float gives ~1e-16, which the s > 0 guard would pass and 1/s
            # blow up to ~1e32; the smallest true |sin| is sin(2 pi / n)
            sk = torch.where(sk.abs() < 1e-9, 0.0, sk)
            term = (sk / h) ** 2
            s = term if s is None else s + term
        inv_sym = torch.where(s > 0, -1.0 / torch.where(s > 0, s, 1.0), 0.0)
        return dict(plan=plan, inv_sym=inv_sym)

    def setup_tg(self, dtype=None):
        """``(u, fields)`` for the extruded-TG validation problem."""
        f = self.setup()
        comps = extruded_tg_velocity(self.grid.config.gdims)
        u = torch.stack([scatter_global(self.grid, c, 0) for c in comps],
                        dim=-1)
        if dtype is not None:
            u = u.to(dtype)
        return u, f

    # -- memory-order helpers ----------------------------------------------------

    def _mem(self):
        """Per-memory-dim grid spacings, and the memory order."""
        cfg = self.grid.config
        order = cfg.mem_order(0)
        hs = tuple(self.lengths[order[d]] / cfg.gdims[order[d]]
                   for d in range(3))
        return hs, order

    @staticmethod
    def _shifts(ue, d):
        """(+1, -1) shifted interior views of the extended block along
        memory dim ``d`` (interior slices in the other spatial dims)."""
        sl_hi = [slice(1, -1)] * 3
        sl_lo = [slice(1, -1)] * 3
        sl_hi[d] = slice(2, None)
        sl_lo[d] = slice(0, -2)
        return ue[tuple(sl_hi)], ue[tuple(sl_lo)]

    # -- spatial operators (one ghost-cell pass each) -----------------------------

    def divergence(self, u):
        """Central-difference divergence of an X-pencil velocity field."""
        hs, order = self._mem()

        def fn(ue):
            out = None
            for d in range(3):
                up, um = self._shifts(ue[..., order[d]], d)
                term = (up - um) * (0.5 / hs[d])
                out = term if out is None else out + term
            return out

        with trace_range("cudecomp_tpu_torch.ns_divergence"):
            return halo_map(self.grid, u, fn, 0, 1, _PERIODS)

    def gradient(self, p):
        """Central-difference gradient of an X-pencil scalar, components in
        GLOBAL axis order."""
        hs, order = self._mem()
        inv = {order[d]: d for d in range(3)}

        def fn(pe):
            comps = []
            for g in range(3):
                d = inv[g]
                up, um = self._shifts(pe, d)
                comps.append((up - um) * (0.5 / hs[d]))
            return torch.stack(comps, dim=-1)

        with trace_range("cudecomp_tpu_torch.ns_gradient"):
            return halo_map(self.grid, p, fn, 0, 1, _PERIODS)

    def advection_diffusion(self, u):
        """``nu * lap7_h(u) - (u . grad_h) u`` in one ghost-cell pass (all
        three components exchanged together on the trailing dim)."""
        hs, order = self._mem()
        nu = self.nu

        def fn(ue):
            c = ue[1:-1, 1:-1, 1:-1, :]
            out = None
            for d in range(3):
                up, um = self._shifts(ue, d)
                h = hs[d]
                dud = (up - um) * (0.5 / h)               # d(u)/dx_g
                adv = c[..., order[d]][..., None] * dud   # u_g * d(u)/dx_g
                lap = (up - 2.0 * c + um) * (1.0 / (h * h))
                term = nu * lap - adv
                out = term if out is None else out + term
            return out

        with trace_range("cudecomp_tpu_torch.ns_adv_diff"):
            return halo_map(self.grid, u, fn, 0, 1, _PERIODS)

    # -- projection ---------------------------------------------------------------

    @staticmethod
    def _inv_sym(f, dtype):
        """``f["inv_sym"]`` in ``dtype``, cast once and kept in ``f``."""
        key = ("inv_sym", dtype)
        if key not in f:
            f[key] = f["inv_sym"].to(dtype)
        return f[key]

    def pressure(self, div, f):
        """Solve ``div_h(grad_h phi) = div`` by one distributed FFT round
        trip (the composed operator's exact spectral inverse)."""
        plan: DistributedFFT = f["plan"]
        with trace_range("cudecomp_tpu_torch.ns_pressure"):
            if self.split_complex:
                rh, ih = plan.forward_planes(div)
                s = self._inv_sym(f, rh.dtype)
                return plan.inverse_planes((rh * s, ih * s))
            dh = plan.forward(div)
            return plan.inverse(dh * self._inv_sym(f, dh.real.dtype))

    def leray(self, v, f):
        """Discrete Leray projection ``v - grad_h phi`` with
        ``div_h(grad_h phi) = div_h v``: the result's central-difference
        divergence is zero to roundoff."""
        phi = self.pressure(self.divergence(v), f)
        return v - self.gradient(phi)

    def rhs(self, u, f):
        """Projected right-hand side ``P_h(nu lap u - (u.grad)u)``."""
        return self.leray(self.advection_diffusion(u), f)

    # -- time stepping ------------------------------------------------------------

    def step(self, u, f, dt):
        """One explicit RK step on the projected RHS; every stage is
        projected, so the velocity stays discretely divergence-free."""
        r = lambda v: self.rhs(v, f)
        if self.scheme == "rk2":  # Heun
            k1 = r(u)
            k2 = r(u + dt * k1)
            return u + (dt / 2.0) * (k1 + k2)
        k1 = r(u)
        k2 = r(u + 0.5 * dt * k1)
        k3 = r(u + 0.5 * dt * k2)
        k4 = r(u + dt * k3)
        return u + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)

    def run_scan(self, u, f, n_steps: int, dt: float):
        """``n_steps`` steps (the JAX package's ``lax.scan`` form)."""
        for _ in range(n_steps):
            u = self.step(u, f, dt)
        return u

    # -- diagnostics --------------------------------------------------------------

    def energy(self, u):
        """Kinetic energy ``0.5 <|u|^2>`` over every rank; a 0-d tensor."""
        n = float(np.prod(self.grid.config.gdims))
        return 0.5 * all_reduce_grid(torch.sum(u * u), self.grid) / n

    def max_divergence(self, u):
        """``max |div_h u|`` over every rank: the projection-exactness
        diagnostic; a 0-d tensor."""
        return all_reduce_grid(torch.max(torch.abs(self.divergence(u))),
                               self.grid, dist.ReduceOp.MAX)

    def viscous_eigenvalue(self, kvec=(1, 1, 0)) -> float:
        """Discrete 7-point viscous decay rate of a trig eigenfield with
        integer wavenumbers ``kvec``: ``-nu * sum_d (4/h_d^2)
        sin^2(k_d h_d / 2)``."""
        cfg = self.grid.config
        lam = 0.0
        for g in range(3):
            h = self.lengths[g] / cfg.gdims[g]
            lam += (4.0 / (h * h)) * np.sin(kvec[g] * h / 2.0) ** 2
        return -self.nu * lam
