"""Taylor-Green vortex: a pseudo-spectral incompressible Navier-Stokes
solver (``cudecomp_tpu.models.taylor_green``), the analog of the
reference's ``examples/cc/taylor_green/tg.cu``.

The equations in rotational form on the pencil decomposition,

    du/dt = P(k) F[u x w] - nu k^2 u_hat        (spectral space)

with 2/3-rule dealiasing and RK4 time stepping (integrating-factor IF-RK4
by default); the distributed r2c FFT does all the global data movement.
The three velocity components ride the FFT's trailing component dim.

Spectral state is a complex ``(..., 3)`` tensor, or with
``split_complex=True`` an ``(re, im)`` tuple of real ``(..., 3)``
tensors.  The spectral fields are built once per :meth:`setup` in the
real dtype of the state, so a complex64 state stays complex64.
Diagnostics (energy, dissipation, the shell spectrum) are sums over every
rank of the grid.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from cudecomp_tpu_torch.grid import GridDescriptor
from cudecomp_tpu_torch.ops.fft import DistributedFFT
from cudecomp_tpu_torch.ops.spectral import SpectralOperators
from cudecomp_tpu_torch.parallel.collectives import all_reduce_grid
from cudecomp_tpu_torch.utils.arrays import scatter_global
from cudecomp_tpu_torch.utils.tracing import trace_range


def taylor_green_velocity(gdims):
    """Initial TG vortex on [0, 2*pi)^3 (tg.cu initialization), as numpy
    arrays in natural [X, Y, Z] order."""
    xs = [np.arange(n) * 2 * np.pi / n for n in gdims]
    x, y, z = np.meshgrid(*xs, indexing="ij")
    u = np.cos(x) * np.sin(y) * np.sin(z)
    v = -np.sin(x) * np.cos(y) * np.sin(z)
    w = np.zeros_like(u)
    return u, v, w


@dataclasses.dataclass(frozen=True)
class TaylorGreenSolver:
    """``split_complex=True`` carries the spectral state as ``(re, im)``
    plane tuples through the plane-form FFT.

    ``integrating_factor`` (the default) integrates the viscous term
    exactly with exponential factors (Rogallo IF-RK4); otherwise the
    reference's explicit RK4 on the full right-hand side (``tg.cu:224-247``),
    whose viscous limit ``nu |k|^2 dt <~ 2.8`` shrinks with N^2."""

    grid: GridDescriptor
    nu: float = 1.0 / 100.0  # 1/Re
    dealias: bool = True
    split_complex: bool = False
    integrating_factor: bool = True

    # -- state helpers -----------------------------------------------------------

    @staticmethod
    def _t(fn, *xs):
        """``fn`` over the state: per plane of a plane tuple, else once."""
        if isinstance(xs[0], tuple):
            return tuple(fn(*parts) for parts in zip(*xs))
        return fn(*xs)

    def setup(self, dtype=None):
        """Returns ``(uh, fields)``: the spectral state of the initial
        vortex and the static fields dict.  ``dtype`` is the real dtype of
        the physical velocity: float32 on a CUDA grid and float64 on the
        CPU unless given."""
        if dtype is None:
            dtype = (torch.float32 if self.grid.device.type == "cuda"
                     else torch.float64)
        plan = DistributedFFT(grid=self.grid, real=True,
                              split_complex=self.split_complex)
        u = torch.stack([scatter_global(self.grid, c, 0)
                         for c in taylor_green_velocity(self.grid.config.gdims)],
                        dim=-1).to(dtype)
        uh = plan.forward_planes(u) if self.split_complex else plan.forward(u)
        sops = SpectralOperators(plan=plan, dtype=dtype)
        kx, ky, kz = sops.wavenumbers()
        k2 = sops.k_squared()
        live = k2 > 0  # the mean velocity is conserved
        if self.dealias:
            live = live & (sops.mask() > 0)
        fields = dict(kx=kx, ky=ky, kz=kz, k2=k2, mask=live.to(k2.dtype),
                      plan=plan, sops=sops)
        return uh, fields

    # -- spectral operators ----------------------------------------------------

    def _inverse(self, plan, xh):
        return (plan.inverse_planes(xh) if self.split_complex
                else plan.inverse(xh))

    def _forward(self, plan, x):
        return (plan.forward_planes(x) if self.split_complex
                else plan.forward(x))

    def _curl_hat(self, uh, f):
        return f["sops"].curl(uh)

    def _project(self, nh, f):
        """Dealiased Leray projection: ``m nh - k (k . m nh) / k^2``, ``m``
        the mask field (dealiasing and the mean mode), in one pass."""
        return f["sops"].project_solenoidal(nh, mask=f["mask"])

    def _nonlinear(self, uh, f):
        """Projected, dealiased nonlinear term ``u x omega``.

        Every field keeps the layout its producer gives it: the cross
        product writes into a tensor of ``u``'s layout (x innermost, a
        plane per component), which the forward FFT reads as it is, and the
        curl and the projection write theirs in the spectral state's (a
        plane per component).  An ``out=`` call has no backward, so this
        term does not differentiate."""
        plan: DistributedFFT = f["plan"]
        with trace_range("cudecomp_tpu_torch.tg_nonlinear"):
            u = self._inverse(plan, uh)               # physical velocity
            # each rebinding below frees the tensor it replaces
            with trace_range("cudecomp_tpu_torch.tg_curl"):
                w = self._curl_hat(uh, f)
            w = self._inverse(plan, w)                # vorticity
            with trace_range("cudecomp_tpu_torch.tg_cross"):
                nl = torch.linalg.cross(u, w, dim=-1,
                                        out=torch.empty_like(u))
            nh = self._forward(plan, nl)
            with trace_range("cudecomp_tpu_torch.tg_project"):
                return self._project(nh, f)

    def _rhs(self, uh, f):
        """Full explicit right-hand side: nonlinear term + viscous term."""
        visc = (self.nu * f["k2"])[..., None]
        return self._t(lambda nn, uu: nn - visc * uu,
                       self._nonlinear(uh, f), uh)

    def step(self, uh, f, dt):
        """One RK4 step in spectral space: IF-RK4 with
        ``integrating_factor``, else the explicit RK4 of ``tg.cu``."""
        with trace_range("cudecomp_tpu_torch.tg_step"):
            t = self._t
            if not self.integrating_factor:
                k1 = self._rhs(uh, f)
                k2_ = self._rhs(t(lambda u, k: u + 0.5 * dt * k, uh, k1), f)
                k3 = self._rhs(t(lambda u, k: u + 0.5 * dt * k, uh, k2_), f)
                k4 = self._rhs(t(lambda u, k: u + dt * k, uh, k3), f)
                return t(lambda u, a, b, c, d:
                         u + (dt / 6.0) * (a + 2 * b + 2 * c + d),
                         uh, k1, k2_, k3, k4)

            # IF-RK4: v = e^{nu k^2 t} u integrates dv/dt = e^{nu k^2 t} N(u);
            # E the half-step factor, E2 = E^2 the full step, computed as
            # exp(2x) as XLA computes the reference's E * E: squared in float32
            # E2 rounds twice, the same way every step
            x = -self.nu * f["k2"] * (0.5 * dt)
            e = torch.exp(x)[..., None]
            e2 = torch.exp(2.0 * x)[..., None]
            n = lambda v: self._nonlinear(v, f)
            k1 = n(uh)
            k2_ = n(t(lambda u, k: e * (u + 0.5 * dt * k), uh, k1))
            k3 = n(t(lambda u, k: e * u + 0.5 * dt * k, uh, k2_))
            k4 = n(t(lambda u, k: e2 * u + dt * e * k, uh, k3))
            return t(lambda u, a, b, c, d:
                     e2 * u + (dt / 6.0) * (e2 * a + 2 * e * (b + c) + d),
                     uh, k1, k2_, k3, k4)

    def cfl_dt(self, uh, f, cfl: float = 0.4):
        """Advective CFL timestep ``cfl * dx / max|u_i|`` (``tg.cu:759-772``),
        the max taken over every rank; a 0-d tensor."""
        u = self._inverse(f["plan"], uh)
        velmax = all_reduce_grid(torch.max(torch.abs(u)), self.grid,
                                 dist.ReduceOp.MAX)
        dx = 2.0 * np.pi / max(self.grid.config.gdims)
        return cfl * dx / torch.clamp(velmax, min=1e-30)

    # -- diagnostics -------------------------------------------------------------

    def _half_mean_square(self, x):
        n = float(np.prod(self.grid.config.gdims))
        return 0.5 * all_reduce_grid(torch.sum(x * x), self.grid) / n

    def energy(self, uh, f):
        """Kinetic energy ``0.5 <|u|^2>`` (padding is zero, so plain sums
        work); a 0-d tensor."""
        return self._half_mean_square(self._inverse(f["plan"], uh))

    def enstrophy(self, uh, f):
        return self._half_mean_square(
            self._inverse(f["plan"], self._curl_hat(uh, f)))

    def dissipation(self, uh, f):
        """Energy dissipation rate ``2 nu * enstrophy``."""
        return 2.0 * self.nu * self.enstrophy(uh, f)

    def spectrum(self, uh, f, nbins: int = None):
        """Shell-summed kinetic-energy spectrum ``E(k)`` (integer-|k|
        shells, r2c half-spectrum multiplicity): ``sum(E) == energy``."""
        return f["sops"].shell_spectrum(uh, nbins=nbins, comp=True)

    def run(self, n_steps: int, dt: float):
        """``(final uh, energy history)`` after ``n_steps`` steps."""
        uh, f = self.setup()
        history = [float(self.energy(uh, f))]
        for _ in range(n_steps):
            uh = self.step(uh, f, dt)
            history.append(float(self.energy(uh, f)))
        return uh, history
