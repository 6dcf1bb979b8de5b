"""Spectral operators on the distributed FFT's Z-pencil layout
(``cudecomp_tpu.ops.spectral``).

Wavenumber fields, per-axis derivatives, gradient, divergence, curl,
Laplacian, 2/3-rule dealiasing, the Leray projection and the shell
spectrum, on a :class:`~cudecomp_tpu_torch.ops.fft.DistributedFFT` plan's
spectral state in either convention: complex tensors, or ``(re, im)``
plane tuples of real tensors when the plan is ``split_complex``.  Vector
fields stack their components on the LAST dim (``(..., 3)``).

Every operator multiplies this rank's spectral block by wavenumber
fields.  The wavenumbers are kept in BROADCAST form: per global axis, a
tensor with this rank's padded extent along the Z-pencil dim of that axis
and 1 elsewhere, which lines each k value up with the valid region of the
rank's block (padding rows meet the state's zero tails).  The wavenumbers
are built in float64 numpy on the host, once per
:class:`SpectralOperators`; the ``|k|^2``, ``1/|k|^2`` and mask fields
are built on the device at first use and cached (PyTorch runs eagerly, so
there is no trace to fuse them into).

A k-derived field is cast to the real dtype of the state it multiplies:
float64 times complex64 would promote the state to complex128.

The curl and the (optionally masked) Leray projection return a state of
the input's layout (``torch.empty_like`` of the tensor, or of each plane
of a plane pair), so the component planes the FFT returns stay planes.
On a CUDA state (complex64 or complex128, or a pair of float32 or float64
planes) each is one pass of C2
(:mod:`~cudecomp_tpu_torch.ops.spectral_kernel`), under autograd too; a
CPU state takes the formulas here, which define the result.  Each call is
a ``cudecomp_tpu_torch.curl`` or ``cudecomp_tpu_torch.project_solenoidal``
trace range with the counts of :func:`spectral_kernel.counts`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from cudecomp_tpu_torch import geometry
from cudecomp_tpu_torch.ops import spectral_kernel
from cudecomp_tpu_torch.ops.fft import DistributedFFT
from cudecomp_tpu_torch.parallel.collectives import all_reduce_grid
from cudecomp_tpu_torch.utils.arrays import scatter_global
from cudecomp_tpu_torch.utils.tracing import trace_range

__all__ = ["SpectralOperators", "wavenumber_fields", "wavenumber_broadcasts",
           "dealias_axis_broadcasts", "dealias_mask"]


def _axis_wavenumbers(plan: DistributedFFT, lengths):
    """Host-side per-axis wavenumber vectors of the plan's spectral grid
    (r2c halving applied to axis 0 when the plan is real)."""
    gd = plan.grid.config.gdims
    ks = []
    for d in range(3):
        n = gd[d]
        k = np.fft.fftfreq(n, d=1.0 / n) * (2.0 * np.pi / lengths[d])
        if plan.real and d == 0:
            k = k[: n // 2 + 1]
        ks.append(k)
    return ks


def _np_dtype(dtype):
    """A numpy dtype from a numpy or torch dtype (float64 for None)."""
    if dtype is None:
        return np.dtype(np.float64)
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def wavenumber_fields(plan: DistributedFFT, lengths=(2 * math.pi,) * 3,
                      dtype=None) -> Tuple[torch.Tensor, ...]:
    """This rank's ``(kx, ky, kz)`` fields in the plan's spectral Z-pencil
    layout, materialized.  ``lengths`` are the physical domain lengths per
    axis (``2*pi`` gives unit wavenumber spacing)."""
    cgrid = plan.complex_grid
    ks = _axis_wavenumbers(plan, lengths)
    kx, ky, kz = np.meshgrid(*ks, indexing="ij")
    dt = _np_dtype(dtype)
    return tuple(scatter_global(cgrid, a.astype(dt), 2) for a in (kx, ky, kz))


def _padded_axis_vector(cgrid, values: np.ndarray, g: int) -> np.ndarray:
    """Lay a per-global-index vector out along global axis ``g`` of the
    spectral Z-pencil's padded format: per-shard ``[valid | zero tail]``
    blocks concatenated in shard order (the 1D twin of
    :func:`~cudecomp_tpu_torch.utils.arrays.scatter_global`).  Shard ``s``
    owns ``out[s * local:(s + 1) * local]``."""
    cfg = cgrid.config
    order = cfg.mem_order(2)
    i = order.index(g)
    local = geometry.pencil_buffer_shape(cfg, 2, None, None)[i]
    pd = geometry.shard_pdim_of_dim(2, g)
    nshards = cfg.pdims[pd] if pd is not None else 1
    out = np.zeros(local * nshards, dtype=values.dtype)
    for s in range(nshards):
        pidx = (s, 0) if pd == 0 else ((0, s) if pd == 1 else (0, 0))
        pinfo = geometry.get_pencil_info(cfg, 2, pidx, None, None)
        lo, hi = pinfo.lo_g[g], pinfo.hi_g[g]
        out[s * local: s * local + (hi - lo + 1)] = values[lo: hi + 1]
    return out


def _local_broadcast(cgrid, values: np.ndarray, g: int) -> torch.Tensor:
    """This rank's block of the padded axis vector of global axis ``g``,
    shaped to broadcast along the Z-pencil dim holding ``g``."""
    cfg = cgrid.config
    order = cfg.mem_order(2)
    vec = _padded_axis_vector(cgrid, values, g)
    pd = geometry.shard_pdim_of_dim(2, g)
    local = geometry.pencil_buffer_shape(cfg, 2, None, None)[order.index(g)]
    s = cgrid.coords[pd] if pd is not None else 0
    shape = [1, 1, 1]
    shape[order.index(g)] = local
    return torch.as_tensor(vec[s * local:(s + 1) * local],
                           device=cgrid.device).reshape(shape)


def wavenumber_broadcasts(plan: DistributedFFT, lengths=(2 * math.pi,) * 3,
                          dtype=None) -> Tuple[torch.Tensor, ...]:
    """``(kx, ky, kz)`` in broadcast form: each has this rank's padded
    extent along the Z-pencil dim of its global axis and 1 elsewhere.
    Broadcasting against spectral state reproduces
    :func:`wavenumber_fields` exactly (padded layout included)."""
    cgrid = plan.complex_grid
    ks = _axis_wavenumbers(plan, lengths)
    dt = _np_dtype(dtype)
    return tuple(_local_broadcast(cgrid, ks[g].astype(dt), g)
                 for g in range(3))


def dealias_axis_broadcasts(plan: DistributedFFT, fraction: float = 2.0 / 3.0,
                            lengths=(2 * math.pi,) * 3, dtype=None):
    """Per-axis dealias indicator vectors in broadcast form; their product
    is the sharp 2/3-rule mask of :func:`dealias_mask`."""
    cgrid = plan.complex_grid
    gd = plan.grid.config.gdims
    ks = _axis_wavenumbers(plan, lengths)
    dt = _np_dtype(dtype)
    out = []
    for g in range(3):
        cut = fraction * (gd[g] // 2) * (2.0 * np.pi / lengths[g])
        out.append(_local_broadcast(cgrid, (np.abs(ks[g]) < cut).astype(dt),
                                    g))
    return tuple(out)


def dealias_mask(plan: DistributedFFT, fraction: float = 2.0 / 3.0,
                 lengths=(2 * math.pi,) * 3, dtype=None) -> torch.Tensor:
    """Sharp cutoff mask (the 2/3 rule by default), materialized: 1 where
    ``|k_d| < fraction * (N_d/2) * (2*pi/L_d)`` on every axis, 0 outside
    (``tg.cu`` applies the same rule inline)."""
    cgrid = plan.complex_grid
    gd = plan.grid.config.gdims
    ks = _axis_wavenumbers(plan, lengths)
    kx, ky, kz = np.meshgrid(*ks, indexing="ij")
    mask = np.ones(kx.shape, dtype=bool)
    for k, n, L in zip((kx, ky, kz), gd, lengths):
        mask &= np.abs(k) < fraction * (n // 2) * (2.0 * np.pi / L)
    return scatter_global(cgrid, mask.astype(_np_dtype(dtype)), 2)


def _real_dtype(a: torch.Tensor) -> torch.dtype:
    return a.dtype.to_real()


@dataclasses.dataclass(frozen=True)
class SpectralOperators:
    """Planned spectral calculus over a :class:`DistributedFFT`.

    Operators take and return SPECTRAL state in the plan's convention
    (complex tensors, or ``(re, im)`` plane tuples when the plan is
    ``split_complex``), with vector components stacked on the last dim.
    ``dtype`` (of the fields; numpy or torch) defaults to float32 for
    split-complex plans and float64 otherwise, as in the JAX package.
    Fields are cast to the real dtype of the state they multiply.
    """

    plan: DistributedFFT
    lengths: Tuple[float, float, float] = (2 * math.pi,) * 3
    dtype: object = None
    _cache: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False, init=False)

    # -- cached fields -----------------------------------------------------------

    def _dtype(self) -> np.dtype:
        if self.dtype is not None:
            return _np_dtype(self.dtype)
        return np.dtype(np.float32 if self.plan.split_complex
                        else np.float64)

    def _cached(self, key, build):
        got = self._cache.get(key)
        if got is None:
            got = build()
            self._cache[key] = got
        return got

    def wavenumbers(self):
        """``(kx, ky, kz)`` in broadcast form (see
        :func:`wavenumber_broadcasts`)."""
        return self._cached("k", lambda: wavenumber_broadcasts(
            self.plan, self.lengths, dtype=self._dtype()))

    def k_squared(self):
        """``|k|^2`` over this rank's spectral block."""
        def build():
            kx, ky, kz = self.wavenumbers()
            return kx * kx + ky * ky + kz * kz
        return self._cached("k2", build)

    def inv_k_squared(self):
        """``1/|k|^2`` with the zero mode pinned to 0 (the Leray and
        Poisson scaling field)."""
        def build():
            k2 = self.k_squared()
            return torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0),
                               0.0)
        return self._cached("inv_k2", build)

    def mask(self, fraction: float = 2.0 / 3.0):
        """Dealias mask for ``fraction``: the product of the per-axis
        broadcast indicator vectors."""
        def build():
            mx, my, mz = dealias_axis_broadcasts(
                self.plan, fraction, self.lengths, dtype=self._dtype())
            return mx * my * mz
        return self._cached(("mask", fraction), build)

    # -- state algebra -----------------------------------------------------------
    # spectral scalar state: a complex tensor, or an (re, im) tuple

    def _split(self) -> bool:
        return self.plan.split_complex

    @staticmethod
    def _t(fn, *xs):
        """``fn`` over the state: per plane of a plane tuple, else once."""
        if isinstance(xs[0], tuple):
            return tuple(fn(*parts) for parts in zip(*xs))
        return fn(*xs)

    def _mul_i(self, s):
        """``i * s`` on spectral state."""
        if self._split():
            return (-s[1], s[0])
        return 1j * s

    def _kmul(self, k, s, comp: bool = False):
        """Real field ``k`` times state ``s`` (``comp=True`` when ``s``
        carries a trailing component dim for ``k`` to broadcast over)."""
        kk = k[..., None] if comp else k
        return self._t(lambda a: kk.to(_real_dtype(a)) * a, s)

    def _comp(self, vh, c: int):
        return self._t(lambda a: a[..., c], vh)

    def _stack(self, comps, like=None):
        """Components onto the last dim: stacked, or written into
        ``torch.empty_like(like)`` (of each plane of a plane pair), which
        keeps ``like``'s layout (the copies are differentiable)."""
        if like is None:
            if self._split():
                return tuple(torch.stack([c[j] for c in comps], dim=-1)
                             for j in (0, 1))
            return torch.stack(comps, dim=-1)

        def fill(like, comps):
            out = torch.empty_like(like)
            for c, x in enumerate(comps):
                out[..., c] = x
            return out

        if self._split():
            return tuple(fill(like[j], [c[j] for c in comps])
                         for j in (0, 1))
        return fill(like, comps)

    # -- operators ---------------------------------------------------------------

    def derivative(self, sh, axis: int, order: int = 1):
        """``(d/dx_axis)^order`` of scalar spectral state: multiply by
        ``(i k_axis)^order``."""
        k = self.wavenumbers()[axis]
        out = self._kmul(k ** order, sh)
        for _ in range(order % 4):
            out = self._mul_i(out)
        return out

    def gradient(self, sh):
        """Scalar spectral state -> ``(..., 3)`` vector spectral state."""
        ks = self.wavenumbers()
        return self._stack([self._mul_i(self._kmul(ks[d], sh))
                            for d in range(3)])

    def divergence(self, vh):
        """``(..., 3)`` vector spectral state -> scalar spectral state."""
        ks = self.wavenumbers()
        acc = None
        for d in range(3):
            term = self._kmul(ks[d], self._comp(vh, d))
            acc = term if acc is None else self._t(torch.add, acc, term)
        return self._mul_i(acc)

    def curl(self, vh):
        """``(..., 3)`` vector spectral state -> ``(..., 3)`` curl ``i k x
        v``, in ``vh``'s layout: C2 where it takes the state
        (:func:`spectral_kernel.takes`), else :meth:`_curl_formula`."""
        with trace_range("cudecomp_tpu_torch.curl",
                         **spectral_kernel.counts(vh)):
            if spectral_kernel.takes(vh):
                return spectral_kernel.curl(vh, self.wavenumbers())
            return self._curl_formula(vh)

    def _curl_formula(self, vh):
        """The plain version of :meth:`curl`."""
        kx, ky, kz = self.wavenumbers()
        sub = lambda a, b: self._t(torch.sub, a, b)
        v0, v1, v2 = (self._comp(vh, c) for c in range(3))
        wx = sub(self._kmul(ky, v2), self._kmul(kz, v1))
        wy = sub(self._kmul(kz, v0), self._kmul(kx, v2))
        wz = sub(self._kmul(kx, v1), self._kmul(ky, v0))
        return self._stack([self._mul_i(w) for w in (wx, wy, wz)], like=vh)

    def laplacian(self, sh, comp: bool = False):
        """``lap = -|k|^2`` on scalar (or, with ``comp=True``, per-component
        vector) spectral state."""
        return self._kmul(-self.k_squared(), sh, comp=comp)

    def dealias(self, sh, fraction: float = 2.0 / 3.0, comp: bool = False):
        """Apply the sharp 2/3-rule mask to spectral state."""
        return self._kmul(self.mask(fraction), sh, comp=comp)

    def shell_spectrum(self, sh, nbins: int = None, comp: bool = False):
        """Shell-summed power spectrum ``E(k)`` of spectral state, summed
        over every rank of the plan's grid.

        Bins ``0.5 |sh|^2 / N^2`` into integer shells of ``|k| / k_min``
        (``k_min`` the smallest axis fundamental).  Real (r2c) plans apply
        the half-spectrum multiplicity (2 for interior ``k_x`` planes, 1
        for the ``k_x = 0`` and Nyquist planes), so ``sum(E) == 0.5 *
        mean(|u|^2)`` to roundoff.  With ``comp=True`` the trailing
        component dim is summed first.  Shells at or past ``nbins`` are
        dropped, as ``jax.ops.segment_sum`` drops them."""
        gd = self.plan.grid.config.gdims
        k_min = min(2.0 * np.pi / L for L in self.lengths)
        if nbins is None:
            kmax2 = sum(((g // 2) * 2.0 * np.pi / L) ** 2
                        for g, L in zip(gd, self.lengths))
            nbins = int(np.ceil(np.sqrt(kmax2) / k_min)) + 2
        kx = self.wavenumbers()[0]
        k2 = self.k_squared()
        shell = torch.round(torch.sqrt(k2) / k_min).to(torch.int64)
        if self.plan.real:
            mult = torch.where(kx == 0, 1.0, 2.0).to(k2.dtype)
            if gd[0] % 2 == 0:
                nyq = (gd[0] // 2) * (2.0 * np.pi / self.lengths[0])
                mult = torch.where(kx.abs() == nyq, 1.0, mult)
        else:
            mult = torch.ones_like(k2)
        if self._split():
            e = sh[0] * sh[0] + sh[1] * sh[1]
        else:
            e = sh.abs() ** 2
        if comp:
            e = torch.sum(e, dim=-1)
        n3 = float(np.prod(gd))
        dens = 0.5 * mult.to(e.dtype) * e / (n3 * n3)
        shell = shell.expand(dens.shape).reshape(-1)
        keep = shell < nbins
        out = torch.zeros(nbins, dtype=dens.dtype, device=dens.device)
        out.index_add_(0, shell[keep], dens.reshape(-1)[keep])
        return all_reduce_grid(out, self.plan.grid)

    def project_solenoidal(self, vh, mask=None):
        """Leray projection ``v - k (k . v)/|k|^2``: removes the
        compressible part of a ``(..., 3)`` vector spectral state, in
        ``vh``'s layout.  ``mask``, a real field broadcast against one
        component, multiplies ``vh`` first (``v = mask * vh``) in the same
        pass.  C2 where it takes the state (:func:`spectral_kernel.takes`),
        else :meth:`_project_formula`."""
        with trace_range("cudecomp_tpu_torch.project_solenoidal",
                         **spectral_kernel.counts(vh, mask)):
            if spectral_kernel.takes(vh):
                return spectral_kernel.project(vh, self.wavenumbers(), mask)
            return self._project_formula(vh, mask)

    def _project_formula(self, vh, mask=None):
        """The plain version of :meth:`project_solenoidal`."""
        if mask is not None:
            vh = self._kmul(mask, vh, comp=True)
        kx, ky, kz = self.wavenumbers()
        inv_k2 = self.inv_k_squared()
        add = lambda a, b: self._t(torch.add, a, b)
        sub = lambda a, b: self._t(torch.sub, a, b)
        v0, v1, v2 = (self._comp(vh, c) for c in range(3))
        div = add(add(self._kmul(kx, v0), self._kmul(ky, v1)),
                  self._kmul(kz, v2))
        s = self._kmul(inv_k2, div)
        return self._stack([sub(v0, self._kmul(kx, s)),
                            sub(v1, self._kmul(ky, s)),
                            sub(v2, self._kmul(kz, s))], like=vh)
