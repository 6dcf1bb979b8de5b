"""One explicit RK4 step of cuDecomp's Taylor-Green solver
(``examples/cc/taylor_green/tg.cu``) in plain ``torch`` on
``torch.fft.rfftn``, and its bfloat16 control.

The velocity's spectral state ``uh`` is the unscaled r2c transform of the
velocity over a (X, Y, Z) grid on [0, 2 pi)^3, halved along X:
``(X // 2 + 1, Y, Z, 3)``, components last.  The right-hand side in
rotational form (``tg.cu:224-247``):

    rhs(uh) = P[ D F(u x w) ] - nu |k|^2 uh,   w = curl u,

with ``D`` the 2/3-rule dealiasing (``|k_d| < (2/3)(N_d / 2)`` on every
axis) with the mean mode removed, and ``P`` the Leray projection
``v - k (k . v) / |k|^2``.  RK4: ``k1 = rhs(u)``, ``k2 = rhs(u + dt/2 k1)``,
``k3 = rhs(u + dt/2 k2)``, ``k4 = rhs(u + dt k3)``,
``u + dt/6 (k1 + 2 k2 + 2 k3 + k4)``.
"""

from __future__ import annotations

import math

import torch

from bench_torch.reference.fft_c2c import bf16_round


class ExplicitRK4:
    """``step(uh, dt)`` in complex128 (``bf16=False``), or in complex64
    with every stored array rounded to bfloat16 (``bf16=True``, the
    control)."""

    def __init__(self, gdims, nu: float, device, bf16: bool = False):
        self.gdims = tuple(gdims)
        self.nu = nu
        self.bf16 = bf16
        real = torch.float32 if bf16 else torch.float64
        self.real = real
        ks = []
        for d, n in enumerate(self.gdims):
            k = torch.fft.fftfreq(n, d=1.0 / n, dtype=torch.float64,
                                  device=device)
            if d == 0:
                k = k[: n // 2 + 1]
            shape = [1, 1, 1]
            shape[d] = k.numel()
            ks.append(k.reshape(shape))
        k2 = ks[0] ** 2 + ks[1] ** 2 + ks[2] ** 2
        live = k2 > 0
        for k, n in zip(ks, self.gdims):
            live = live & (k.abs() < (2.0 / 3.0) * (n // 2))
        self.k = [k.to(real) for k in ks]
        self.k2 = k2.to(real)
        self.inv_k2 = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0),
                                  0.0).to(real)
        self.mask = live.to(real)

    def _r(self, t):
        return bf16_round(t) if self.bf16 else t

    def _irfft(self, sh):
        nx, ny, nz = self.gdims
        return self._r(torch.fft.irfftn(sh, s=(ny, nz, nx), dim=(1, 2, 0)))

    def _rfft(self, u):
        return self._r(torch.fft.rfftn(u, dim=(1, 2, 0)))

    def rhs(self, uh):
        kx, ky, kz = self.k
        c = [uh[..., i] for i in range(3)]
        u = [self._irfft(ci) for ci in c]
        w = [self._irfft(self._r(1j * (ky * c[2] - kz * c[1]))),
             self._irfft(self._r(1j * (kz * c[0] - kx * c[2]))),
             self._irfft(self._r(1j * (kx * c[1] - ky * c[0])))]
        nh = [self._rfft(self._r(u[(i + 1) % 3] * w[(i + 2) % 3]
                                 - u[(i + 2) % 3] * w[(i + 1) % 3]))
              for i in range(3)]
        del u, w
        nh = [self._r(self.mask * n) for n in nh]
        s = self._r(self.inv_k2 * (kx * nh[0] + ky * nh[1] + kz * nh[2]))
        out = torch.stack([self._r(nh[i] - self.k[i] * s) for i in range(3)],
                          dim=-1)
        del nh, s
        return self._r(out - (self.nu * self.k2)[..., None] * uh)

    def step(self, uh, dt: float):
        cdt = torch.complex64 if self.bf16 else torch.complex128
        uh = self._r(uh.to(cdt))
        k = self.rhs(uh)
        acc = self._r(uh + (dt / 6.0) * k)
        k = self.rhs(self._r(uh + (0.5 * dt) * k))
        acc = self._r(acc + (dt / 3.0) * k)
        k = self.rhs(self._r(uh + (0.5 * dt) * k))
        acc = self._r(acc + (dt / 3.0) * k)
        k = self.rhs(self._r(uh + dt * k))
        return self._r(acc + (dt / 6.0) * k)


def initial_velocity(gdims, shift, device, dtype=torch.float32):
    """The Taylor-Green vortex shifted by ``shift`` (radians per axis),
    (X, Y, Z, 3): ``u = cos x sin y sin z``, ``v = -sin x cos y sin z``,
    ``w = 0`` at ``x + shift[0]`` and so on (``tg.cu``'s initial state,
    translated)."""
    f = []
    for n, s in zip(gdims, shift):
        a = torch.arange(n, dtype=torch.float64, device=device)
        a = a * (2.0 * math.pi / n) + s
        f.append((torch.cos(a).to(dtype), torch.sin(a).to(dtype)))
    (cx, sx), (cy, sy), (cz, sz) = f
    u = cx[:, None, None] * sy[None, :, None] * sz[None, None, :]
    v = -sx[:, None, None] * cy[None, :, None] * sz[None, None, :]
    return torch.stack([u, v, torch.zeros_like(u)], dim=-1)
