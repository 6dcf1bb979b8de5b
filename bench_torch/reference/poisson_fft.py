"""The periodic spectral Poisson solve of cuDecomp's Poisson example
(``examples/fortran/poisson/poisson.f90``) in plain ``torch``, in float64,
and its bfloat16 control.

On a periodic box of lengths ``L_d``, ``lap(u) = f - mean(f)`` with ``u``
of zero mean is solved in spectral space:

    u = irfftn(-rfftn(f - mean(f)) / |k|^2),   the zero mode 0,

with ``k_d = 2 pi m_d / L_d``, ``m_d`` the transform's integer
frequencies (X the real axis, its ``N_x // 2 + 1`` frequencies
``0 .. N_x // 2``).  Fields are ``(X, Y, Z)``.  The whole box is
transformed at once: at 4096 x 256 x 256 its float64 field and spectrum
hold 2 GiB each.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from bench_torch.reference.fft_c2c import bf16_round
from bench_torch.reference.heat7 import _no_tf32

#: the FFT dims, the real axis (X) last, as ``rfftn`` halves its last dim
DIMS = (1, 2, 0)


def inv_k2(gdims: Sequence[int], lengths: Sequence[float], dtype,
           device) -> torch.Tensor:
    """``-1 / |k|^2`` over the half spectrum ``(X // 2 + 1, Y, Z)``, the
    zero mode 0, in ``dtype`` (computed in float64)."""
    nx, ny, nz = gdims
    k = [torch.fft.rfftfreq(nx, 1.0 / nx, dtype=torch.float64,
                            device=device),
         torch.fft.fftfreq(ny, 1.0 / ny, dtype=torch.float64, device=device),
         torch.fft.fftfreq(nz, 1.0 / nz, dtype=torch.float64, device=device)]
    kx, ky, kz = ((2.0 * math.pi / L) * m for m, L in zip(k, lengths))
    k2 = (kx * kx)[:, None, None] + (ky * ky)[None, :, None] \
        + (kz * kz)[None, None, :]
    k2[0, 0, 0] = 1.0
    k2.reciprocal_().neg_()
    k2[0, 0, 0] = 0.0
    return k2.to(dtype)


def solve(f: torch.Tensor, lengths: Sequence[float]) -> torch.Tensor:
    """``u`` for the right-hand side ``f``, in float64, on ``f``'s
    device."""
    with _no_tf32():
        g = f.to(torch.float64)
        g -= g.mean()
        fh = torch.fft.rfftn(g, dim=DIMS)
        del g
        fh *= inv_k2(f.shape, lengths, torch.float64, f.device)
        return torch.fft.irfftn(fh, s=[f.shape[d] for d in DIMS], dim=DIMS)


def control_solve(f: torch.Tensor, lengths: Sequence[float]) -> torch.Tensor:
    """The solve in float32 with every stored value rounded to bfloat16
    (the input, the centred input, the spectrum, the scale, the scaled
    spectrum and the output): a new float32 tensor of ``f``'s shape."""
    with _no_tf32():
        g = bf16_round(f.to(torch.float32))
        g = bf16_round(g - g.mean())
        fh = bf16_round(torch.fft.rfftn(g, dim=DIMS))
        del g
        s = bf16_round(inv_k2(f.shape, lengths, torch.float32, f.device))
        fh = bf16_round(fh * s)
        del s
        return bf16_round(torch.fft.irfftn(
            fh, s=[f.shape[d] for d in DIMS], dim=DIMS))
