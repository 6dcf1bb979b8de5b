"""One conjugate-gradient iteration for the periodic 7-point Poisson
equation in plain ``torch``, in float64, and its bfloat16 control.

The operator is the one CG solves for, ``A = -lap_h``:

    (A v)[i] = sum_d w_d (2 v[i] - v[i - e_d] - v[i + e_d]),  w_d = 1/h_d^2,

every index taken modulo the box's extent, ``h_d = L_d / N_d``, and the
right-hand side ``b = -(f - mean(f))``.  One iteration from the state
``(u, r, p, rs)``:

    alpha = rs / (p . A p),   u' = u + alpha p,   r' = r - alpha A p,
    rs' = r' . r',            beta = rs' / rs,    p' = r' + beta p,

alpha and beta 0 where their denominator is not positive.  Each
iteration lowers ``phi(u) = u . A u / 2 - b . u`` by ``alpha rs / 2``.

Fields are ``(X, Y, Z)``; everything is computed in x-blocks of
``block`` planes, each with its wrapped x neighbours
(``heat7._planes``), so that only a block is ever held in float64 beside
the fields.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from bench_torch.reference.fft_c2c import bf16_round
from bench_torch.reference.heat7 import _no_tf32, _planes

F64 = torch.float64


def weights(gdims: Sequence[int], lengths: Sequence[float]
            ) -> Tuple[float, float, float]:
    """``1 / h_d^2`` per dim."""
    return tuple((n / L) ** 2 for n, L in zip(gdims, lengths))


def _div(num: float, den: float) -> float:
    return num / den if den > 0 else 0.0


def _apply(e: torch.Tensor, w, r=lambda t: t) -> torch.Tensor:
    """``A`` on the inner planes of ``e`` (a block and its two x
    neighbours), each stored value passed through ``r``."""
    c = e[1:-1]
    out = w[0] * (2.0 * c - e[:-2] - e[2:])
    for dim in (1, 2):
        out = out + w[dim] * (2.0 * c - torch.roll(c, 1, dim)
                              - torch.roll(c, -1, dim))
    return r(out)


def _blocks(n: int, block: int):
    for x0 in range(0, n, block):
        yield x0, min(x0 + block, n)


def apply_blocks(v: torch.Tensor, w, block: int = 32):
    """Yield ``(x0, x1, Av)``: ``A v`` on planes ``x0:x1``, in float64."""
    with _no_tf32():
        for x0, x1 in _blocks(v.shape[0], block):
            yield x0, x1, _apply(_planes(v, x0, x1).to(F64), w)


def _dot(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.sum(a.to(F64) * b.to(F64)))


def mean(f: torch.Tensor) -> float:
    """The mean of ``f``, summed in float64."""
    return float(torch.sum(f, dtype=F64)) / f.numel()


def scalars(r: torch.Tensor, p: torch.Tensor, rs: float, w,
            block: int = 32) -> Tuple[float, float, float]:
    """``(alpha, beta, rs')`` of the iteration from ``(r, p, rs)``: two
    passes over the blocks of ``A p``."""
    pap = sum(_dot(p[x0:x1], ap) for x0, x1, ap in apply_blocks(p, w, block))
    alpha = _div(rs, pap)
    rs_new = 0.0
    for x0, x1, ap in apply_blocks(p, w, block):
        rs_new += float((r[x0:x1].to(F64) - alpha * ap).square().sum())
    return alpha, _div(rs_new, rs), rs_new


def increment_blocks(r: torch.Tensor, p: torch.Tensor, alpha: float,
                     beta: float, w, block: int = 32):
    """Yield ``(x0, x1, du, dr, dp)``: the iteration's increments of ``u``,
    ``r`` and ``p`` on planes ``x0:x1``, in float64, given its
    :func:`scalars`."""
    for x0, x1, ap in apply_blocks(p, w, block):
        p64 = p[x0:x1].to(F64)
        dr = -alpha * ap
        yield x0, x1, alpha * p64, dr, r[x0:x1].to(F64) + dr + (beta - 1) * p64


def iteration(u, r, p, rs: float, w, block: int = 32):
    """The whole iteration in float64 (tests, at small sizes):
    ``(u', r', p', rs', alpha)``."""
    alpha, beta, rs_new = scalars(r, p, rs, w, block)
    out = [t.to(F64).clone() for t in (u, r, p)]
    for x0, x1, *incs in increment_blocks(r, p, alpha, beta, w, block):
        for t, d in zip(out, incs):
            t[x0:x1] += d
    return (*out, rs_new, alpha)


def residual_and_energy(u: torch.Tensor, r: torch.Tensor, f: torch.Tensor,
                        w, block: int = 32) -> Tuple[float, float, float]:
    """``(|b - A u - r|, |b|, phi(u))`` in float64, ``b = -(f - mean(f))``:
    the gap between the true and the recurrence residual, the norm it is
    measured against, and the energy CG lowers."""
    m = mean(f)
    gap2 = bb = phi = 0.0
    for x0, x1, au in apply_blocks(u, w, block):
        b = m - f[x0:x1].to(F64)
        u64 = u[x0:x1].to(F64)
        gap2 += float((b - au - r[x0:x1]).square().sum())
        bb += float(b.square().sum())
        phi += float(torch.sum(u64 * (0.5 * au - b)))
    return math.sqrt(gap2), math.sqrt(bb), phi


def _rb(x: float) -> float:
    """``x`` rounded to bfloat16."""
    return float(torch.tensor(x, dtype=F64).to(torch.bfloat16))


def control_iteration(u, r, p, rs, w, block: int = 32):
    """The iteration in float32 with every stored value rounded to
    bfloat16 (the fields as read, ``A p``, each new field and each
    scalar): ``(u', r', p', rs', alpha)``, new float32 tensors of the
    fields' shape and 0-d float32 tensors on their device."""
    R = bf16_round

    def ap_blocks():
        with _no_tf32():
            for x0, x1 in _blocks(p.shape[0], block):
                yield x0, x1, _apply(R(_planes(p, x0, x1).float()), w, R)

    pap = _rb(sum(float(torch.sum(R(p[x0:x1].float()) * ap))
                  for x0, x1, ap in ap_blocks()))
    rs = _rb(float(rs))
    alpha = _rb(_div(rs, pap))
    un, rn, pn = (torch.empty(u.shape, dtype=torch.float32, device=u.device)
                  for _ in range(3))
    rs_new = 0.0
    for x0, x1, ap in ap_blocks():
        un[x0:x1] = R(R(u[x0:x1].float()) + R(alpha * R(p[x0:x1].float())))
        rn[x0:x1] = R(R(r[x0:x1].float()) - R(alpha * ap))
        rs_new += float(torch.sum(rn[x0:x1] * rn[x0:x1]))
    rs_new = _rb(rs_new)
    beta = _rb(_div(rs_new, rs))
    for x0, x1 in _blocks(p.shape[0], block):
        pn[x0:x1] = R(rn[x0:x1] + R(beta * R(p[x0:x1].float())))
    return (un, rn, pn,
            *(torch.tensor(x, dtype=torch.float32, device=u.device)
              for x in (rs_new, alpha)))
