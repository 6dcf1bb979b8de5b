"""The c2c 3D FFT in plain ``torch``: the complex128 spectrum of a field
held in slabs, and its bfloat16 control.

The field is given in global (X, Y, Z) order (a view of a pencil), split
over ``world`` ranks along Z (an X-pencil of a (1, P) process grid; P = 1
holds the whole field).  The spectrum is produced in the slabs of a
Z-pencil of the same grid: this rank's Y-slab, all of X and Z, in chunks
along X, so that no full complex128 copy of the spectrum is ever held:

1. ``A = fft2`` over (X, Y) of each Z-chunk of the field, in complex128;
2. per X-chunk, each rank's Y-slab of ``A`` goes to that rank
   (``torch.distributed.all_to_all_single`` where ``world > 1``), and the
   FFT along Z of the Z-planes gathered in rank order is the chunk of the
   spectrum.

Normalisation is ``torch.fft``'s default: the forward is unscaled.
"""

from __future__ import annotations

import torch


def _c128(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.complex128)


def spectrum_chunks(x_nat: torch.Tensor, world: int = 1, group=None,
                    z_chunk: int = 64, x_chunk: int = 128):
    """Yield ``(lo, hi, s)``: ``s`` is the complex128 spectrum at X indices
    ``lo:hi`` of this rank's Z-pencil slab (all of its Y-slab and of Z).
    ``x_nat``: this rank's field, (X, Y, Z / world), in global order."""
    nx, ny, nzl = x_nat.shape
    if ny % world:
        raise ValueError(f"Y extent {ny} does not split over {world} ranks")
    a = torch.empty((nx, ny, nzl), dtype=torch.complex128,
                    device=x_nat.device)
    for z0 in range(0, nzl, z_chunk):
        z1 = min(z0 + z_chunk, nzl)
        a[:, :, z0:z1] = torch.fft.fft2(_c128(x_nat[:, :, z0:z1]), dim=(0, 1))
    nyl = ny // world
    for x0 in range(0, nx, x_chunk):
        x1 = min(x0 + x_chunk, nx)
        if world == 1:
            planes = a[x0:x1]
        else:
            send = torch.stack([a[x0:x1, r * nyl:(r + 1) * nyl]
                                for r in range(world)])
            recv = torch.empty_like(send)
            torch.distributed.all_to_all_single(
                torch.view_as_real(recv), torch.view_as_real(send),
                group=group)
            del send
            planes = torch.cat(list(recv.unbind(0)), dim=2)
            del recv
        yield x0, x1, torch.fft.fft(planes, dim=2)


# -- the control: the same transform, every stored value in bfloat16 ----------

def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` with every real component rounded to bfloat16 and widened
    back (complex or real)."""
    if t.is_complex():
        r = torch.view_as_real(t).to(torch.bfloat16).to(torch.float32)
        return torch.view_as_complex(r.contiguous())
    return t.to(torch.bfloat16).to(torch.float32)


def _exchange(t: torch.Tensor, split: int, join: int, world: int,
              group) -> torch.Tensor:
    """Block r of ``t`` along dim ``split`` to rank r; the blocks received
    joined along dim ``join`` in rank order."""
    if world == 1:
        return t
    n = t.shape[split] // world
    send = torch.stack([t.narrow(split, r * n, n) for r in range(world)])
    recv = torch.empty_like(send)
    torch.distributed.all_to_all_single(torch.view_as_real(recv),
                                        torch.view_as_real(send), group=group)
    return torch.cat(list(recv.unbind(0)), dim=join)


def control_forward(x_nat: torch.Tensor, world: int = 1,
                    group=None) -> torch.Tensor:
    """The forward transform, axis by axis in complex64, each stage's
    input and output stored in bfloat16: from this rank's (X, Y, Z / P)
    field to its (X, Y / P, Z) spectrum, contiguous."""
    s = bf16_round(x_nat.contiguous())
    for d in (0, 1):
        s = bf16_round(torch.fft.fft(s, dim=d))
    s = _exchange(s, 1, 2, world, group)
    return bf16_round(torch.fft.fft(s, dim=2))


def control_inverse(s_nat: torch.Tensor, world: int = 1,
                    group=None) -> torch.Tensor:
    """The inverse of :func:`control_forward` (scaled by 1/N), stored in
    bfloat16 between stages: back to this rank's (X, Y, Z / P) field."""
    x = bf16_round(torch.fft.ifft(bf16_round(s_nat), dim=2))
    x = _exchange(x, 2, 1, world, group)
    for d in (1, 0):
        x = bf16_round(torch.fft.ifft(x, dim=d))
    return x
