"""One explicit step of the 7-point heat equation on a periodic box in
plain ``torch``, and its bfloat16 control.

With unit grid spacing and time step ``dt``:

    u' = u + dt * (u[x-1] + u[x+1] + u[y-1] + u[y+1] + u[z-1] + u[z+1] - 6 u),

every index taken modulo the box's extent (all three dims periodic), as
the port's ``examples/heat3d_stencil.py`` steps its box.  The field is
``(X, Y, Z)``; the step is computed in x-blocks of ``block`` planes, each
with one wrapped plane on either side, so that only a block is ever held
in float64 beside the field.
"""

from __future__ import annotations

import contextlib

import torch

from bench_torch.reference.fft_c2c import bf16_round


@contextlib.contextmanager
def _no_tf32():
    """TF32 off for the block (nothing here multiplies matrices; the guard
    keeps a product added later exact in float32 and float64)."""
    cuda, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn


def _planes(u: torch.Tensor, x0: int, x1: int) -> torch.Tensor:
    """Planes ``x0 - 1 .. x1`` of ``u``, wrapped along X."""
    nx = u.shape[0]
    return torch.cat([u[(x0 - 1) % nx][None], u[x0:x1], u[x1 % nx][None]])


def _step(e: torch.Tensor, dt: float, r=lambda t: t) -> torch.Tensor:
    """The step of the inner planes of ``e`` (the block and its two x
    neighbours), each stored value passed through ``r``."""
    c = e[1:-1]
    faces = e[:-2] + e[2:]
    for dim in (1, 2):
        faces = faces + torch.roll(c, 1, dim) + torch.roll(c, -1, dim)
    lap = r(faces - 6.0 * c)
    return r(c + dt * lap)


def step_blocks(u: torch.Tensor, dt: float, block: int = 32):
    """Yield ``(x0, x1, v)``: ``v`` is the step of planes ``x0:x1`` of
    ``u``, in float64."""
    with _no_tf32():
        for x0 in range(0, u.shape[0], block):
            x1 = min(x0 + block, u.shape[0])
            yield x0, x1, _step(_planes(u, x0, x1).to(torch.float64), dt)


def step(u: torch.Tensor, dt: float, block: int = 32) -> torch.Tensor:
    """The whole step of ``u`` in float64 (tests, at small sizes)."""
    return torch.cat([v for _, _, v in step_blocks(u, dt, block)])


def control_step(u: torch.Tensor, dt: float, block: int = 32) -> torch.Tensor:
    """The step in float32 with every stored value rounded to bfloat16
    (the input, the Laplacian and the output): a new tensor of ``u``'s
    shape, in float32."""
    out = torch.empty(u.shape, dtype=torch.float32, device=u.device)
    with _no_tf32():
        for x0 in range(0, u.shape[0], block):
            x1 = min(x0 + block, u.shape[0])
            e = bf16_round(_planes(u, x0, x1).to(torch.float32))
            out[x0:x1] = _step(e, dt, bf16_round)
    return out
