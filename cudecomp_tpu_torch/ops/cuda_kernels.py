"""K1, the local-permute kernel: a tiled 2D transpose in CUDA for Hopper.

Replaces ``cudecomp_tpu/ops/pallas_kernels.py``: ``pallas_transpose2d``
(the tiled VMEM transpose) and ``pallas_cyclic_permute`` (the cyclic 3D
permutes expressed as that transpose).  Source: ``csrc/transpose2d.cu``,
built by :mod:`cudecomp_tpu_torch.utils.cuda_build` at first use.

Why this shape fits the card: the transpose engine's slab path composes a
communication-free transpose into one cyclic permute, which is one 2D
transpose of an (I, J*K) or (I*J, K) view.  It computes nothing, so it is
bound by device-memory bandwidth: the least it can cost is one read and one
write of the tensor.  The kernel stages 32x32 tiles through shared memory
so both the reads and the writes are row-contiguous across a warp; making
each thread's access 16 bytes wide is work for later.

Dispatch: a tensor on the CPU takes the plain twin (``*_ref``), which
defines what the kernel computes.  A CUDA tensor launches the kernel or
raises; nothing falls back.  ``launch_count`` counts launches, so a run can
show that it went through the kernel.  :func:`cyclic_permute` is a
``torch.autograd.Function`` on both devices: its backward is the inverse
cyclic permute of the gradient, K1 again on a CUDA tensor.

Trailing dims beyond the transposed ones travel with each element, so a
complex tensor, a split-complex ``(..., 2)`` pair or a 3-component field is
moved whole.  The kernel copies an element raw as one or more words of 1,
2, 4, 8 or 16 bytes: the widest word that divides the element and the
tensors' addresses.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from cudecomp_tpu_torch.utils import cuda_build

SOURCES = ("transpose2d.cu",)
SIGNATURES = (
    ("cudecomp_transpose2d",
     (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
      ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p), ctypes.c_int),
)
CYCLIC_PERMS = ((1, 2, 0), (2, 0, 1))
WORD_BYTES = (16, 8, 4, 2, 1)

#: kernel launches since the last :func:`reset_launch_count`
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def _lib() -> ctypes.CDLL:
    return cuda_build.load("transpose2d", SOURCES, SIGNATURES)


def build() -> Path:
    """Compile (if needed) and load K1 (K0 probes it); returns the
    library's path."""
    _lib()
    return cuda_build.library_path("transpose2d",
                                   cuda_build.library_sources(SOURCES))


def element_bytes(x: torch.Tensor, lead: int) -> int:
    """Bytes of one moved element: the dtype times the trailing dims
    after the first ``lead`` dims."""
    return x.element_size() * math.prod(x.shape[lead:])


def word_bytes(eb: int, *ptrs: int) -> int:
    """The widest word K1 can move an element of ``eb`` bytes in: it must
    divide the element and every address."""
    return next(w for w in WORD_BYTES
                if eb % w == 0 and all(p % w == 0 for p in ptrs))


def _launch(x: torch.Tensor, out: torch.Tensor, M: int, N: int,
            lead: int) -> None:
    """Launch K1 on ``x`` viewed as (M, N, element) into ``out``."""
    global launch_count
    if x.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA tensors, got one on {x.device}")
    if not x.is_contiguous():
        raise ValueError("K1 takes contiguous input; call .contiguous() first")
    if x.numel() == 0:
        return
    eb = element_bytes(x, lead)
    wb = word_bytes(eb, x.data_ptr(), out.data_ptr())
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.cudecomp_transpose2d(x.data_ptr(), out.data_ptr(), M, N,
                                       wb, eb // wb, stream)
    if err != 0:
        msg = lib.cudecomp_cuda_error_string(err).decode()
        raise RuntimeError(f"K1 launch failed for ({M}, {N}) x {eb} bytes "
                           f"({eb // wb} words of {wb}): {msg} ({err})")
    launch_count += 1


def transpose2d_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`transpose2d`."""
    return x.transpose(0, 1).contiguous()


def transpose2d(x: torch.Tensor) -> torch.Tensor:
    """(M, N, *e) -> (N, M, *e) transpose (``pallas_transpose2d``); the
    trailing dims ``e`` move with each element."""
    if x.dim() < 2:
        raise ValueError(f"transpose2d needs >= 2 dims, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return transpose2d_ref(x)
    M, N = x.shape[:2]
    out = torch.empty((N, M) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    _launch(x, out, M, N, 2)
    return out


def cyclic_permute_ref(x: torch.Tensor, perm) -> torch.Tensor:
    """Plain twin of :func:`cyclic_permute`."""
    perm = tuple(perm)
    return x.permute(perm + tuple(range(3, x.dim()))).contiguous()


def cyclic_permute(x: torch.Tensor, perm) -> torch.Tensor:
    """Cyclic permute of the first three dims (``pallas_cyclic_permute``).

    perm (1, 2, 0): out[a,b,c] = x[c,a,b], the (I, J*K) view transposed;
    perm (2, 0, 1): out[a,b,c] = x[b,c,a], the (I*J, K) view transposed.
    Trailing dims move with each element.  Other perms raise.
    Differentiable: the backward permutes the gradient by the inverse
    perm (the other cyclic one).
    """
    perm = tuple(perm)
    if x.dim() < 3 or perm not in CYCLIC_PERMS:
        raise ValueError(f"cyclic_permute takes perms {CYCLIC_PERMS} of a "
                         f">= 3-dim tensor, got {perm} of {tuple(x.shape)}")
    if torch.is_grad_enabled() and x.requires_grad:
        return _CyclicPermute.apply(x, perm)
    return _cyclic_permute(x, perm)


class _CyclicPermute(torch.autograd.Function):
    """K1 (or its plain version on the CPU) under autograd."""

    @staticmethod
    def forward(ctx, x, perm):
        ctx.perm = perm
        return _cyclic_permute(x, perm)

    @staticmethod
    def backward(ctx, grad):
        inverse = CYCLIC_PERMS[1 - CYCLIC_PERMS.index(ctx.perm)]
        return _cyclic_permute(grad.contiguous(), inverse), None


def _cyclic_permute(x: torch.Tensor, perm) -> torch.Tensor:
    """:func:`cyclic_permute` outside autograd: the plain version on the
    CPU, else K1."""
    if x.device.type == "cpu":
        return cyclic_permute_ref(x, perm)
    I, J, K = x.shape[:3]
    if perm == (1, 2, 0):
        M, N, out_shape = I, J * K, (J, K, I)
    else:
        M, N, out_shape = I * J, K, (K, I, J)
    out = torch.empty(out_shape + tuple(x.shape[3:]), dtype=x.dtype,
                      device=x.device)
    _launch(x, out, M, N, 3)
    return out
