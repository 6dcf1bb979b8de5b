"""The cross product of two 3-component fields in one pass: a CUDA kernel
for Hopper under Taylor-Green's nonlinear term ``u x omega``.

Source: ``csrc/cross3.cu``, built by :mod:`cudecomp_tpu_torch.utils.cuda_build`
at first use.  It replaces no TPU kernel: the JAX package writes the
product as six products, three differences and a stack
(``cudecomp_tpu/models/taylor_green.py:135-139``), which XLA fuses into
one loop, while in PyTorch that formula is ten kernels whose stack
transposes the fields.

What bounds it: one read of ``u`` and ``w`` and one write of the result,
device-memory bandwidth.  The inverse FFT returns the fields with x
innermost and each component a plane of its own, and the result keeps
the layout ``torch.stack(..., dim=-1)`` gives, contiguous with the
component innermost, so the kernel transposes through shared-memory
tiles as it multiplies.  It rounds each product and each difference on
its own, as the formula's separate kernels do, so it is bit-equal to its
plain twin.

Dispatch: tensors on the CPU take the plain twin (:func:`cross_ref`, the
component formula), which defines what the kernel computes.  CUDA
tensors launch the kernel or raise; nothing falls back.
``launch_count`` counts launches, so a run can show that it went through
the kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from cudecomp_tpu_torch.utils import cuda_build

SOURCES = ("cross3.cu",)
SIGNATURES = (
    ("cudecomp_cross3",
     (ctypes.c_void_p,) * 3 + (ctypes.c_int64,) * 12 + (ctypes.c_void_p,),
     ctypes.c_int),
)
DTYPES = (torch.float32, torch.float64)

#: kernel launches since the last :func:`reset_launch_count`
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def _lib() -> ctypes.CDLL:
    return cuda_build.load("cross3", SOURCES, SIGNATURES)


def build() -> Path:
    """Compile (if needed) and load the kernel (K0 probes it); returns the
    library's path."""
    _lib()
    return cuda_build.library_path("cross3",
                                   cuda_build.library_sources(SOURCES))


def _check(u: torch.Tensor, w: torch.Tensor) -> None:
    if u.dim() != 4 or u.shape[-1] != 3 or u.shape != w.shape:
        raise ValueError(f"cross takes two (X, Y, Z, 3) fields of one shape, "
                         f"got {tuple(u.shape)} and {tuple(w.shape)}")
    if u.dtype not in DTYPES or w.dtype != u.dtype:
        raise ValueError(f"cross takes float32 or float64 fields of one "
                         f"dtype, got {u.dtype} and {w.dtype}")
    if u.device != w.device:
        raise ValueError(f"cross takes fields on one device, got {u.device} "
                         f"and {w.device}")


def cross_ref(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`cross`: the component formula, stacked."""
    return torch.stack([
        u[..., 1] * w[..., 2] - u[..., 2] * w[..., 1],
        u[..., 2] * w[..., 0] - u[..., 0] * w[..., 2],
        u[..., 0] * w[..., 1] - u[..., 1] * w[..., 0],
    ], dim=-1)


def cross(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``u x w`` over the last dim of two (X, Y, Z, 3) float fields, of
    any strides; the result is contiguous, the component innermost."""
    global launch_count
    _check(u, w)
    if u.device.type == "cpu":
        return cross_ref(u, w)
    if u.device.type != "cuda":
        raise ValueError(f"cross runs on CPU or CUDA tensors, got {u.device}")
    if torch.is_grad_enabled() and (u.requires_grad or w.requires_grad):
        raise ValueError("the cross kernel has no backward; call it under "
                         "torch.no_grad() or on CPU tensors")
    out = torch.empty(u.shape, dtype=u.dtype, device=u.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.cudecomp_cross3(u.data_ptr(), w.data_ptr(), out.data_ptr(),
                                  *u.shape[:3], *u.stride(), *w.stride(),
                                  u.element_size(), stream)
    if err != 0:
        msg = lib.cudecomp_cuda_error_string(err).decode()
        raise RuntimeError(f"cross launch failed for {tuple(u.shape)} "
                           f"{u.dtype}: {msg} ({err})")
    launch_count += 1
    return out
