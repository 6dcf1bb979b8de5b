"""K5, the fused 2-axis DFT: a dense DFT over dims 1 and 2 of a complex64
``(X, N1, N2)`` tensor, in CUDA for Hopper.

Replaces ``cudecomp_tpu/ops/mxu_fft.py``: ``dft2_fused``, gated by
``_dft2_gate``.  Source: ``csrc/dft2.cu``, built by
:mod:`cudecomp_tpu_torch.utils.cuda_build` at first use (K0 probes it at
load).

``out[b, Y, C] = sum_c (sum_y x[b, y, c] * Wy[y, Y]) * Wz[c, C]`` with the
dense DFT matrices ``W = cos + i * sign * sin`` of :func:`dft2_mats`; the
inverse uses the ``+`` sign and folds the ``1/(N1*N2)`` scale into the Z
weights, as the JAX kernel does (``mxu_fft.py:422-425``).  The kernel is
bound by its own operations (``8 * N1 * N2 * (N1 + N2)`` float32 flops per
x-plane); the transform it computes is bound by its bytes, which is why
cuFFT is faster.  The design is described in the source.

The distributed FFT takes K5 for the (1, 2) dims of a 3D stage of a
``split_complex`` plan when :func:`dft2_eligible` holds: the opt-in
``CUDECOMP_TPU_FFT_FUSED2=1``, read per call, and the JAX gate's size
rules, so the port takes K5 on exactly the plans where JAX takes it.

Dispatch: a tensor on the CPU takes the plain version (:func:`dft2_ref`,
which also takes complex128).  A CUDA tensor launches the kernel or
raises; nothing falls back.  ``launch_count`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from cudecomp_tpu_torch.utils import cuda_build
from cudecomp_tpu_torch.utils.env import fft_fused2

SOURCES = ("dft2.cu",)
SIGNATURES = (
    ("cudecomp_dft2", (ctypes.c_void_p,) * 4 + (ctypes.c_int64, ctypes.c_int,
                                                 ctypes.c_int,
                                                 ctypes.c_void_p),
     ctypes.c_int),
)

#: kernel launches since the last :func:`reset_launch_count`
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def _lib() -> ctypes.CDLL:
    return cuda_build.load("dft2", SOURCES, SIGNATURES)


def build() -> Path:
    """Compile (if needed) and load K5 (K0 probes it); returns the
    library's path."""
    _lib()
    return cuda_build.library_path("dft2", cuda_build.library_sources(SOURCES))


@functools.lru_cache(maxsize=None)
def _mats64(n: int, inverse: bool):
    """The dense DFT matrix of ``mxu_fft._dft_mats`` in float64 numpy:
    ``cos(2 pi j k / n)`` and ``sign * sin(...)``."""
    k = np.arange(n)
    ang = 2.0 * np.pi * np.outer(k, k) / n
    sign = 1.0 if inverse else -1.0
    return np.cos(ang), sign * np.sin(ang)


@functools.lru_cache(maxsize=None)
def dft2_mats(n: int, inverse: bool, device) -> tuple:
    """``(cos, sin)`` DFT matrices of size ``n`` as float32 tensors on
    ``device``: built in float64, cast once, cached per device."""
    return tuple(torch.as_tensor(m, dtype=torch.float32, device=device)
                 for m in _mats64(n, inverse))


@functools.lru_cache(maxsize=None)
def _weights(n1: int, n2: int, inverse: bool, dtype, device) -> tuple:
    """Complex ``(Wy, Wz)`` of ``dtype`` (complex64: from the float32
    :func:`dft2_mats`); the inverse's Wz carries ``1/(n1*n2)``, applied in
    the weights' precision as JAX applies it."""

    def mats(n):
        if dtype == torch.complex64:
            return dft2_mats(n, inverse, device)
        return tuple(torch.as_tensor(m, device=device)
                     for m in _mats64(n, inverse))

    cy, sy = mats(n1)
    cz, sz = mats(n2)
    if inverse:
        scale = 1.0 / (n1 * n2)
        cz, sz = cz * scale, sz * scale
    return torch.complex(cy, sy), torch.complex(cz, sz)


def dft2_eligible(x: torch.Tensor) -> bool:
    """Whether the FFT takes K5 for dims (1, 2) of ``x``: the JAX gate
    (``mxu_fft._dft2_gate``) without its platform clause.  The opt-in
    ``CUDECOMP_TPU_FFT_FUSED2=1``, a 3D complex64 tensor, ``N1 <= 256``,
    ``N2 <= 256``, ``N1 % 8 == 0`` and ``N2 % 128 == 0``."""
    if not fft_fused2():
        return False
    if x.dim() != 3 or x.dtype != torch.complex64:
        return False
    n1, n2 = x.shape[1], x.shape[2]
    return n1 <= 256 and n2 <= 256 and n1 % 8 == 0 and n2 % 128 == 0


def _check(x: torch.Tensor):
    if x.dim() != 3:
        raise ValueError(f"dft2 takes a 3D (X, N1, N2) tensor, got shape "
                         f"{tuple(x.shape)}")
    if min(x.shape[1:]) < 1:
        raise ValueError(f"dft2 needs N1, N2 >= 1, got {tuple(x.shape)}")


def dft2_ref(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Plain version of :func:`dft2`: the Y contraction, then the Z
    contraction, as two matrix products with the same weights, in
    ``x``'s dtype (complex64 or complex128)."""
    _check(x)
    if x.dtype not in (torch.complex64, torch.complex128):
        raise ValueError(f"dft2_ref takes complex64 or complex128, got "
                         f"{x.dtype}")
    wy, wz = _weights(x.shape[1], x.shape[2], bool(inverse), x.dtype,
                      x.device)
    return torch.matmul(torch.matmul(wy.transpose(0, 1), x), wz)


def dft2(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """The DFT over dims 1 and 2 of ``x`` (``torch.fft.fftn(x, dim=(1, 2))``
    forward, ``ifftn`` inverse); a new tensor."""
    global launch_count
    if x.device.type == "cpu":
        return dft2_ref(x, inverse)
    if x.device.type != "cuda":
        raise ValueError(f"K5 runs on CUDA tensors, got one on {x.device}")
    _check(x)
    if x.dtype != torch.complex64:
        raise ValueError(f"K5 takes complex64 CUDA tensors, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("K5 takes contiguous tensors; call .contiguous() "
                         "first")
    nx, n1, n2 = x.shape
    lib = _lib()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    wy, wz = _weights(n1, n2, bool(inverse), x.dtype, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.cudecomp_dft2(x.data_ptr(), out.data_ptr(), wy.data_ptr(),
                                wz.data_ptr(), nx, n1, n2, stream)
    if err != 0:
        msg = lib.cudecomp_cuda_error_string(err).decode()
        raise RuntimeError(f"K5 launch failed for shape {tuple(x.shape)} "
                           f"(it takes N2 <= 256, one thread per column, "
                           f"and a 144 * max(N1, N2)-byte shared tile): "
                           f"{msg} ({err})")
    launch_count += 1
    return out
