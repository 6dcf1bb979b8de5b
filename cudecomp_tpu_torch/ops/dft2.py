"""K5, the fused 2-axis DFT of each x-plane of a complex64 ``(X, N1, N2)``
tensor, in CUDA for Hopper: one pass of FFTs per plane, the plane held in
a thread-block cluster.

Replaces ``cudecomp_tpu/ops/mxu_fft.py``: ``dft2_fused``, gated by
``_dft2_gate``.  Source: ``csrc/dft2.cu``, built by
:mod:`cudecomp_tpu_torch.utils.cuda_build` at first use (K0 probes it at
load).

``out[b] = fft2(x[b])`` over dims (1, 2); the inverse is ``ifft2``, with
the ``1/(N1*N2)`` scale (``mxu_fft.py:422-425``).  The JAX kernel computes
it as two dense DFT matrix products (:func:`dft2_mats`), because the MXU
does matrix products and nothing else; on the card a dense DFT is bound by
its operations, so K5 computes the same function as FFTs, one HBM read and
one HBM write of each plane, and is bound by those bytes.  A 256 x 256
plane does not fit one block's shared memory: a cluster of C blocks holds
it, and each block reads the others' rows through distributed shared
memory.  :func:`dft2_plan` picks C and the column chunk width;
:func:`dft2_stages` is a CPU model of the kernel's algorithm (the same
factorisation, twiddle tables and cluster split) that the tests hold to
the JAX kernel and to numpy.  The design is described in the source.

The distributed FFT takes K5 for the (1, 2) dims of a 3D stage of a
``split_complex`` plan when :func:`dft2_eligible` holds: the opt-in
``CUDECOMP_TPU_FFT_FUSED2=1``, read per call, and the JAX gate's size
rules (:func:`dft2_fits`), so the port takes K5 on exactly the plans
where JAX takes it.  A plan's ``fused2`` field, which ``autotune_fft``
pins, overrides the opt-in.

Dispatch: a tensor on the CPU takes the plain version (:func:`dft2_ref`,
the two dense products, which also takes complex128).  A CUDA tensor
launches the kernel or raises; nothing falls back.  ``launch_count``
counts launches.  :func:`dft2` is a ``torch.autograd.Function`` on both
devices: the gradient of the unnormalised forward DFT ``A`` is
``A^H g``, the inverse transform of ``g`` without its ``1/(N1*N2)``; that
of the inverse is the forward transform of ``g`` times ``1/(N1*N2)``.  On
a CUDA tensor both are one K5 launch, the factor passed as K5's scale.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from cudecomp_tpu_torch.utils import cuda_build
from cudecomp_tpu_torch.utils.env import fft_fused2

SOURCES = ("dft2.cu",)
SIGNATURES = (
    ("cudecomp_dft2", (ctypes.c_void_p,) * 4 + (
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p),
     ctypes.c_int),
    ("cudecomp_dft2_smem_bytes", (ctypes.c_int,) * 4, ctypes.c_int64),
)
ROW_RADIX = 16         # csrc/dft2.cu: N2 = 16 * B
INNER = 32             # the in-register FFTs' twiddles: W_32^j
CLUSTERS = (1, 2, 4, 8)
CHUNKS = (32, 16)      # column chunk widths, widest first
BLOCK_SMEM = 232_448   # 227 KB: the most one block may hold
SM_SMEM = 233_472      # 228 KB of an SM, 1 KB of it reserved per block
#: per-block budget: two blocks share each SM
SMEM_BUDGET = SM_SMEM // 2 - 1024

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


@functools.lru_cache(maxsize=None)
def twiddles(n: int, dtype, device) -> torch.Tensor:
    """K5's twiddle table of one axis: ``W_n^k = exp(-2 pi i k / n)`` for
    ``k < n`` (K5 runs every transform forward), built in float64 and cast
    once to ``dtype``; cached per (n, dtype, device)."""
    ang = 2.0 * np.pi * np.arange(n) / n
    w = np.cos(ang) - 1j * np.sin(ang)
    return torch.as_tensor(w, device=device).to(dtype)


def col_radix(n1: int) -> int:
    """A of the column factorisation N1 = A * M (``csrc/dft2.cu:
    kernel_for``): 16 for N1 = 128 or 256, else 8."""
    return 16 if n1 in (128, 256) else 8


def dft2_fits(x: torch.Tensor) -> bool:
    """Whether K5 takes dims (1, 2) of ``x``: the JAX gate's size rules
    (``mxu_fft._dft2_gate`` without its platform clause and its opt-in):
    a 3D complex64 tensor, ``N1 <= 256``, ``N2 <= 256``, ``N1 % 8 == 0``
    and ``N2 % 128 == 0``."""
    if x.dim() != 3 or x.dtype != torch.complex64:
        return False
    n1, n2 = x.shape[1], x.shape[2]
    return n1 <= 256 and n2 <= 256 and n1 % 8 == 0 and n2 % 128 == 0


def dft2_eligible(x: torch.Tensor) -> bool:
    """Whether the FFT takes K5 for dims (1, 2) of ``x`` when its plan
    leaves the choice to the environment: the opt-in
    ``CUDECOMP_TPU_FFT_FUSED2=1`` and :func:`dft2_fits`."""
    return fft_fused2() and dft2_fits(x)


class Dft2Plan(NamedTuple):
    """How K5 lays out one x-plane: ``cluster`` blocks of ``N1/cluster``
    rows each, columns in chunks of ``chunk``, ``smem`` bytes of shared
    memory per block."""
    cluster: int
    chunk: int
    smem: int


def smem_bytes(n1: int, n2: int, cluster: int, chunk: int) -> int:
    """Shared memory of one K5 block (``csrc/dft2.cu: smem_bytes``, which
    the kernel's launch uses; a ``gpu`` test holds the two equal on every
    layout of the gate's shapes): the two twiddle tables, its
    ``n1/cluster`` rows padded by one slot per 16 and one ``n1 x chunk``
    column chunk, of 8-byte values, and the 4-byte cluster address of each
    of the plane's ``n1`` rows."""
    return (8 * ((n1 // cluster) * (n2 + n2 // 16) + n1 * chunk + n1 + n2)
            + 4 * n1)


@functools.lru_cache(maxsize=None)
def dft2_plan(n1: int, n2: int) -> Dft2Plan:
    """K5's layout for ``(N1, N2)`` planes: the smallest cluster whose
    per-block share (with a 16-column chunk) fits :data:`SMEM_BUDGET`, so
    that two blocks share each SM, then the widest chunk that divides the
    block's columns and still fits.  Raises ValueError for shapes K5 does
    not take."""
    if not (8 <= n1 <= 256 and n1 % 8 == 0 and n2 in (128, 256)):
        raise ValueError(f"K5 takes planes of N1 <= 256 with N1 % 8 == 0 "
                         f"and N2 in (128, 256), got ({n1}, {n2})")
    for c in CLUSTERS:
        if smem_bytes(n1, n2, c, CHUNKS[-1]) <= SMEM_BUDGET:
            chunk = next(w for w in CHUNKS if (n2 // c) % w == 0
                         and smem_bytes(n1, n2, c, w) <= SMEM_BUDGET)
            return Dft2Plan(c, chunk, smem_bytes(n1, n2, c, chunk))
    raise ValueError(f"no cluster of K5 holds a ({n1}, {n2}) plane")


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


# -- the CPU model of the kernel -------------------------------------------------

def _bitrev(L: int) -> torch.Tensor:
    """``bitrev(i, L)`` of ``csrc/dft2.cu`` for every ``i < L``."""
    bits = L.bit_length() - 1
    return torch.tensor([int(f"{i:0{bits}b}"[::-1], 2) if bits else 0
                         for i in range(L)])


def _fft_regs(v: torch.Tensor, w32: torch.Tensor) -> torch.Tensor:
    """``fft_regs`` of ``csrc/dft2.cu`` over the last dim of ``v`` (length
    L, a power of two up to 32): the forward DFT by radix-2 decimation in
    frequency with ``W_L^j = w32[j * 32 / L]``, left in bit-reversed
    order."""
    L = v.shape[-1]
    lead = v.shape[:-1]
    s, half = 0, L // 2
    while half:
        g = v.reshape(*lead, L // (2 * half), 2, half)
        a, c = g[..., 0, :], g[..., 1, :]
        w = w32[(torch.arange(half) << s) * (INNER // L)]
        v = torch.stack((a + c, (a - c) * w), dim=-2).reshape(*lead, L)
        s, half = s + 1, half // 2
    return v


def dft2_stages(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """A CPU model of K5's algorithm, for the tests: the same
    factorisation (N2 = 16 B for the rows, N1 = A M for the columns, A
    from :func:`col_radix`), the inverse as the conjugate of the forward
    transform of the conjugate, the same twiddle tables (:func:`twiddles`,
    of ``x``'s dtype) and the same cluster split (:func:`dft2_plan`: each
    block's padded rows, each column chunk gathered from the rows'
    owners), stage by stage as ``csrc/dft2.cu`` runs them; each stage is
    vectorised over its threads."""
    _check(x)
    X, n1, n2 = x.shape
    plan = dft2_plan(n1, n2)
    C, W = plan.cluster, plan.chunk
    A = col_radix(n1)
    B, M, R = n2 // ROW_RADIX, n1 // A, n1 // C
    pitch = n2 + n2 // 16
    tw1 = twiddles(n1, x.dtype, x.device)
    tw2 = twiddles(n2, x.dtype, x.device)
    w32 = twiddles(INNER, x.dtype, x.device)
    if inverse:
        x = x.conj()

    def pad(k):
        return k + k // 16

    rev16, revb, reva = _bitrev(ROW_RADIX), _bitrev(B), _bitrev(A)
    n_a, n_b, k_a = (torch.arange(ROW_RADIX), torch.arange(B),
                     torch.arange(ROW_RADIX))
    # 1. Z pass: block r's rows, in its shared memory (pad slots included)
    rows = torch.zeros((C, X, R, pitch), dtype=x.dtype, device=x.device)
    for r in range(C):
        xr = x[:, r * R:(r + 1) * R]
        v = _fft_regs(xr[:, :, B * n_a[None, :] + n_b[:, None]], w32)
        v = v * tw2[n_b[:, None] * rev16[None, :]]  # thread (row, n_b)
        rows[r][:, :, pad(rev16[None, :] + ROW_RADIX * n_b[:, None])] = v
        v = _fft_regs(rows[r][:, :, pad(k_a[:, None] + ROW_RADIX
                                        * n_b[None, :])], w32)
        rows[r][:, :, pad(k_a[:, None] + ROW_RADIX * revb[None, :])] = v
    # 3. Y pass: block r's columns, chunk by chunk
    out = torch.empty_like(x)
    scale = 1.0 / (n1 * n2) if inverse else 1.0
    m_b, c_a, c = torch.arange(M), torch.arange(A), torch.arange(W)
    g = M * c_a[None, :] + m_b[:, None]  # (n_b, n_a): the rows gathered
    for r in range(C):
        for c0 in range(r * n2 // C, (r + 1) * n2 // C, W):
            # thread (column, n_b): A values from the rows' owners
            v = rows[g // R, :, g % R][..., pad(c0 + c)]  # (n_b, n_a, X, W)
            v = _fft_regs(v.permute(2, 0, 3, 1), w32)     # (X, n_b, W, k_a)
            v = v * tw1[m_b[:, None, None] * reva[None, None, :]]
            scratch = torch.empty((X, n1, W), dtype=x.dtype, device=x.device)
            scratch[:, reva[None, None, :] + A * m_b[:, None, None],
                    c[None, :, None]] = v
            # thread (column, k_a): the M-point transform over n_b
            z = scratch[:, c_a[:, None, None] + A * m_b[None, None, :],
                        c[None, :, None]]                 # (X, k_a, W, n_b)
            if M & (M - 1) == 0:
                z, k_b = _fft_regs(z, w32), _bitrev(M)
            else:
                k_b = m_b
                z = z @ tw1[A * ((m_b[:, None] * k_b[None, :]) % M)]
            out[:, c_a[:, None, None] + A * k_b[None, None, :],
                (c0 + c)[None, :, None]] = z * scale
    return out.conj().resolve_conj() if inverse else out


# -- the kernel ----------------------------------------------------------------

def dft2(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """The DFT over dims 1 and 2 of ``x`` (``torch.fft.fftn(x, dim=(1, 2))``
    forward, ``ifftn`` inverse); a new tensor.  Differentiable."""
    inverse = bool(inverse)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Dft2.apply(x, inverse)
    return _dft2(x, inverse)


class _Dft2(torch.autograd.Function):
    """K5 (or its plain version on the CPU) under autograd: the backward of
    either direction is one transform of the other direction, scaled."""

    @staticmethod
    def forward(ctx, x, inverse):
        ctx.inverse = inverse
        return _dft2(x, inverse)

    @staticmethod
    def backward(ctx, grad):
        # forward: A^H g = n * ifft2(g), the unnormalised inverse;
        # inverse: (1/n) A g, the forward transform times 1/n
        n = grad.shape[1] * grad.shape[2]
        return (_dft2(grad.contiguous(), not ctx.inverse,
                      1.0 / n if ctx.inverse else 1.0), None)


def _dft2(x: torch.Tensor, inverse: bool, scale=None) -> torch.Tensor:
    """The unnormalised transform of ``x`` (forward, or inverse: the
    conjugate exponent) times ``scale`` (None: the FFT pair's, 1 forward
    and ``1/(N1*N2)`` inverse), outside autograd: the plain version on the
    CPU, else one K5 launch."""
    global launch_count
    _check(x)
    n = x.shape[1] * x.shape[2]
    default = 1.0 / n if inverse else 1.0
    if scale is None:
        scale = default
    if x.device.type == "cpu":
        out = dft2_ref(x, inverse)
        return out if scale == default else out * (scale / default)
    if x.device.type != "cuda":
        raise ValueError(f"K5 runs on CUDA tensors, got one on {x.device}")
    if x.dtype != torch.complex64:
        raise ValueError(f"K5 takes complex64 CUDA tensors, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("K5 takes contiguous tensors; call .contiguous() "
                         "first")
    nx, n1, n2 = x.shape
    plan = dft2_plan(n1, n2)
    lib = _lib()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    tw1 = twiddles(n1, x.dtype, x.device)
    tw2 = twiddles(n2, x.dtype, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.cudecomp_dft2(x.data_ptr(), out.data_ptr(), tw1.data_ptr(),
                                tw2.data_ptr(), nx, n1, n2, plan.cluster,
                                plan.chunk, int(bool(inverse)), scale,
                                stream)
    if err != 0:
        msg = lib.cudecomp_cuda_error_string(err).decode()
        raise RuntimeError(f"K5 launch failed for shape {tuple(x.shape)}, "
                           f"one cluster of {plan.cluster} blocks per plane "
                           f"with {plan.smem} bytes of shared memory each "
                           f"and {plan.chunk}-column chunks: {msg} ({err})")
    launch_count += 1
    return out
