"""K4, the 27-point stencil kernel: a weighted 3x3x3 stencil in CUDA for
Hopper.

Replaces ``cudecomp_tpu/ops/stencil.py``: ``_stencil27_kernel``, launched
by ``_ghost_plane_call``.  Source: ``csrc/stencil27.cu``, built by
:mod:`cudecomp_tpu_torch.utils.cuda_build` at first use (K0 probes it at
load).

``out[i,j,k] = sum w[1+dx,1+dy,1+dz] * E[i+dx, j+dy, k+dz]`` over the
nonzero taps, in memory-dim order, with the taps summed in JAX's order
(``dx``, ``dy``, ``dz`` ascending) in the tensor's dtype.  ``E`` is the
block extended by one cell per side of each dim, given in one of two
input modes:

  * valid mode (``ghosts=None``): ``u`` is the extended block
    ``(mx+2, my+2, mz+2)``, and the output is ``(mx, my, mz)``;
  * ghost-plane mode: ``u`` is ``(mx, my, mz)`` and ``ghosts`` holds, per
    memory dim, either ``None`` (the dim wraps: its index is taken modulo
    the extent) or a ``(lo, hi)`` pair of ghost planes of that dim's
    one-cell thickness, ``(1, my, mz)``, ``(mx, 1, mz)`` or ``(mx, my, 1)``.
    Wrapping dims are resolved first (so an x-ghost plane is rolled along
    a wrapping y); a cell that lies in two ghost planes at once reads 0.

It is bound by device-memory bandwidth: one read and one write of the
field.  The design (2.5D blocking: each block marches along x while the
planes of its tile stream by ``cp.async`` into a ring of shared-memory
buffers) is described in the source.

Dispatch: a tensor on the CPU takes the plain version
(:func:`stencil27_ref`), which defines what the kernel computes.  A CUDA
float32 or float64 tensor launches the kernel or raises; a CUDA tensor of
another dtype raises ``ValueError``; nothing falls back.
``launch_count`` counts launches, so a run can show that it went through
the kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from cudecomp_tpu_torch.utils import cuda_build

SOURCES = ("stencil27.cu",)
SIGNATURES = (
    ("cudecomp_stencil27",
     (ctypes.c_void_p,) * 8 + (ctypes.c_int64,) * 3
     + (ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p), ctypes.c_int),
)
#: element bytes of the types the kernel is built for
KERNEL_DTYPES = {torch.float32: 4, torch.float64: 8}
OFFSETS = tuple((dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                for dz in (-1, 0, 1))

#: kernel launches since the last :func:`reset_launch_count`
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def _lib() -> ctypes.CDLL:
    return cuda_build.load("stencil27", SOURCES, SIGNATURES)


def build() -> Path:
    """Compile (if needed) and load K4 (K0 probes it); returns the
    library's path."""
    _lib()
    return cuda_build.library_path("stencil27",
                                   cuda_build.library_sources(SOURCES))


def as_weights(weights) -> np.ndarray:
    """The (3, 3, 3) float64 weight array; raises on another shape."""
    w = np.asarray(weights, dtype=np.float64)
    if w.shape != (3, 3, 3):
        raise ValueError(f"weights must be (3, 3, 3); got {w.shape}")
    return w


def taps(weights):
    """The nonzero taps ``((dx, dy, dz), w)`` in JAX's summation order."""
    w = as_weights(weights)
    return tuple((o, float(w[1 + o[0], 1 + o[1], 1 + o[2]]))
                 for o in OFFSETS if w[1 + o[0], 1 + o[1], 1 + o[2]] != 0.0)


def kernel_elem_bytes(dtype: torch.dtype) -> int:
    """Element bytes K4 is built for; ``ValueError`` for another dtype
    (bf16's stencil is a ROADMAP item)."""
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"K4 runs float32 and float64 on CUDA tensors, got "
                         f"{dtype}")
    return KERNEL_DTYPES[dtype]


def _check(u: torch.Tensor, ghosts):
    """(mx, my, mz) of the output; raises on shapes the kernel cannot take."""
    if u.dim() != 3:
        raise ValueError(f"stencil27 takes a 3D block, got {tuple(u.shape)}")
    if ghosts is None:
        ext = tuple(n - 2 for n in u.shape)
        if min(ext) < 1:
            raise ValueError(f"valid mode needs an extended block of extents "
                             f">= 3, got {tuple(u.shape)}")
        return ext
    if len(ghosts) != 3:
        raise ValueError("ghosts must give one entry per memory dim")
    ext = tuple(u.shape)
    if min(ext) < 1:
        raise ValueError(f"stencil27 needs extents >= 1, got {ext}")
    for d, g in enumerate(ghosts):
        if g is None:
            continue
        plane = list(ext)
        plane[d] = 1
        if len(g) != 2 or any(tuple(p.shape) != tuple(plane) for p in g):
            raise ValueError(f"ghost planes of dim {d} must be a (lo, hi) "
                             f"pair of shape {tuple(plane)}")
    return ext


def _extend_ref(u: torch.Tensor, ghosts) -> torch.Tensor:
    """The extended block E of ghost-plane mode: each dim in turn, wrapped
    or between its ghost planes; a ghost plane is itself extended along the
    dims before it (wrapped, or zero where those dims are ghost dims)."""
    for d, g in enumerate(ghosts):
        if g is None:
            n = u.shape[d]
            lo, hi = u.narrow(d, n - 1, 1), u.narrow(d, 0, 1)
        else:
            lo, hi = g
            for e in range(d):
                if ghosts[e] is None:
                    lo = torch.cat([lo.narrow(e, lo.shape[e] - 1, 1), lo,
                                    lo.narrow(e, 0, 1)], dim=e)
                    hi = torch.cat([hi.narrow(e, hi.shape[e] - 1, 1), hi,
                                    hi.narrow(e, 0, 1)], dim=e)
                else:
                    pad = [0, 0] * (2 - e) + [1, 1]
                    lo = torch.nn.functional.pad(lo, pad)
                    hi = torch.nn.functional.pad(hi, pad)
        u = torch.cat([lo.to(u.dtype), u, hi.to(u.dtype)], dim=d)
    return u


def stencil27_ref(u: torch.Tensor, weights, ghosts=None) -> torch.Tensor:
    """Plain version of :func:`stencil27`: the shifted-slice sum of JAX's
    generic path (``stencil.py:465-477``) over the extended block."""
    ext = _check(u, ghosts)
    ue = u if ghosts is None else _extend_ref(u, ghosts)
    out = None
    for (dx, dy, dz), wv in taps(weights):
        term = wv * ue[1 + dx:1 + dx + ext[0], 1 + dy:1 + dy + ext[1],
                       1 + dz:1 + dz + ext[2]]
        out = term if out is None else out + term
    if out is None:
        return u.new_zeros(ext)
    return out.to(u.dtype).contiguous()


def stencil27(u: torch.Tensor, weights, ghosts=None) -> torch.Tensor:
    """The weighted 3x3x3 stencil of ``u`` (see the module docstring for
    the two input modes); a new ``(mx, my, mz)`` tensor."""
    global launch_count
    if u.device.type == "cpu":
        return stencil27_ref(u, weights, ghosts)
    elem = kernel_elem_bytes(u.dtype)
    if u.device.type != "cuda":
        raise ValueError(f"K4 runs on CUDA tensors, got one on {u.device}")
    ext = _check(u, ghosts)
    planes = [None] * 6
    wrap = 0
    for d, g in enumerate(ghosts or (None,) * 3):
        if g is None:
            wrap |= 1 << d
        else:
            planes[2 * d:2 * d + 2] = g
    for t in [u] + [p for p in planes if p is not None]:
        if t.device != u.device or t.dtype != u.dtype:
            raise ValueError("ghost planes must match the block's device "
                             "and dtype")
        if not t.is_contiguous():
            raise ValueError("K4 takes contiguous tensors; call "
                             ".contiguous() first")
    w = as_weights(weights)
    wbuf = (ctypes.c_double * 27)(*w.ravel().tolist())
    out = torch.empty(ext, dtype=u.dtype, device=u.device)
    lib = _lib()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.cudecomp_stencil27(
            u.data_ptr(), out.data_ptr(),
            *[p.data_ptr() if p is not None else None for p in planes],
            *ext, wrap, int(ghosts is None), ctypes.addressof(wbuf), elem,
            stream)
    if err != 0:
        msg = lib.cudecomp_cuda_error_string(err).decode()
        raise RuntimeError(f"K4 launch failed for extents {ext} "
                           f"({u.dtype}): {msg} ({err})")
    launch_count += 1
    return out
