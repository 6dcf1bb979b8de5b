"""C2, the spectral curl and the masked Leray projection in CUDA for Hopper:
one pass each over a complex ``(..., 3)`` spectral state (a complex tensor
or a split-complex plan's ``(re, im)`` planes).

Replaces no TPU kernel: the JAX package writes
``SpectralOperators.curl`` and ``project_solenoidal`` as array
expressions that XLA fuses into one loop each.  Source:
``csrc/spectral3.cu`` (two entries of one kernel design), built by
:mod:`cudecomp_tpu_torch.utils.cuda_build` at first use (K0 probes it at
load).

Per spectral point, with ``kx, ky, kz`` taken from the per-axis
wavenumber vectors (:func:`~cudecomp_tpu_torch.ops.spectral.
wavenumber_broadcasts`, each indexed along the tensor dim it lies on):

* :func:`curl`: ``i k x v``;
* :func:`project`: ``m v - k (k . m v) / |k|^2``, ``1/|k|^2`` pinned to 0
  at ``k = 0``, ``m`` an optional real field multiplied in first.

The plain versions are :meth:`SpectralOperators._curl_formula` and
:meth:`~SpectralOperators._project_formula`; the kernel runs their
operations in their order, each rounded on its own, so on the card it
gives their bits where the wavenumbers are of the state's real dtype.

It is bound by device-memory bandwidth: one read and one write of the
state (and one read of the mask's field).  The output is
``torch.empty_like(vh)``, so it keeps the input's strides, and the kernel
addresses both through their strides: the component planes the FFT
returns, a component-innermost stack, or a pencil whose wavenumbers lie
along other dims.  :func:`geometry` puts the spatial dim of the smallest
input stride innermost, where the thread index walks.

Dispatch (:func:`takes`): a CUDA complex64 or complex128 ``(X, Y, Z, 3)``
tensor, or an ``(re, im)`` pair of CUDA float32 or float64 ones (a
split-complex plan's planes), launches the kernel; a CPU state or
another dtype takes the plain version, which defines the result.  Under
autograd the kernel runs in both directions (:class:`_C2`): both
operators are self-adjoint.  ``launch_count`` counts launches, so a run
can show that it went through the kernel; :func:`counts` gives a call's
trace counts.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from cudecomp_tpu_torch.utils import cuda_build

SOURCES = ("spectral3.cu",)
#: the ``Geometry`` words of ``csrc/spectral3.cu``: extents (3), input
#: strides (4), output strides (4), the wavenumbers' strides (3 x 3), the
#: mask's strides (3)
GEOMETRY_WORDS = 23
SIGNATURES = (
    ("cudecomp_spectral_curl",
     (ctypes.c_void_p,) * 8 + (ctypes.c_int, ctypes.c_void_p), ctypes.c_int),
    ("cudecomp_spectral_project",
     (ctypes.c_void_p,) * 9 + (ctypes.c_int, ctypes.c_void_p), ctypes.c_int),
)
#: the C entries' dtype codes: a complex state's, then a plane pair's
DTYPE_CODES = {torch.complex64: 0, torch.complex128: 1, torch.float32: 2,
               torch.float64: 3}

#: kernel launches since the last :func:`reset_launch_count`
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def _lib() -> ctypes.CDLL:
    return cuda_build.load("spectral3", SOURCES, SIGNATURES)


def build() -> Path:
    """Compile (if needed) and load C2 (K0 probes it); returns the
    library's path."""
    _lib()
    return cuda_build.library_path("spectral3",
                                   cuda_build.library_sources(SOURCES))


def _planes(vh) -> tuple:
    """The tensors of a state: ``(vh,)``, or the ``(re, im)`` pair."""
    return vh if isinstance(vh, tuple) else (vh,)


def takes(vh) -> bool:
    """Whether a call with ``vh`` launches the kernel: a CUDA complex64
    or complex128 ``(X, Y, Z, 3)`` tensor, or an ``(re, im)`` pair of
    CUDA float32 or float64 tensors of one shape."""
    planes = _planes(vh)
    if not all(isinstance(p, torch.Tensor) for p in planes):
        return False
    v = planes[0]
    if len(planes) == 2:
        re, im = planes
        if not (re.dtype in (torch.float32, torch.float64)
                and (im.dtype, im.shape, im.device)
                == (re.dtype, re.shape, re.device)):
            return False
    elif len(planes) != 1 or v.dtype not in (torch.complex64,
                                             torch.complex128):
        return False
    return v.device.type == "cuda" and v.dim() == 4 and v.shape[-1] == 3


def counts(vh, mask=None) -> dict:
    """A call's trace counts: ``bytes``, what one pass must move (the
    state read and written, the mask's field read), and ``kernel``, 1
    where the call launches the kernel and 0 where it takes the plain
    version."""
    nbytes = 2 * sum(p.numel() * p.element_size() for p in _planes(vh))
    if mask is not None:
        nbytes += mask.numel() * mask.element_size()
    return {"bytes": nbytes, "kernel": int(takes(vh))}


def geometry(vh, out, ks, mask=None) -> list:
    """The C entry's ``Geometry`` words for ``vh`` and ``out`` (``(X, Y,
    Z, 3)``; of a plane pair, the real planes), the wavenumbers ``ks``
    and ``mask`` (expanded to the spatial shape): the spatial dims
    ordered so that the last has the smallest input stride among the dims
    longer than 1."""
    order = sorted(range(3), key=lambda d: (vh.shape[d] > 1,
                                            -abs(vh.stride(d))))
    words = [vh.shape[d] for d in order]
    for t in (vh, out):
        words += [t.stride(d) for d in order] + [t.stride(3)]
    for t in ks:
        words += [t.stride(d) for d in order]
    words += [0, 0, 0] if mask is None else [mask.stride(d) for d in order]
    return words


def operands(planes, ks, mask):
    """What the kernel reads and writes for the state ``planes``: the
    planes, in one layout (a pair whose strides differ is made
    contiguous); the outputs, ``torch.empty_like`` of the first; the
    wavenumbers and the mask in the state's real dtype, expanded to the
    spatial shape; and the :func:`geometry` words."""
    if len(planes) == 2 and planes[0].stride() != planes[1].stride():
        planes = tuple(p.contiguous() for p in planes)
    v = planes[0]
    outs = tuple(torch.empty_like(v) for _ in planes)
    real, spatial = v.dtype.to_real(), v.shape[:3]
    ks = [k.to(device=v.device, dtype=real).expand(spatial) for k in ks]
    if mask is not None:
        mask = mask.to(device=v.device, dtype=real).expand(spatial)
    return planes, outs, ks, mask, geometry(v, outs[0], ks, mask)


def _launch(entry: str, planes, ks, mask) -> tuple:
    """One launch of ``entry`` on the state ``planes``, outside
    autograd; the output planes."""
    global launch_count
    vh = planes if len(planes) == 2 else planes[0]
    if not takes(vh):
        raise ValueError(
            f"C2 runs complex64 and complex128 (X, Y, Z, 3) CUDA tensors "
            f"and (re, im) pairs of float32 or float64 ones, got "
            f"{[(tuple(p.shape), p.dtype, str(p.device)) for p in planes]}")
    planes, outs, ks, mask, words = operands(planes, ks, mask)
    v = planes[0]
    if v.numel() == 0:
        return outs
    words = (ctypes.c_int64 * GEOMETRY_WORDS)(*words)
    lib = _lib()
    pair = len(planes) == 2
    ptrs = [v.data_ptr(), planes[1].data_ptr() if pair else None,
            outs[0].data_ptr(), outs[1].data_ptr() if pair else None]
    ptrs += [k.data_ptr() for k in ks]
    if entry == "project":
        ptrs.append(None if mask is None else mask.data_ptr())
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = getattr(lib, f"cudecomp_spectral_{entry}")(
            *ptrs, ctypes.addressof(words), DTYPE_CODES[v.dtype], stream)
    if err != 0:
        msg = lib.cudecomp_cuda_error_string(err).decode()
        raise RuntimeError(f"C2 ({entry}) launch failed for "
                           f"{tuple(v.shape)} {v.dtype}: {msg} ({err})")
    launch_count += 1
    return outs


def _apply(entry: str, vh, ks, mask):
    """``entry`` on ``vh`` (a tensor or a plane pair), in its form:
    through :class:`_C2` where a gradient is asked of the state or the
    mask, else one launch."""
    planes = _planes(vh)
    tracked = planes + (() if mask is None else (mask,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in tracked):
        outs = _C2.apply(entry, tuple(ks), mask, *planes)
    else:
        outs = _launch(entry, planes, ks, mask)
    return tuple(outs) if isinstance(vh, tuple) else outs[0]


class _C2(torch.autograd.Function):
    """C2 under autograd.  Both operators are self-adjoint, so the
    gradient of the state is one more pass of the same entry: the curl
    is ``i K`` with ``K`` the real skew matrix of ``k x``, and ``(i K)^H
    = i K``; the masked projection is ``m P``, ``m`` and ``P`` real and
    symmetric (a plane pair's real map is the same blocks).  The mask's
    gradient is ``Re(g . conj(P v))`` over the components, summed to the
    mask's shape, ``P v`` one unmasked projection pass."""

    @staticmethod
    def forward(ctx, entry, ks, mask, *planes):
        ctx.entry, ctx.ks = entry, ks
        ctx.save_for_backward(
            mask, *(planes if ctx.needs_input_grad[2] else ()))
        return _launch(entry, planes, ks, mask)

    @staticmethod
    def backward(ctx, *grads):
        mask, *planes = ctx.saved_tensors
        pair = len(grads) == 2
        gv = _apply(ctx.entry, grads if pair else grads[0], ctx.ks, mask)
        gm = None
        if ctx.needs_input_grad[2]:
            pv = _planes(_apply("project", tuple(planes) if pair
                                else planes[0], ctx.ks, None))
            gm = sum((g * p.conj()).real for g, p in zip(grads, pv))
            gm = gm.sum(-1).sum_to_size(mask.shape).to(mask.dtype)
        return (None, None, gm) + _planes(gv)


def curl(vh, ks):
    """``i k x vh`` in one pass, in ``vh``'s layout and form (a tensor or
    an ``(re, im)`` pair); ``ks`` the ``(kx, ky, kz)`` vectors in
    broadcast form.  Differentiable."""
    return _apply("curl", vh, ks, None)


def project(vh, ks, mask=None):
    """``m vh - k (k . m vh) / |k|^2`` in one pass, in ``vh``'s layout
    and form; ``mask`` (``m``) a real field broadcast against one
    component, or None for 1.  Differentiable, in ``vh`` and ``mask``."""
    return _apply("project", vh, ks, mask)
