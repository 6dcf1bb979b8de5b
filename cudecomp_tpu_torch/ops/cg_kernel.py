"""C3, the vector passes of a conjugate-gradient iteration in CUDA for
Hopper: three entries, one pass over the grid each, with the iteration's
scalars kept on the device.

Replaces no TPU kernel: the JAX package writes the iteration
(``cudecomp_tpu/models/poisson.py``, ``solve_cg``) as array expressions
that XLA fuses.  Source: ``csrc/cg3.cu``, built by
:mod:`cudecomp_tpu_torch.utils.cuda_build` at first use (K0 probes it at
load).

* :func:`dot`: ``sum(a * b)`` (``p . Ap``), 2 vectors read;
* :func:`update`: ``alpha = rs / pAp`` (guarded), ``u + alpha p``,
  ``r - alpha Ap`` and the sum of the new ``r * r``: 4 vectors read, 2
  written;
* :func:`direction`: ``beta = rs' / rs`` (guarded), ``r + beta p``: 2
  read, 1 written.

A guarded division is 0 where its denominator is not positive (a state
that converged between two host checks stays where it is).  The plain
versions are the formulas of ``models/poisson.py`` (``_cg_dot``,
``_cg_update``, ``_cg_direction``); the kernel runs their elementwise
operations in their order, each rounded on its own to the state's dtype
(bfloat16 and float16 computed in float32, as PyTorch's operators compute
them), so on the card the new ``u``, ``r`` and ``p`` are their bits for
the same scalars.  The sums add float64 products in float64 and round once
to the state's dtype; the blocks' partial sums are added by a second
launch in a fixed order, so the same input gives the same bits on every
run.

Every output is new (``torch.empty_like``, a new 0-d tensor for each
scalar): nothing of the input state is written.  The entries take
contiguous CUDA tensors of one device and dtype (float32, float64,
bfloat16 or float16; :func:`takes`) and raise on anything else, so a
caller that hands them a CUDA state never falls back to the formulas.
They have no backward: under autograd a tensor that requires grad raises
too, rather than losing its gradient.  ``launch_count`` counts the
entries' calls, ``calls`` each entry's; ``KERNELS`` names the kernels an
entry's call launches (the reducing entries launch ``finish_kernel`` after
their pass), so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from cudecomp_tpu_torch.utils import cuda_build

SOURCES = ("cg3.cu",)
_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
SIGNATURES = (
    ("cudecomp_cg_dot", (_P,) * 4 + (_I64, _INT, _INT, _P), _INT),
    ("cudecomp_cg_update", (_P,) * 11 + (_I64, _INT, _INT, _P), _INT),
    ("cudecomp_cg_direction", (_P,) * 5 + (_I64, _INT, _INT, _P), _INT),
)
#: the C entries' dtype codes
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2,
               torch.float16: 3}
#: the ``__global__`` kernels of ``csrc/cg3.cu`` that one call of each
#: entry launches, in order
KERNELS = {"dot": ("dot_kernel", "finish_kernel"),
           "update": ("update_kernel", "finish_kernel"),
           "direction": ("direction_kernel",)}
#: blocks an SM holds at most (``kMaxBlocksPerSm`` of ``csrc/cg3.cu``):
#: the partials buffer has this many values an SM
BLOCKS_PER_SM = 8

#: entry calls since the last :func:`reset_launch_count`, all entries
launch_count = 0
#: each entry's calls since the last :func:`reset_launch_count`
calls = dict.fromkeys(KERNELS, 0)


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0
    calls.update(dict.fromkeys(KERNELS, 0))


def _lib() -> ctypes.CDLL:
    return cuda_build.load("cg3", SOURCES, SIGNATURES)


def build() -> Path:
    """Compile (if needed) and load C3 (K0 probes it); returns the
    library's path."""
    _lib()
    return cuda_build.library_path("cg3", cuda_build.library_sources(SOURCES))


def takes(*tensors) -> bool:
    """Whether C3 runs on ``tensors``: CUDA tensors of one device and one
    dtype of :data:`DTYPE_CODES`, contiguous, the vectors (all but the 0-d
    scalars) of one shape."""
    if not tensors or not all(isinstance(t, torch.Tensor) for t in tensors):
        return False
    t0 = tensors[0]
    vectors = {tuple(t.shape) for t in tensors if t.dim() > 0}
    return (t0.device.type == "cuda" and t0.dtype in DTYPE_CODES
            and len(vectors) <= 1
            and all(t.device == t0.device and t.dtype == t0.dtype
                    and t.is_contiguous() for t in tensors))


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(*tensors) -> None:
    """Raises unless :func:`takes` ``tensors``, and where autograd would
    record a tensor that requires grad (C3 has no backward)."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise ValueError("C3 has no backward: its tensors must not "
                         "require grad (run it under torch.no_grad())")
    if not takes(*tensors):
        raise ValueError(
            f"C3 runs contiguous float32, float64, bfloat16 and float16 "
            f"CUDA tensors of one device, dtype and shape, got "
            f"{[(tuple(t.shape), t.dtype, str(t.device)) for t in tensors]}")


def _call(entry: str, v: torch.Tensor, ptrs) -> None:
    """One call of ``cudecomp_cg_<entry>`` on ``ptrs`` (the entry's
    pointers in order, outputs and scratch included) for vectors like
    ``v``."""
    global launch_count
    lib = _lib()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = getattr(lib, f"cudecomp_cg_{entry}")(
            *ptrs, v.numel(), _sms(v.device), DTYPE_CODES[v.dtype], stream)
    if err != 0:
        msg = lib.cudecomp_cuda_error_string(err).decode()
        raise RuntimeError(f"C3 ({entry}) launch failed for "
                           f"{tuple(v.shape)} {v.dtype}: {msg} ({err})")
    launch_count += 1
    calls[entry] += 1


def _scalar(v: torch.Tensor) -> torch.Tensor:
    return torch.empty((), dtype=v.dtype, device=v.device)


def _partials(v: torch.Tensor) -> torch.Tensor:
    return torch.empty(_sms(v.device) * BLOCKS_PER_SM, dtype=torch.float64,
                       device=v.device)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum(a * b)`` in one pass: a new 0-d tensor of their dtype."""
    _check(a, b)
    out, part = _scalar(a), _partials(a)
    _call("dot", a, [t.data_ptr() for t in (a, b, out, part)])
    return out


def update(u, p, r, ap, rs, pap):
    """``alpha = rs / pap`` (0 unless ``pap > 0``), ``u + alpha p``, ``r -
    alpha ap`` and ``sum`` of the new ``r * r``, in one pass:
    ``(u', r', alpha, rr)``, all new, ``alpha`` and ``rr`` 0-d."""
    _check(u, p, r, ap, rs, pap)
    u2, r2, alpha, rr = (torch.empty_like(u), torch.empty_like(r),
                         _scalar(u), _scalar(u))
    part = _partials(u)
    _call("update", u,
          [t.data_ptr() for t in (u, p, r, ap, rs, pap, u2, r2, alpha, rr,
                                  part)])
    return u2, r2, alpha, rr


def direction(r, p, rs_new, rs):
    """``beta = rs_new / rs`` (0 unless ``rs > 0``) and ``r + beta p`` in
    one pass: a new tensor."""
    _check(r, p, rs_new, rs)
    out = torch.empty_like(p)
    _call("direction", p,
          [t.data_ptr() for t in (r, p, rs_new, rs, out)])
    return out
