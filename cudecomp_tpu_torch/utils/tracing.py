"""Tracing hooks — the NVTX analog (``include/internal/nvtx.h:31-56``).

Every public op wraps its body in :func:`trace_range`, which opens a
``torch.profiler.record_function`` range (visible in ``torch.profiler``
traces, where ``performance.device_op_attribution`` charges the kernels
to it) and, while CUDA is initialized, an NVTX range of the same name.
``CUDECOMP_TPU_DISABLE_TRACING=1``, read at import, makes it a no-op.
"""

from __future__ import annotations

import contextlib

import torch

from cudecomp_tpu_torch.utils import env

_DISABLED = env.tracing_disabled()

#: the library's trace ranges start with PREFIX; the exchanges' with
#: EXCHANGE_PREFIX (``performance.device_op_attribution`` counts the
#: device time inside those as communication)
PREFIX = "cudecomp_tpu_torch."
EXCHANGE_PREFIX = PREFIX + "exchange."


@contextlib.contextmanager
def trace_range(name: str):
    """Named range for profiler traces and, on CUDA, for NVTX."""
    if _DISABLED:
        yield
        return
    nvtx = torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
