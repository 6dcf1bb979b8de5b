"""Tracing hooks — the NVTX analog (``include/internal/nvtx.h:31-56``).

Every public op wraps its body in :func:`trace_range`, which opens a
``torch.profiler.record_function`` range (visible in ``torch.profiler``
traces) and, while CUDA is initialized, an NVTX range of the same name.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def trace_range(name: str):
    """Named range for profiler traces and, on CUDA, for NVTX."""
    nvtx = torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
