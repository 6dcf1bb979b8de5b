"""Timing on the card (the ``time_fn`` part of ``cudecomp_tpu.performance``).

The reference times with CUDA events after warm-up (``src/autotune.cc:
541-626``); so does this module.  A time is a device time: without CUDA
there is nothing to measure, and :func:`time_fn` raises.
"""

from __future__ import annotations

from typing import Callable, List

import torch


def time_fn(fn: Callable, *args, n_warmup: int = 3, n_trials: int = 5,
            iters: int = 1) -> List[float]:
    """Seconds per call of ``fn(*args)`` for each of ``n_trials`` trials.

    Each trial records a CUDA event, makes ``iters`` calls on the current
    stream, records a second event and waits for it; the trial's time is
    the events' elapsed time over ``iters``.  ``n_warmup`` untimed calls
    come first.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("time_fn measures device time and needs CUDA")
    for _ in range(n_warmup):
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(n_trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / iters)
    return times
