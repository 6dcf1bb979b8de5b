"""Benchmark — distributed 3D c2c FFT round trip on one GPU.

Methodology of the reference FFT benchmark (``benchmark/benchmark.cu:
501-665``): forward+inverse round trips of complex64 data in cuFFT's
native interleaved layout, the time halved for one direction, and
GFLOPS = 5 * N^3 * log2(N^3) / t.  The grid is ``pdims (1, 1)`` with
axis-contiguous pencils by default, so each 1D FFT runs along the
contiguous axis and the four slab transposes of a round trip each run
the K1 local-permute kernel.

One round trip is gated at the reference's single-precision tolerance,
max abs error < 5e-4 (``benchmark.cu:23-27``), before timing, and the
output of the timed run is held to the same gate.  Times are CUDA-event
times (``performance.time_fn``); the rate is all timed round trips over
all the time they took, and the per-trial times are reported beside it.

Run: ``python -m cudecomp_tpu_torch.bench [N] [iters]``; prints one JSON
line.
"""

from __future__ import annotations

import json
import math
import sys

import torch

from cudecomp_tpu_torch.config import GridConfig
from cudecomp_tpu_torch.grid import make_grid
from cudecomp_tpu_torch.ops.fft import DistributedFFT
from cudecomp_tpu_torch.performance import time_fn

GATE = 5e-4


def make_plan(N: int, axis_contiguous: bool = True, device="cuda",
              real: bool = False) -> DistributedFFT:
    """The benchmark's plan: an N^3 grid on one rank (``pdims (1, 1)``)."""
    ac = bool(axis_contiguous)
    cfg = GridConfig(gdims=(N, N, N), pdims=(1, 1),
                     transpose_axis_contiguous=(ac, ac, ac))
    return DistributedFFT(grid=make_grid(cfg, device), real=real)


def make_field(grid, seed: int = 0, dtype=torch.complex64) -> torch.Tensor:
    """Standard-normal real and imaginary parts (or real values, for a
    real ``dtype``) in the grid's X-pencil layout, from a seeded generator
    on the grid's device."""
    gen = torch.Generator(device=grid.device)
    gen.manual_seed(seed)
    shape = grid.buffer_shape(0)
    if dtype.is_complex:
        parts = torch.randn(shape + (2,), generator=gen, device=grid.device,
                            dtype=dtype.to_real())
        return torch.view_as_complex(parts)
    return torch.randn(shape, generator=gen, device=grid.device, dtype=dtype)


def cycle(plan: DistributedFFT, x: torch.Tensor) -> torch.Tensor:
    """One forward + inverse round trip."""
    return plan.inverse(plan.forward(x))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def _gate(err: float, what: str) -> None:
    if not err < GATE:
        raise RuntimeError(f"{what}: max abs err {err} is not < {GATE}")


def main(N: int = 512, iters: int = 20, n_trials: int = 3,
         axis_contiguous: bool = True) -> dict:
    """Time the N^3 c2c round trip on the current GPU; returns and prints
    the result."""
    if not torch.cuda.is_available():
        raise RuntimeError("the benchmark measures the GPU and needs CUDA")
    plan = make_plan(N, axis_contiguous, "cuda")
    x = make_field(plan.grid, seed=0)
    err = max_abs_err(cycle(plan, x), x)
    _gate(err, "gate round trip")

    last = {}

    def timed():
        last["y"] = cycle(plan, x)

    times = time_fn(timed, n_warmup=2, n_trials=n_trials, iters=iters)
    timed_err = max_abs_err(last["y"], x)
    _gate(timed_err, "timed round trip")

    # all the work over the whole timed window; the trials show the spread
    t = sum(times) / len(times) / 2.0  # one direction
    n_total = N ** 3
    gflops = 5.0 * n_total * math.log2(n_total) / t / 1e9
    payload = {
        "metric": f"{N}^3 c2c FFT single-direction (complex64, pdims (1, 1), "
                  f"{'axis-contiguous' if axis_contiguous else 'natural'})",
        "value": gflops,
        "unit": "GFLOPS",
        "ms_per_direction": t * 1e3,
        "round_trip_ms_trials": [s * 1e3 for s in times],
        "gate_err": err,
        "timed_err": timed_err,
        "device": torch.cuda.get_device_name(0),
    }
    print(json.dumps(payload))
    return payload


if __name__ == "__main__":
    kw = {}
    if len(sys.argv) > 1:
        kw["N"] = int(sys.argv[1])
    if len(sys.argv) > 2:
        kw["iters"] = int(sys.argv[2])
    main(**kw)
