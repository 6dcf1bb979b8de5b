"""Autotuned distributed FFT: an autotuned grid, the split-complex round
trip with its error and speed, and ``autotune_fft``'s plan-policy search
(the FFT benchmark skeleton of the reference, benchmark/benchmark.cu).

    python -m cudecomp_tpu_torch.examples.fft_autotune [--device cpu] [--ranks N] [--n N]
"""

import math

import numpy as np
import torch

import cudecomp_tpu_torch as ct
from cudecomp_tpu_torch import performance
from cudecomp_tpu_torch.examples import _launch
from cudecomp_tpu_torch.ops.fft import DistributedFFT


def run(a, rank: int) -> None:
    device = _launch.device_of(a)
    n = a.n
    cfg = ct.GridConfig(gdims=(n, n, n), pdims=(0, 0),
                        transpose_axis_contiguous=(True, True, True))
    grid = ct.make_grid(cfg, device, autotune_options=ct.AutotuneOptions(
        n_warmup=1, n_trials=2))
    _launch.say(rank, f"autotuned pdims={grid.pdims} method="
                      f"{grid.config.transpose_method.value}")

    plan = DistributedFFT(grid=grid, split_complex=True)
    rng = np.random.default_rng(0)
    f = (rng.standard_normal(cfg.gdims)
         + 1j * rng.standard_normal(cfg.gdims)).astype(np.complex64)
    # split-complex: the (re, im) pairs as a trailing dim of 2
    x = torch.view_as_real(ct.scatter_global(grid, torch.from_numpy(f), 0))

    def roundtrip(v):
        return plan.inverse(plan.forward(v))

    err = float((roundtrip(x) - x).abs().max())
    _launch.say(rank, f"round-trip max err: {err:.3e}")
    assert err < 5e-4, err  # the reference's single-precision gate
    # the forward against numpy's complex128 FFT
    got = _launch.gather(grid, torch.view_as_complex(plan.forward(x)), 2)
    want = np.fft.fftn(f.astype(np.complex128))
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 1e-5, rel
    dt = float(np.mean(performance.time_fn(plan.forward, x, n_warmup=1,
                                           n_trials=3, device=device)))
    gflops = 5 * n ** 3 * math.log2(n ** 3) / dt / 1e9
    _launch.say(rank, f"one direction: {dt * 1e3:.3f} ms ({gflops:.1f} "
                      f"GFLOPS), forward rel L2 vs numpy {rel:.2e}")

    # the plan-level policy search: gate-check and time cuFFT alone and K5
    # for the (1, 2) pair, and pin the fastest that passes
    res = ct.autotune_fft(grid, n_warmup=1, n_trials=2, iters=4)
    _launch.say(rank, res.report())


def main(argv=None) -> float:
    a = _launch.parse(__doc__, 64, argv)
    secs = _launch.main("cudecomp_tpu_torch.examples.fft_autotune", a)
    print(f"fft_autotune: {secs:.3f} s")
    return secs


if __name__ == "__main__":
    main()
