"""Device time per Poisson solve outside K5, cuFFT and the spectral
multiply: the ``poisson_solve`` span less the ``dft2`` and
``poisson_scale`` spans and cuFFT's kernels.  What is left is the complex
rebuild of the scaled planes, the c2r input copy, the one 1/N pass, the
zeroed imaginary parts of c2r's real bins, and the device's idle time
inside the solve."""

from bench_torch import poisson_work
from bench_torch.trace import is_cufft


def read(t):
    solve = poisson_work.per_solve_ms(t, "poisson_solve")
    k5 = poisson_work.per_solve_ms(t, "dft2")
    scale = poisson_work.per_solve_ms(t, "poisson_scale")
    cufft = t.trace.ms(is_cufft) / t.iterations
    if solve is None or k5 is None or scale is None or cufft <= 0:
        return None
    return solve - k5 - scale - cufft
