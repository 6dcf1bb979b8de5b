"""cuFFT's device time per Taylor-Green step (the r2c and c2r transforms
of the solver's distributed FFT)."""

from bench_torch.trace import is_cufft


def read(t):
    ms = t.trace.ms(is_cufft)
    return ms / t.iterations if ms > 0 else None
