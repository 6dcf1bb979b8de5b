"""cuFFT's device time per round trip: every kernel launched inside one of
torch's FFT ops (``trace.is_cufft``)."""

from bench_torch.trace import is_cufft


def read(t):
    ms = t.trace.ms(is_cufft)
    return ms / t.iterations if ms > 0 else None
