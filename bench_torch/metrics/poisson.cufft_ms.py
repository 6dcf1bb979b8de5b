"""cuFFT's device time per Poisson solve: the r2c and c2r transforms along
X (the kernels launched inside ``aten::_fft_r2c`` and ``_fft_c2r``)."""

from bench_torch.trace import is_cufft


def read(t):
    ms = t.trace.ms(is_cufft)
    return ms / t.iterations if ms > 0 else None
