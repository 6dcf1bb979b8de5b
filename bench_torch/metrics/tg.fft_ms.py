"""Device time per Taylor-Green step in the program's ``fft3d_forward``
and ``fft3d_inverse`` spans under ``tg_step``: cuFFT's r2c and c2r
transforms and the copies torch makes around them."""

from bench_torch import spans


def read(t):
    fft = lambda n: n in (spans.PREFIX + "fft3d_forward",
                          spans.PREFIX + "fft3d_inverse")
    return spans.per_iteration(
        t, lambda s: spans.span_ms(s, fft, under=spans.PREFIX + "tg_step"))
