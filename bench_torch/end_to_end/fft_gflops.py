"""cuDecomp's FFT rate, 5 n log2(n) / t (``benchmark/benchmark.cu:658``):
n the grid's points, t the whole window over twice the round trips
completed in it (a round trip is a forward and an inverse)."""

from bench_torch.yardstick import fft_gflops


def read(w):
    n = w.work.get("fft_points")
    if not n or not w.iterations:
        return None
    return fft_gflops(n, w.seconds / (2 * w.iterations))
