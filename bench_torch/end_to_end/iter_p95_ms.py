"""The 95th percentile of every iteration's time in the window, each
timed by CUDA events recorded on the stream between iterations (a device
gap counts against the next iteration)."""

from bench_torch.yardstick import percentile


def read(w):
    if not w.iter_ms:
        return None
    return percentile(w.iter_ms, 95)
