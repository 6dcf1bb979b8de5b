"""Device time per Taylor-Green step that is not cuFFT: the solver's and
the spectral operators' elementwise work (curl, cross product, dealiasing,
projection, the RK4 combinations), stacks and copies."""

from bench_torch.trace import is_cufft


def read(t):
    if t.trace.total_ms() <= 0:
        return None
    return t.trace.ms(lambda op: not is_cufft(op)) / t.iterations
