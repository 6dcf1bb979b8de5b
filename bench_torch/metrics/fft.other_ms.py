"""Device time per round trip that is neither cuFFT, K1 nor an NCCL
exchange: the 1/N scale passes, copies, the packing around exchanges."""

from bench_torch.trace import is_cufft, is_k1, is_nccl


def read(t):
    total = t.trace.total_ms()
    if total <= 0:
        return None
    other = t.trace.ms(lambda op: not (is_cufft(op) or is_k1(op)
                                       or is_nccl(op)))
    return other / t.iterations
