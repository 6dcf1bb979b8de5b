"""NCCL's device time per round trip (the all-to-all exchanges of the
transposes)."""

from bench_torch.trace import is_nccl


def read(t):
    ms = t.trace.ms(is_nccl)
    return ms / t.iterations if ms > 0 else None
