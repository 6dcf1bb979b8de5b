"""The exchanges' rate, GB/s: the ``bytes`` the program's exchange spans
count (what this rank sends to other ranks) over those spans' device
time, waiting for peers included, as NCCL's kernel includes it."""

from bench_torch import spans


def read(t):
    w = spans.window(t)
    return None if w is None else spans.exchange_gbps(w[0])
