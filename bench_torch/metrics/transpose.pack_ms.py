"""Device time per round trip in the program's ``transpose_pack`` spans:
the transposes' copies of the pencil into per-peer blocks before each
exchange."""

from bench_torch import spans


def read(t):
    return spans.per_iteration(
        t, lambda s: spans.span_ms(s, spans.named("transpose_pack")))
