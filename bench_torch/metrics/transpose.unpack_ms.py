"""Device time per round trip in the program's ``transpose_unpack``
spans: the transposes' reassembly of the received blocks into the output
pencil after each exchange."""

from bench_torch import spans


def read(t):
    return spans.per_iteration(
        t, lambda s: spans.span_ms(s, spans.named("transpose_unpack")))
