"""Device time per Taylor-Green step in the program's ``tg_cross`` spans:
the three products of ``u x omega`` in physical space and their
``torch.stack``, four a step."""

from bench_torch import spans


def read(t):
    return spans.per_iteration(
        t, lambda s: spans.span_ms(s, spans.named("tg_cross")))
