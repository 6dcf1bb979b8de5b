"""Device time per Taylor-Green step in the program's ``tg_project``
spans: the 2/3-rule mask multiply and the Leray projection, four a
step."""

from bench_torch import spans


def read(t):
    return spans.per_iteration(
        t, lambda s: spans.span_ms(s, spans.named("tg_project")))
