"""Device time per Taylor-Green step in the program's ``tg_curl`` spans:
the spectral curl of the velocity (``SpectralOperators.curl``), four a
step."""

from bench_torch import spans


def read(t):
    return spans.per_iteration(
        t, lambda s: spans.span_ms(s, spans.named("tg_curl")))
