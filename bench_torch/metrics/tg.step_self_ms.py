"""Device self time per Taylor-Green step of the program's ``tg_step``
span: the step less its ``tg_nonlinear`` children, that is the RK4 stage
sums and the viscous term."""

from bench_torch import spans


def read(t):
    return spans.per_iteration(
        t, lambda s: spans.self_ms(s, spans.PREFIX + "tg_step"))
