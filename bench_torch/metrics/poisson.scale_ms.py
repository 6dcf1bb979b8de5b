"""Device time per Poisson solve in the ``poisson_scale`` span: the two
plane products of the half spectrum by ``-1/|k|^2``."""

from bench_torch import poisson_work


def read(t):
    return poisson_work.per_solve_ms(t, "poisson_scale")
