"""Device time per Poisson solve in the ``dft2`` spans: K5's two launches,
the (Y, Z) transform of the half spectrum forward and inverse."""

from bench_torch import poisson_work


def read(t):
    return poisson_work.per_solve_ms(t, "dft2")
