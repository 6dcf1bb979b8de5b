"""Device time per CG iteration in the two ``cg_dot`` spans: the products
``p * Ap`` and ``r * r`` and their sums over the grid."""

from bench_torch import cg_work


def read(t):
    return cg_work.per_iteration_ms(t, "cg_dot")
