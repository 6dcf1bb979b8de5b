"""Device time per CG iteration in the ``cg_matvec`` span: the K4 pass of
``laplacian7`` and the ``-1/h^2`` scale pass."""

from bench_torch import cg_work


def read(t):
    return cg_work.per_iteration_ms(t, "cg_matvec")
