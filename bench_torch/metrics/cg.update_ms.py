"""Device time per CG iteration in the two ``cg_update`` spans: alpha,
``u`` and ``r``, then beta and ``p``, with the guarded divisions' scalar
kernels."""

from bench_torch import cg_work


def read(t):
    return cg_work.per_iteration_ms(t, "cg_update")
