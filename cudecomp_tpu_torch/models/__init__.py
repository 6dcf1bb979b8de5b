"""Applications on the pencil decomposition."""

from cudecomp_tpu_torch.models.poisson import PoissonSolver

__all__ = ["PoissonSolver"]
