"""Applications on the pencil decomposition: the Taylor-Green spectral
Navier-Stokes solver, the Poisson solver and the finite-difference
projection solver."""

from cudecomp_tpu_torch.models.incompressible import ProjectionSolver
from cudecomp_tpu_torch.models.poisson import PoissonSolver
from cudecomp_tpu_torch.models.taylor_green import TaylorGreenSolver

__all__ = ["PoissonSolver", "ProjectionSolver", "TaylorGreenSolver"]
