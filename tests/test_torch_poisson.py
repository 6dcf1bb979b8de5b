"""``PoissonSolver.solve_cg`` of cudecomp_tpu_torch against the JAX
package's on the same rhs: the same iteration count, solutions within
1e-9 (float64).  One rank here; the 4-rank cases, which sum the dot
products over the ranks, run in ``test_torch_slice.py``.  The spectral
solve is held to JAX in ``test_torch_models.py``."""

import jax
import numpy as np
import pytest
import torch

import cudecomp_tpu as cd
from cudecomp_tpu.models import PoissonSolver as JPoisson

import cudecomp_tpu_torch as ct
from cudecomp_tpu_torch.ops import stencil_kernel as S


def solvers(gdims, lengths=None, **kw):
    kw_l = {} if lengths is None else {"lengths": lengths}
    jg = cd.make_grid(cd.GridConfig(gdims=gdims, pdims=(1, 1), **kw),
                      devices=jax.devices()[:1])
    tg = ct.make_grid(ct.GridConfig(gdims=gdims, pdims=(1, 1), **kw), "cpu")
    return JPoisson(grid=jg, **kw_l), ct.models.PoissonSolver(grid=tg, **kw_l)


@pytest.mark.parametrize("gdims,lengths,kw", [
    ((8, 8, 8), None, {}),
    ((10, 8, 12), None, {}),
    # anisotropic spacings: the weighted 7-tap stencil_apply matvec, laid
    # out in memory order
    ((8, 10, 12), (1.0, 2.0, 3.0),
     {"transpose_axis_contiguous": (True, True, True)}),
])
@pytest.mark.parametrize("check_every", [1, 8])
def test_solve_cg_matches_jax(gdims, lengths, kw, check_every):
    js, ts = solvers(gdims, lengths, **kw)
    f = np.random.default_rng(0).standard_normal(gdims)
    ju, jit, jrel = js.solve_cg(cd.scatter_global(js.grid, f, 0), tol=1e-11,
                                check_every=check_every)
    tu, it, rel = ts.solve_cg(ct.scatter_global(ts.grid, f, 0), tol=1e-11,
                              check_every=check_every)
    assert isinstance(it, int) and isinstance(rel, float)
    assert it == int(jit)
    assert rel <= 1e-11 and jrel <= 1e-11
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=1e-9)
    assert abs(float(tu.mean())) < 1e-12


def test_solve_cg_solves_the_discrete_system():
    # lap_h(u) = f - mean(f), recomputed with plain rolls
    _, ts = solvers((8, 12, 10))
    f = torch.randn((8, 12, 10), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    before = S.launch_count
    u, iters, rel = ts.solve_cg(f, tol=1e-10)
    assert S.launch_count == before  # CPU tensors take the plain version
    hs = [2 * np.pi / n for n in (8, 12, 10)]
    assert not np.allclose(hs, hs[0])  # anisotropic: the stencil_apply matvec
    lap_h = sum((torch.roll(u, 1, d) + torch.roll(u, -1, d) - 2 * u)
                / hs[d] ** 2 for d in range(3))
    b = f - f.mean()
    assert float(torch.linalg.vector_norm(lap_h - b)
                 / torch.linalg.vector_norm(b)) <= 1e-9
    assert iters % 64 == 0 and rel <= 1e-10


def test_maxiter_and_a_zero_rhs():
    _, ts = solvers((8, 8, 8))
    f = torch.randn((8, 8, 8), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2))
    u, iters, rel = ts.solve_cg(f, tol=1e-30, maxiter=5)
    assert iters == 5 and rel > 1e-30  # check_every is cut to maxiter
    u, iters, rel = ts.solve_cg(f, maxiter=0)
    assert iters == 0 and rel == 1.0 and not bool(u.any())
    u, iters, rel = ts.solve_cg(torch.ones((8, 8, 8), dtype=torch.float64),
                                check_every=4)
    assert iters == 4 and rel == 0.0 and not bool(u.any())

