"""``PoissonSolver.solve_cg`` of cudecomp_tpu_torch against the JAX
package's on the same rhs: the same iteration count, solutions within
1e-9 (float64).  One rank here; the 4-rank cases, which sum the dot
products over the ranks, run in ``test_torch_slice.py``.  The spectral
solve is held to JAX in ``test_torch_models.py``.

The resumable iteration that ``solve_cg`` runs (``cg_init``,
``cg_iterate``) against ``solve_cg`` itself, one iteration against the
benchmark's plain float64 reference (``bench_torch/reference/cg7.py``),
and the iteration's spans and byte counts."""

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



# -- the resumable iteration (PoissonSolver.cg_init / cg_iterate) ------------

CASES = [
    ((10, 8, 12), None, {}),
    ((8, 10, 12), (1.0, 2.0, 3.0), {}),
]


@pytest.mark.parametrize("gdims,lengths,kw", CASES)
@pytest.mark.parametrize("chunks", [(1,), (3, 5, 8)])
def test_cg_iterate_in_chunks_is_solve_cg(gdims, lengths, kw, chunks):
    # the iteration resumed from its state, in chunks of any length, runs
    # solve_cg's iterations: the same count and the same u, bit for bit
    _, ts = solvers(gdims, lengths, **kw)
    f = torch.randn(gdims, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(4))
    want, iters, rel = ts.solve_cg(f, tol=1e-11, check_every=8)
    state, k = ts.cg_init(f), 0
    while state.it < iters:
        for _ in range(chunks[k % len(chunks)]):
            before = (state.u.clone(), state.r.clone(), state.p.clone())
            nxt = ts.cg_iterate(state, 8)
            # the input state is left as it was: a caller may keep it
            assert all(torch.equal(a, b) for a, b in
                       zip(before, (state.u, state.r, state.p)))
            state = nxt
        k += 1
    assert state.it == iters and state.rel_residual == rel
    assert torch.equal(state.u - ts._mean(state.u), want)


@pytest.mark.parametrize("check_every", [1, 5, 64])
def test_cg_iterate_reads_the_host_on_its_cadence(check_every):
    _, ts = solvers((8, 8, 8))
    f = torch.randn((8, 8, 8), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(5))
    state = ts.cg_init(f)
    assert state.alpha is None and state.it == 0
    assert state.rs_host == pytest.approx(state.bnorm ** 2)
    for _ in range(12):
        old = state.rs_host
        state = ts.cg_iterate(state, check_every)
        read = state.it % check_every == 0
        assert state.rs_host == (float(state.rs) if read else old)


@pytest.mark.parametrize("dtype,tol", [
    (torch.float64, 1e-12),
    # float32: each value compared is a few rounded operations from the
    # same input (the 7-tap sum, the scale, a product, an add) and two
    # pairwise sums over under 2**15 cells (alpha, r . r), about 16
    # roundings of 2**-24 at most; the tolerance is 4x that
    (torch.float32, 4e-6),
])
@pytest.mark.parametrize("gdims,lengths", [
    # uniform spacings at a non-cubic size: laplacian7 and the scale pass
    ((12, 10, 16), (12.0, 10.0, 16.0)),
    # anisotropic spacings: the weighted stencil_apply matvec
    ((12, 10, 16), (2 * np.pi,) * 3),
])
def test_one_iteration_against_the_plain_reference(dtype, tol, gdims,
                                                   lengths):
    from bench_torch.reference import cg7

    _, ts = solvers(gdims, lengths)
    f = torch.randn(gdims, dtype=dtype,
                    generator=torch.Generator().manual_seed(6))
    state = ts.cg_init(f)
    for _ in range(7):
        state = ts.cg_iterate(state)
    nxt = ts.cg_iterate(state)
    u, r, p, rs, alpha = cg7.iteration(
        state.u, state.r, state.p, float(state.rs),
        cg7.weights(gdims, lengths), block=5)
    for got, want in ((nxt.u, u), (nxt.r, r), (nxt.p, p)):
        assert got.dtype == dtype
        assert float((got.double() - want).abs().max()
                     / want.abs().max()) <= tol
    assert abs(float(nxt.rs) - rs) <= tol * rs
    assert abs(float(nxt.alpha) - alpha) <= tol * alpha


@pytest.mark.parametrize("gdims,lengths,matvec_items", [
    ((8, 8, 8), None, 4),              # laplacian7 and the -1/h^2 pass
    ((8, 10, 12), (1.0, 2.0, 3.0), 2),  # one weighted stencil_apply pass
])
def test_cg_spans_and_their_bytes(gdims, lengths, matvec_items):
    from torch.profiler import profile

    from cudecomp_tpu_torch.utils import tracing

    P = tracing.PREFIX
    _, ts = solvers(gdims, lengths)
    f = torch.randn(gdims, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(7))
    tracing.clear_spans()
    try:
        with profile():
            ts.solve_cg(f, tol=1e-30, maxiter=12, check_every=4)
        spans = tracing.spans()
    finally:
        tracing.clear_spans()
    v = 8 * int(np.prod(gdims))
    (top,) = [i for i, s in enumerate(spans) if s.parent is None]
    assert spans[top].name == P + "poisson_solve_cg"
    iters = [i for i, s in enumerate(spans) if s.name == P + "cg_iter"]
    assert len(iters) == 12 and all(spans[i].parent == top for i in iters)
    for k, i in enumerate(iters):
        kids = [j for j, s in enumerate(spans) if s.parent == i]
        names = [spans[j].name[len(P):] for j in kids]
        want = ["cg_matvec", "cg_dot", "cg_update", "cg_dot", "cg_update"]
        # one host check every check_every iterations, at the 4th, 8th, 12th
        assert names == want + ["cg_check"] * ((k + 1) % 4 == 0)
        counted = [spans[j].counts.get("bytes") for j in kids]
        assert counted[:5] == [None, 4 * v, None, 3 * v, None]
        # the matvec's passes (2 or 4 v), the dots' (4 v, 3 v), the
        # updates': a product and a sum for u and r, one for p (15 v)
        assert spans[i].counts == {"bytes": (matvec_items + 22) * v}
        # K4's pass sits inside the matvec, as it does in every stencil op
        assert sum(s.name == P + "stencil_pass" and _under(spans, s, kids[0])
                   for s in spans) == 1
    assert sum(s.name == P + "cg_check" for s in spans) == 3


def _under(spans, s, i):
    """Whether span ``s`` lies inside span ``i``."""
    while s.parent is not None:
        if s.parent == i:
            return True
        s = spans[s.parent]
    return False
