"""``PoissonSolver.solve_cg`` of cudecomp_tpu_torch against the JAX
package's on the same rhs: the same iteration count, solutions within
1e-9 (float64).  One rank here; the 4-rank cases, which sum the dot
products over the ranks, run in ``test_torch_slice.py``.  The spectral
solve is held to JAX in ``test_torch_models.py``.

The resumable iteration that ``solve_cg`` runs (``cg_init``,
``cg_iterate``) against ``solve_cg`` itself, one iteration against the
benchmark's plain float64 reference (``bench_torch/reference/cg7.py``),
the matvec with its ``1/h^2`` folded into K4's weights, and the
iteration's spans and byte counts.  C3, the iteration's passes on the
card, is held to these formulas in ``test_torch_cg_kernel.py``."""

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
    # anisotropic spacings: 1/h_d^2 in the matvec's weights, laid out in
    # memory order
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
    assert not np.allclose(hs, hs[0])  # anisotropic: 1/h_d^2 in the weights
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
    # same input (the weighted 7-tap sum, a product, an add) and two
    # pairwise sums over under 2**15 cells (alpha, r . r), about 16
    # roundings of 2**-24 at most; the tolerance is 4x that
    (torch.float32, 4e-6),
])
@pytest.mark.parametrize("gdims,lengths", [
    # uniform spacings at a non-cubic size: -1/h^2 in K4's weights
    ((12, 10, 16), (12.0, 10.0, 16.0)),
    # anisotropic spacings: 1/h_d^2 in the weights
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


@pytest.mark.parametrize("gdims,lengths", [
    ((8, 8, 8), None),             # uniform: -1/h^2 in K4's weights
    ((8, 10, 12), (1.0, 2.0, 3.0)),  # anisotropic: 1/h_d^2 in the weights
])
def test_cg_spans_and_their_bytes(gdims, lengths):
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
        # r . r sits inside the first update, as in C3's pass
        want = ["cg_matvec", "cg_dot", "cg_update", "cg_update"]
        # one host check every check_every iterations, at the 4th, 8th, 12th
        assert names == want + ["cg_check"] * ((k + 1) % 4 == 0)
        counted = [spans[j].counts.get("bytes") for j in kids]
        # the formulas on the CPU: p * Ap and its sum (4 v); two products,
        # two sums, r * r and its sum (13 v); a product and a sum (5 v)
        assert counted[:4] == [None, 4 * v, 13 * v, 5 * v]
        # and the matvec's one pass (2 v); kernel 0: no C3 on the CPU
        assert spans[i].counts == {"bytes": 24 * v, "kernel": 0}
        # K4's pass sits inside the matvec, as it does in every stencil op
        assert sum(s.name == P + "stencil_pass" and _under(spans, s, kids[0])
                   for s in spans) == 1
    assert sum(s.name == P + "cg_check" for s in spans) == 3


@pytest.mark.parametrize("gdims,lengths,kw", [
    ((12, 10, 16), (12.0, 10.0, 16.0), {}),     # uniform, h = 1
    ((8, 8, 8), None, {}),                       # uniform, h = 2 pi / 8
    ((8, 10, 12), (1.0, 2.0, 3.0), {}),          # anisotropic
    ((8, 10, 12), (1.0, 2.0, 3.0),               # anisotropic, memory order
     {"transpose_axis_contiguous": (True, True, True)}),
])
def test_the_folded_matvec_is_minus_the_scaled_laplacian(gdims, lengths, kw):
    # one K4 pass with 1/h_d^2 in its weights: -(1/h^2) laplacian7 for
    # uniform spacings, -sum_d (roll + roll - 2 v) / h_d^2 in general
    from cudecomp_tpu_torch.ops.stencil import laplacian7

    _, ts = solvers(gdims, lengths, **kw)
    v = torch.randn(ts.grid.buffer_shape(0), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(8))
    got = ts._cg_matvec()(v)
    L = lengths or (2 * np.pi,) * 3
    hs = [L[d] / gdims[d] for d in range(3)]
    order = ts.grid.config.mem_order(0)
    want = -sum((torch.roll(v, 1, d) + torch.roll(v, -1, d) - 2 * v)
                / hs[order[d]] ** 2 for d in range(3))
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-12 * scale
    if np.allclose(hs, hs[0]):
        assert isinstance(ts._cache["cg_op"], float)
        lap = -(1.0 / hs[0] ** 2) * laplacian7(ts.grid, v)
        assert float((got - lap).abs().max()) <= 1e-12 * scale


@pytest.mark.parametrize("inv_h2", [
    (1024 / (2 * np.pi)) ** 2,           # the cg1024.iter cell
    (160 / (2 * np.pi)) ** 2, 1.0, 0.25, (37 / 3.7) ** 2, 2.0 ** 40 / 3,
    # anisotropic: 1/h_d^2 per memory dim
    ((8 / 1.0) ** 2, (10 / 2.0) ** 2, (12 / 3.0) ** 2),
    ((1024 / 6.0) ** 2, 3.3, (7 / 0.1) ** 2),
])
@pytest.mark.parametrize("bits,dtype", [(24, np.float32), (53, np.float64)])
def test_the_folded_weights_cancel_in_the_kernels_precision(inv_h2, bits,
                                                            dtype):
    # every weight exact in the kernel's precision, every partial sum
    # exact, the sum 0: a constant field goes to exactly 0
    from cudecomp_tpu_torch.models.poisson import _cg_weights
    from cudecomp_tpu_torch.ops import stencil_kernel as K

    inv = (inv_h2,) * 3 if isinstance(inv_h2, float) else inv_h2
    w = _cg_weights(inv_h2, bits)
    assert w.shape == (3, 3, 3) and not w.flags.writeable
    assert np.array_equal(w.astype(dtype).astype(np.float64), w)
    taps = [t for _, t in K.taps(w)]
    acc, exact = dtype(0), 0.0
    for t in taps:
        acc, exact = dtype(acc + dtype(t)), exact + t
        assert float(acc) == exact
    assert exact == 0.0 and len(taps) == 7
    for d in range(3):
        lo = [1, 1, 1]
        lo[d] = 0
        assert w[tuple(lo)] == w[tuple(2 - np.array(lo))]
        assert abs(-w[tuple(lo)] / inv[d] - 1) <= 12 * 2.0 ** -bits * max(
            inv) / inv[d]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_matvec_takes_a_constant_to_zero(dtype):
    # at the cell's spacing (h = 2 pi / 1024) on a 16^3 box; rounded each
    # to its nearest float32, centre and faces would leave -0.0039
    _, ts = solvers((16, 16, 16), (16 * 2 * np.pi / 1024,) * 3)
    out = ts._cg_matvec()(torch.full((16, 16, 16), 3.0, dtype=dtype))
    assert out.dtype == dtype and not bool(out.any())
    h = 2 * np.pi / 1024
    assert float(np.float32(6 / h ** 2)) + 6 * float(np.float32(-1 / h ** 2)) \
        == -0.00390625


def test_the_iteration_takes_the_formulas_on_the_cpu():
    # C3 runs CUDA states only; on the CPU its wrapper raises, and the
    # iteration calls none of it
    from cudecomp_tpu_torch.ops import cg_kernel as C3

    _, ts = solvers((8, 8, 8))
    f = torch.randn((8, 8, 8), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(9))
    state = ts.cg_init(f)
    assert not C3.takes(state.u, state.r, state.p, state.rs)
    assert not C3.takes(state.u.half())
    assert not C3.takes()
    before = C3.launch_count
    for _ in range(3):
        state = ts.cg_iterate(state)
    assert C3.launch_count == before
    for call, args in ((C3.dot, (state.p, state.p)),
                       (C3.direction, (state.r, state.p, state.rs,
                                       state.rs))):
        with pytest.raises(ValueError, match="C3 runs"):
            call(*args)


def test_c3_refuses_a_tensor_that_requires_grad():
    # C3 has no backward: under autograd it raises before it looks at the
    # device, rather than drop the gradient; under no_grad the same
    # tensors meet the device check
    from cudecomp_tpu_torch.ops import cg_kernel as C3

    x = torch.ones((4, 4, 4), requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        C3.dot(x, x.detach())
    with torch.no_grad(), pytest.raises(ValueError, match="C3 runs"):
        C3.dot(x, x.detach())


def test_cg_init_makes_a_strided_right_hand_side_contiguous():
    # a transposed f gives a contiguous state, which C3 takes on the card,
    # and the iterations of its contiguous copy (the mean of f summed in
    # another order: to 1e-12)
    _, ts = solvers((8, 8, 8))
    g = torch.randn((8, 8, 8), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(10))
    f = g.transpose(0, 2)
    assert not f.is_contiguous()
    state, want = ts.cg_init(f), ts.cg_init(f.contiguous())
    assert all(t.is_contiguous() for t in (state.u, state.r, state.p))
    for _ in range(3):
        state, want = ts.cg_iterate(state), ts.cg_iterate(want)
    for got, exp in ((state.u, want.u), (state.r, want.r)):
        assert float((got - exp).abs().max()) <= 1e-12 * float(
            exp.abs().max())


def _under(spans, s, i):
    """Whether span ``s`` lies inside span ``i``."""
    while s.parent is not None:
        if s.parent == i:
            return True
        s = spans[s.parent]
    return False
