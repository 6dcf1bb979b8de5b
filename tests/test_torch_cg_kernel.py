"""C3 on the card: the vector passes of a CG iteration, one kernel pass
each (``ops/cg_kernel.py``, ``csrc/cg3.cu``).

Every test here needs a CUDA card, skips without one and imports no JAX,
so they run with
``python -m pytest --noconftest -m gpu tests/test_torch_cg_kernel.py``.
They hold the kernel to the plain formulas of ``models/poisson.py``
(``_cg_update``, ``_cg_direction``) bit for bit in float32, float64,
bfloat16 and float16, at a ragged size, on vectors that are not 16-byte
aligned and with ``r`` and ``p`` one tensor (the first iteration); its
sums to float64 sums and to themselves across repeats; and ``cg_iterate``
on a CUDA state: three C3 calls an iteration in every dtype, new scalars
every iteration, the state it started from unwritten, the spans' counts,
``solve_cg`` to the CPU's solution, a strided right-hand side launching
C3, a state C3 cannot take (strided, or under autograd) raising.  Across
ranks: C3's sums reduced over two ranks that share the card (gloo), and
``solve_cg`` over four cards (NCCL; skips with fewer) against a one-rank
solve.
"""

import numpy as np
import pytest
import torch

import cudecomp_tpu_torch as ct
from cudecomp_tpu_torch.models import poisson as PS
from cudecomp_tpu_torch.ops import cg_kernel as C3
from cudecomp_tpu_torch.utils import tracing

P = tracing.PREFIX
RAGGED = (37, 41, 43)
#: float64 sums: per thread a chain of n / (threads) products, then a tree
#: of about 20 levels, each addition within 2^-53 of its terms' sum; in the
#: narrower dtypes one rounding of that sum to the dtype
SUM_EPS = {torch.float32: 2.0 ** -24, torch.float64: 1e-13,
           torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}
DTYPES = (torch.float32, torch.float64, torch.bfloat16, torch.float16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def vectors(device, shape, dtype, n, seed=0, aligned=True):
    """``n`` random vectors of ``shape``, values of about 1/4 (so that
    float16 sums of 64^3 squares stay finite); with ``aligned=False`` each
    a contiguous view one element into its storage (not 16-byte
    aligned)."""
    g = torch.Generator().manual_seed(seed)
    size = int(np.prod(shape))
    out = []
    for _ in range(n):
        base = torch.randn(size + 1, generator=g, dtype=torch.float64) / 4
        base = base.to(device=device, dtype=dtype)
        out.append((base[:-1] if aligned else base[1:]).view(shape))
    return out


def float64_sum(a, b):
    """The float64 sum of ``a * b`` and the sum of ``|a * b|``."""
    prod = a.double() * b.double()
    return float(prod.sum()), float(prod.abs().sum())


def assert_sum(got, a, b):
    want, mag = float64_sum(a, b)
    assert got.dtype == a.dtype and got.dim() == 0
    tol = SUM_EPS[a.dtype] * (mag if a.dtype == torch.float64
                              else abs(want))
    assert abs(float(got) - want) <= tol + 1e-13 * mag, (float(got), want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,aligned", [
    (RAGGED, True), (RAGGED, False), ((64, 64, 64), True)])
@pytest.mark.parametrize("aliased", [False, True])
def test_gpu_passes_give_the_formulas_bits(cuda, dtype, shape, aligned,
                                           aliased):
    u, p, r, ap = vectors(cuda, shape, dtype, 4, aligned=aligned)
    if aliased:
        r = p           # the first iteration: r and p one tensor
    rs = (r * r).sum()
    pap = C3.dot(p, ap)
    assert_sum(pap, p, ap)
    # a positive p . Ap, as the operator gives, and above rs: alpha < 1,
    # so that the new r . r stays finite in float16
    pap = pap.abs() + rs
    n0 = C3.launch_count
    u2, r2, alpha, rr = C3.update(u, p, r, ap, rs, pap)
    pu, pr, palpha, _ = PS._cg_update(u, p, r, ap, rs, pap)
    for got, want in ((u2, pu), (r2, pr), (alpha, palpha)):
        assert got.dtype == dtype and got.shape == want.shape
        assert torch.equal(got, want)
    assert_sum(rr, r2, r2)
    p2 = C3.direction(r2, p, rr, rs)
    assert torch.equal(p2, PS._cg_direction(r2, p, rr, rs))
    assert C3.launch_count - n0 == 2
    # every output new: nothing of the input written
    ins = {t.data_ptr() for t in (u, p, r, ap, rs, pap)}
    assert not ins & {t.data_ptr() for t in (u2, r2, alpha, rr, p2)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_gpu_guarded_divisions(cuda, dtype):
    # a denominator that is not positive gives 0: the state stays
    u, p, r, ap = vectors(cuda, RAGGED, dtype, 4, seed=1)
    one = torch.ones((), dtype=dtype, device=cuda)
    for den in (0.0, -1.0, float("nan")):
        den = torch.full((), den, dtype=dtype, device=cuda)
        u2, r2, alpha, _ = C3.update(u, p, r, ap, one, den)
        assert float(alpha) == 0.0
        assert torch.equal(u2, u) and torch.equal(r2, r)
        assert torch.equal(C3.direction(r, p, one, den), r)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gpu_sums_repeat_bit_for_bit(cuda, dtype):
    a, b, u, ap = vectors(cuda, (128, 96, 80), dtype, 4, seed=2)
    sums = {float(C3.dot(a, b)) for _ in range(5)}
    assert len(sums) == 1
    assert_sum(C3.dot(a, b), a, b)
    rs, pap = (a * a).sum(), (a * b).sum().abs()
    rrs = {float(C3.update(u, a, b, ap, rs, pap)[3]) for _ in range(5)}
    assert len(rrs) == 1


def cg_solver(device, n, dtype, scale=1.0):
    grid = ct.make_grid(ct.GridConfig(gdims=(n, n, n), pdims=(1, 1)), device)
    f = torch.randn((n, n, n), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3)) * scale
    return ct.models.PoissonSolver(grid=grid), f.to(device=device,
                                                    dtype=dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_gpu_cg_iterate_runs_c3(cuda, dtype):
    # f / 64, so that p . Ap (about 32^3 * 150 |p|^2) stays finite in
    # float16; a power of two, so the other dtypes see the same problem
    solver, f = cg_solver(cuda, 32, dtype, 1 / 64)
    state = solver.cg_init(f)
    kept = [state]
    n0 = C3.launch_count
    for _ in range(6):
        before = [t.clone() for t in (state.u, state.r, state.p, state.rs)]
        nxt = solver.cg_iterate(state, 4)
        # the state it started from is left as it was
        assert all(torch.equal(a, b) for a, b in
                   zip(before, (state.u, state.r, state.p, state.rs)))
        state = nxt
        kept.append(state)
    assert C3.launch_count - n0 == 3 * 6
    # alpha and rs are new tensors every iteration, kept alive here
    scalars = [s.rs.data_ptr() for s in kept] + [
        s.alpha.data_ptr() for s in kept[1:]]
    assert len(set(scalars)) == len(scalars)
    assert all(s.alpha.dim() == 0 and s.alpha.dtype == dtype
               for s in kept[1:])


@pytest.mark.gpu
def test_gpu_cg_spans_count_the_kernel(cuda):
    from torch.profiler import profile

    solver, f = cg_solver(cuda, 16, torch.float32)
    v = 4 * 16 ** 3
    tracing.clear_spans()
    try:
        with profile():
            solver.solve_cg(f, tol=0.0, maxiter=4, check_every=2)
        spans = tracing.spans()
    finally:
        tracing.clear_spans()
    iters = [i for i, s in enumerate(spans) if s.name == P + "cg_iter"]
    assert len(iters) == 4
    for i in iters:
        assert spans[i].counts == {"bytes": 13 * v, "kernel": 1}
        kids = [s for s in spans if s.parent == i]
        assert [s.name[len(P):] for s in kids][:4] == [
            "cg_matvec", "cg_dot", "cg_update", "cg_update"]
        assert [s.counts.get("bytes") for s in kids][:4] == [
            None, 2 * v, 6 * v, 3 * v]


@pytest.mark.gpu
def test_gpu_solve_cg_matches_the_cpu(cuda):
    solver, f = cg_solver(cuda, 24, torch.float64)
    csolver, cf = cg_solver("cpu", 24, torch.float64)
    n0 = C3.launch_count
    u, it, rel = solver.solve_cg(f, tol=1e-11, check_every=8)
    cu, cit, crel = csolver.solve_cg(cf, tol=1e-11, check_every=8)
    assert it == cit and rel <= 1e-11 and crel <= 1e-11
    assert C3.launch_count - n0 == 3 * it
    assert float((u.cpu() - cu).abs().max()) <= 1e-9


@pytest.mark.gpu
def test_gpu_a_strided_right_hand_side_launches_c3(cuda):
    # cg_init makes the state contiguous, so C3 takes it: 3 calls an
    # iteration, and the iterations of the contiguous copy
    solver, f = cg_solver(cuda, 24, torch.float32)
    ft = f.transpose(0, 2)
    assert not ft.is_contiguous()
    C3.reset_launch_count()
    u, it, _ = solver.solve_cg(ft, tol=0.0, maxiter=5, check_every=5)
    assert it == 5 and C3.calls == {"dot": 5, "update": 5, "direction": 5}
    want, _, _ = solver.solve_cg(ft.contiguous(), tol=0.0, maxiter=5,
                                 check_every=5)
    assert float((u - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.gpu
def test_gpu_a_state_c3_cannot_take_raises(cuda):
    # on the card the iteration never falls back to the formulas: a
    # strided u raises at the update (after the dot's one call), a state
    # under autograd at the dot
    solver, f = cg_solver(cuda, 16, torch.float32)
    state = solver.cg_init(f)
    n0 = C3.launch_count
    with pytest.raises(ValueError, match="C3 runs"):
        solver.cg_iterate(state._replace(u=state.u.transpose(0, 1)))
    assert C3.launch_count == n0 + 1
    n0 = C3.launch_count
    grad = solver.cg_init(f.clone().requires_grad_())
    with pytest.raises(ValueError, match="no backward"):
        solver.cg_iterate(grad)
    assert C3.launch_count == n0
    with torch.no_grad():
        solver.cg_iterate(grad)
    assert C3.launch_count == n0 + 3


@pytest.mark.gpu
def test_gpu_c3_sums_meet_over_two_ranks_that_share_the_card(cuda,
                                                             tmp_path):
    # two processes on cuda:0 over gloo: each rank's C3 sums, reduced over
    # the ranks by all_reduce_grid, equal the float64 sums of the whole
    # vectors (utils.testing.check_c3_sums_over_ranks)
    from cudecomp_tpu_torch.utils.testing import (check_c3_sums_over_ranks,
                                                  run_card_ranks)
    run_card_ranks(check_c3_sums_over_ranks, 2, str(tmp_path / "pg"), (),
                   240, "two ranks' C3 sums on one card")


@pytest.mark.gpu
def test_gpu_solve_cg_over_four_cards_runs_c3_on_every_rank(cuda):
    # solve_cg at pdims (2, 2), one card a rank over NCCL: the iteration
    # count and the solution (to 1e-9) of a one-rank solve of the same
    # field on the CPU, which test_torch_models holds to JAX's count
    import socket

    from cudecomp_tpu_torch.utils.testing import cg_card_rank, run_ranks
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    gdims = (24, 20, 28)
    field = torch.randn(gdims, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(5))
    one = ct.models.PoissonSolver(grid=ct.make_grid(
        ct.GridConfig(gdims=gdims, pdims=(1, 1)), "cpu"))
    u, iters, rel = one.solve_cg(field, tol=1e-11, check_every=8)
    assert rel <= 1e-11
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    case = {"gdims": gdims, "pdims": (2, 2), "field": field.numpy(),
            "u": u.numpy(), "iters": iters, "tol": 1e-11, "check_every": 8}
    run_ranks(cg_card_rank, 4, (4, port, case), 300,
              "solve_cg over four cards")
