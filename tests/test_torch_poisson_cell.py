"""The spectral Poisson solve of the benchmark's ``poisson4096x256.k5``
cell on the CPU: ``PoissonSolver.solve`` with its FFT plan's K5 policy
pinned (``fused2=True``; K5's plain version here) against the plain
reference ``bench_torch/reference/poisson_fft.py``, the reference
against an analytic solution, the bfloat16 control against the cell's
limits, the dispatch of ``fused2`` None and False, and the ``dft2``,
``poisson_scale`` and ``poisson_solve`` spans with their counts.  On the
card: K5 over the cell's 2049 planes, and one solve of the cell's shape."""

import json
import math
import os
from pathlib import Path

import pytest
import torch
from torch.profiler import profile

import cudecomp_tpu_torch as ct
from cudecomp_tpu_torch.ops import dft2 as D
from cudecomp_tpu_torch.ops import fft as F
from cudecomp_tpu_torch.utils import tracing

from bench_torch.reference import poisson_fft

P = tracing.PREFIX
ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "bench_torch" / "configs"
                     / "cudecomp_poisson_fft_4096x256x256.json").read_text())
CELL = tuple(CONFIG["gdims"])


def _lengths(gdims):
    """Cubic cells of side 2 pi / 128, as the cell's are of 2 pi / 256:
    the box's lengths differ as its extents do."""
    return tuple(2 * math.pi * n / 128 for n in gdims)


def _solver(gdims, lengths=None, device="cpu", **kw):
    grid = ct.make_grid(ct.GridConfig(gdims=gdims, pdims=(1, 1)), device)
    return ct.models.PoissonSolver(
        grid=grid, lengths=_lengths(gdims) if lengths is None else lengths,
        **kw)


def _field(shape, dtype, seed):
    return torch.randn(shape, dtype=dtype,
                       generator=torch.Generator().manual_seed(seed))


def _rel_max(got, want):
    return float((got.to(torch.float64) - want).abs().max()
                 / want.abs().max())


def _count(monkeypatch, module, name):
    """Count the calls of ``module.name`` (patched in place)."""
    calls = []
    real = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


# float64: both sides transform in float64 (the plain K5 as two dense
# products, the reference's FFTs), a few ulp of the largest value each:
# 1e-12.  float32: the port's float32 transforms round each of about
# log2(2**19) stages to 2**-24, summed in quadrature about 3e-7 of the
# largest mode (measured 5.3e-7 of the max at both shapes): 1e-5.  The
# bfloat16 control reads 3e-3 and up.
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("gdims", [(16, 8, 128), (32, 16, 128)])
def test_the_fused2_solve_matches_the_plain_reference(monkeypatch, gdims,
                                                      dtype):
    ts = _solver(gdims, real=True, split_complex=True, fused2=True)
    if dtype == torch.float64:
        # K5 takes complex64 alone (dft2_fits, the JAX gate's rules); its
        # plain version takes complex128 too, so that the solve's K5
        # stages are held here to float64 rounding as well
        monkeypatch.setattr(F, "dft2_fits", lambda x: D.dft2_fits(
            x.to(torch.complex64) if x.dtype == torch.complex128 else x))
    transforms = _count(monkeypatch, D, "dft2_ref")
    f = _field(gdims, dtype, seed=sum(gdims))
    got = ts.solve(f)
    assert len(transforms) == 2            # K5's plain version, both ways
    assert got.dtype == dtype and tuple(got.shape) == gdims
    want = poisson_fft.solve(f, _lengths(gdims))
    assert want.dtype == torch.float64
    assert _rel_max(got, want) <= TOL[dtype]


@pytest.mark.parametrize("lengths", [(2 * math.pi,) * 3,
                                     _lengths((16, 8, 128))])
def test_the_reference_solves_the_analytic_case(lengths):
    # u = sin x cos 2y sin 3z in the box's own periods: lap u = -|k|^2 u
    gdims = (16, 8, 128)
    x, y, z = torch.meshgrid(*[torch.arange(n, dtype=torch.float64) * L / n
                               for n, L in zip(gdims, lengths)],
                             indexing="ij")
    kx, ky, kz = (2 * math.pi * m / L for m, L in zip((1, 2, 3), lengths))
    u = (torch.sin(kx * x) * torch.cos(ky * y) * torch.sin(kz * z))
    f = -(kx * kx + ky * ky + kz * kz) * u
    assert float((poisson_fft.solve(f, lengths) - u).abs().max()) <= 1e-12
    # the port's solve too, K5's plain version in the plan
    ts = _solver(gdims, lengths, split_complex=True, fused2=True)
    assert float((ts.solve(f) - u).abs().max()) <= 1e-12


def test_the_bf16_control_fails_the_limits():
    gdims = (32, 16, 128)
    lengths = _lengths(gdims)
    ts = _solver(gdims, lengths, split_complex=True, fused2=True)
    for seed in (1, 2):
        f = _field(gdims, torch.float32, seed)
        want = poisson_fft.solve(f, lengths)
        for u, sound in ((ts.solve(f), True),
                         (poisson_fft.control_solve(f, lengths), False)):
            rel = float((u.to(torch.float64) - want).norm() / want.norm())
            for name, v in (("poisson_rel_l2", rel),
                            ("poisson_max_rel", _rel_max(u, want))):
                assert (v <= CONFIG["limits"][name]) is sound, (name, v)
    c = poisson_fft.control_solve(f, lengths)
    assert c.dtype == torch.float32
    assert torch.equal(c, c.to(torch.bfloat16).to(torch.float32))


def _transforms(fused2, knob):
    """The (Y, Z) transforms a split-complex solve sends through K5."""
    return 2 if (knob == "1" if fused2 is None else fused2) else 0


@pytest.mark.parametrize("fused2", [None, False, True])
@pytest.mark.parametrize("knob", ["0", "1"])
def test_fused2_pins_the_plan_and_none_reads_the_environment(
        monkeypatch, fused2, knob):
    gdims = (16, 8, 128)
    ts = _solver(gdims, split_complex=True, fused2=fused2)
    assert ts.plan.fused2 is fused2
    transforms = _count(monkeypatch, F, "dft2")
    f = _field(gdims, torch.float32, seed=5)     # K5 takes complex64
    want = poisson_fft.solve(f, _lengths(gdims))
    # the knob, then its opposite, on the same solver: read per call.  The
    # knob goes into a copy of os.environ, which is what the program reads:
    # putenv while other threads of this worker read the C environment
    # can crash the worker
    for k in (knob, "1" if knob == "0" else "0"):
        monkeypatch.setattr(os, "environ",
                            {**os.environ, "CUDECOMP_TPU_FFT_FUSED2": k})
        before = len(transforms)
        got = ts.solve(f)
        assert len(transforms) - before == _transforms(fused2, k)
        assert _rel_max(got, want) <= TOL[torch.float32]


def _spans(fn):
    tracing.clear_spans()
    try:
        with profile():
            out = fn()
        return out, tracing.spans()
    finally:
        tracing.clear_spans()


def _kids(spans, i):
    return [j for j, s in enumerate(spans) if s.parent == i]


@pytest.mark.parametrize("real,split,fused2", [
    (True, True, True), (True, True, False), (True, False, None),
    (False, True, True)])
def test_the_solve_spans_and_their_counts(monkeypatch, real, split, fused2):
    gdims = (16, 8, 128)
    ts = _solver(gdims, real=real, split_complex=split, fused2=fused2)
    shape = gdims if real else gdims + (2,)
    f = _field(shape, torch.float32, seed=6)
    # K5's plain version standing in for launches, so that the solve's
    # ``kernel`` count sees what it would on the card
    real_ref = D.dft2_ref

    def launched(x, inverse=False):
        D.launch_count += 1
        return real_ref(x, inverse)

    monkeypatch.setattr(D, "dft2_ref", launched)
    _, spans = _spans(lambda: ts.solve(f))
    (top,) = [i for i, s in enumerate(spans) if s.parent is None]
    k5 = bool(fused2) and split
    assert spans[top].name == P + "poisson_solve"
    assert spans[top].counts == {"kernel": 2 if k5 else 0}
    kids = _kids(spans, top)
    assert [spans[j].name[len(P):] for j in kids] == [
        "fft3d_forward", "poisson_scale", "fft3d_inverse"]
    # the spectrum: the r2c half along X, or the whole c2c box
    n = (gdims[0] // 2 + 1 if real else gdims[0]) * gdims[1] * gdims[2]
    # two plane products of float32 (each reads its plane and the scale
    # and writes a plane), or one product of a complex64 spectrum
    want = 2 * 3 * 4 * n if real and split else (8 + 8 + 4) * n
    assert spans[kids[1]].counts == {"bytes": want}
    fft2 = [s for s in spans if s.name == P + "dft2"]
    assert len(fft2) == (2 if k5 else 0)
    for s, parent in zip(fft2, (kids[0], kids[2])):
        assert s.parent == parent
        assert s.counts == {"bytes": 2 * 8 * n,
                            "planes": n // (gdims[1] * gdims[2])}


def test_a_count_set_inside_a_span_is_recorded():
    def work():
        with tracing.trace_range("outer", bytes=1) as counts:
            counts["kernel"] = 3
        with tracing.trace_range("inner") as counts:
            pass
        return counts

    counts, spans = _spans(work)
    assert [(s.name, s.counts) for s in spans] == [
        ("outer", {"bytes": 1, "kernel": 3}), ("inner", {})]
    assert counts == {}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cuda_normal(shape, dtype, device, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn(shape, dtype=dtype, device=device, generator=gen)


@pytest.mark.gpu
@pytest.mark.parametrize("inverse", [False, True])
def test_gpu_k5_takes_the_cells_2049_planes(cuda, inverse):
    # the cell's half spectrum: one cluster of 8 blocks a plane, 16,392
    # blocks in the launch, against cuFFT's 2D transform
    planes = CELL[0] // 2 + 1
    shape = (planes,) + CELL[1:]
    plan = D.dft2_plan(*CELL[1:])
    assert plan.cluster == 8 and planes * plan.cluster == 16392
    assert D._lib().cudecomp_dft2_smem_bytes(
        CELL[1], CELL[2], plan.cluster, plan.chunk) == plan.smem
    x = _cuda_normal(shape, torch.complex64, cuda, seed=12)
    before = D.launch_count
    got = D.dft2(x, inverse)
    torch.cuda.synchronize()
    assert D.launch_count == before + 1
    want = (torch.fft.ifftn if inverse else torch.fft.fftn)(x, dim=(1, 2))
    err = float(torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want))
    assert err <= 1e-6, err
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.gpu
def test_gpu_one_solve_of_the_cell_launches_k5_twice(cuda):
    lengths = tuple(CONFIG["lengths"])
    ts = _solver(CELL, lengths, device=cuda, split_complex=True, fused2=True)
    f = _cuda_normal(CELL, torch.float32, cuda, seed=13)
    before = D.launch_count
    got = ts.solve(f)
    torch.cuda.synchronize()
    assert D.launch_count == before + 2
    del ts
    want = poisson_fft.solve(f, lengths)
    rel = float((got.to(torch.float64) - want).norm() / want.norm())
    assert rel <= CONFIG["limits"]["poisson_rel_l2"], rel
    assert _rel_max(got, want) <= CONFIG["limits"]["poisson_max_rel"]
