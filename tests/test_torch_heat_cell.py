"""The explicit heat step of the benchmark's ``heat2048x1024.step`` cell on
the CPU: ``diffusion_step`` on a (1, 1) grid against the plain float64
reference ``bench_torch/reference/heat7.py``, the blocked reference
against its unblocked form, K4's plan and argument packing at the cell's
2**31 cells, and the ``stencil_ghosts`` and ``stencil_pass`` spans with
their counts."""

import ctypes
import math
import types

import numpy as np
import pytest
import torch
from torch.profiler import profile

import cudecomp_tpu_torch as ct
from cudecomp_tpu_torch.ops import stencil_kernel as S
from cudecomp_tpu_torch.utils import tracing

from bench_torch.reference import heat7

P = tracing.PREFIX
DT = 0.1
PERIODIC = (True, True, True)
BIG = (2048, 1024, 1024)


def _field(shape, dtype, seed=0):
    return torch.randn(shape, dtype=dtype,
                       generator=torch.Generator().manual_seed(seed))


def _rolled(u, dt):
    """The step as whole-box rolls, in the reference's order of sums."""
    faces = u.roll(1, 0) + u.roll(-1, 0)
    for dim in (1, 2):
        faces = faces + u.roll(1, dim) + u.roll(-1, dim)
    return u + dt * (faces - 6.0 * u)


# float64: both sides sum the same seven terms in float64, in other orders
# (K4's FMA chain against the reference's sums), so they differ by a few ulp
# of values under 10: 1e-13.  float32: K4's chain rounds each of its seven
# FMAs once to float32; the weights are positive and add to 1, so with
# unit-variance data every partial sum stays under 8, each rounding is at
# most half an ulp there (2**-22) and the seven at most 1.7e-6, with the
# weights' own rounding (0.1 is 1.5e-9 off in float32) far below: 4e-6.
# A tap dropped moves a cell by 0.1 of a value.
TOL = {torch.float64: 1e-13, torch.float32: 4e-6}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("gdims", [(16, 8, 32), (8, 16, 16)])
def test_diffusion_step_matches_the_plain_reference(gdims, dtype):
    grid = ct.make_grid(ct.GridConfig(gdims=gdims, pdims=(1, 1)), "cpu")
    u = _field(grid.buffer_shape(0), dtype, seed=sum(gdims))
    got = ct.diffusion_step(grid, u, DT, 0, PERIODIC)
    assert got.dtype == dtype and tuple(got.shape) == gdims
    want = heat7.step(u, DT, block=3)
    assert want.dtype == torch.float64
    err = float((got.to(torch.float64) - want).abs().max())
    assert err <= TOL[dtype], err
    # the increment is far above the tolerance, so the check sees the step
    assert float((want - u).abs().max()) > 1e4 * TOL[torch.float32]


@pytest.mark.parametrize("shape,block", [((16, 8, 32), 5), ((8, 16, 16), 3),
                                         ((7, 4, 6), 32), ((1, 3, 5), 1)])
def test_the_blocked_reference_is_the_rolled_step(shape, block):
    u = _field(shape, torch.float32, seed=3)
    blocks = list(heat7.step_blocks(u, DT, block))
    assert [(a, b) for a, b, _ in blocks] == [
        (x, min(x + block, shape[0])) for x in range(0, shape[0], block)]
    assert torch.equal(heat7.step(u, DT, block),
                       _rolled(u.to(torch.float64), DT))
    # the control: every block's answer as the whole box's
    assert torch.equal(heat7.control_step(u, DT, block),
                       heat7.control_step(u, DT, shape[0]))


def test_the_control_rounds_to_bfloat16():
    u = _field((8, 8, 16), torch.float32, seed=4)
    c = heat7.control_step(u, DT)
    assert c.dtype == torch.float32
    assert torch.equal(c, c.to(torch.bfloat16).to(torch.float32))
    d_ref = heat7.step(u, DT) - u.to(torch.float64)
    rel = float((c - u - d_ref).norm() / d_ref.norm())
    assert 1e-4 < rel < 1e-1


def _seven_taps():
    """``diffusion_step``'s weights: the faces ``dt``, the centre
    ``1 - 6 dt``."""
    w = np.zeros((3, 3, 3))
    for d in range(3):
        lo, hi = [1, 1, 1], [1, 1, 1]
        lo[d], hi[d] = 0, 2
        w[tuple(lo)] = w[tuple(hi)] = DT
    w[1, 1, 1] = 1.0 - 6.0 * DT
    return w


def test_k4_plans_the_2048x1024x1024_box_without_allocating(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the plan allocated")

    for name in ("empty", "zeros", "empty_like", "zeros_like"):
        monkeypatch.setattr(torch, name, refuse)
    w = S.as_weights(_seven_taps())
    plan = S.stencil_plan(w, False, 7, torch.float32, BIG)
    assert plan == S.StencilPlan("face", "tma", 32, 8,
                                 S.smem_bytes(torch.float32, 8),
                                 (16, 64, 64))
    # 2**31 cells: the count and every byte offset past the first 2**29
    # cells are past int32
    assert math.prod(BIG) > 2 ** 31 - 1


class _Lib:
    """Records the C entry's arguments and the tensor maps it encodes."""

    def __init__(self):
        self.calls, self.encoded = [], []

    def cudecomp_stencil27(self, *args):
        self.calls.append(args)
        return 0

    def cudecomp_stencil27_encode_map(self, dst, ptr, d0, d1, d2, code):
        self.encoded.append((ptr, d0, d1, d2, code))
        return 0


def test_k4_takes_the_2048x1024x1024_box_in_64_bit_arguments():
    # the C entry's extents and x-chunk are 64-bit: the kernel forms every
    # offset from them in int64 (csrc/stencil27.cu)
    (entry,) = [s for s in S.SIGNATURES if s[0] == "cudecomp_stencil27"]
    assert entry[1][8:11] == (ctypes.c_int64,) * 3
    assert entry[1][17] is ctypes.c_int64
    S._maps_cache.clear()
    u = types.SimpleNamespace(shape=BIG, dtype=torch.float32,
                              data_ptr=lambda: 1 << 20)
    out = types.SimpleNamespace(data_ptr=lambda: 1 << 40)
    w = _seven_taps()
    plan = S.stencil_plan(w, False, 7, torch.float32, BIG)
    lib = _Lib()
    assert S._launch(lib, u, out, [None] * 6, BIG, 7, False, w, plan, 0) == 0
    (args,) = lib.calls
    assert args[8:11] == BIG and args[17] == 32
    assert lib.encoded == [(1 << 20, 1024, 1024, 2048, 0)]
    S._maps_cache.clear()


def _spans_of(fn):
    tracing.clear_spans()
    try:
        with profile():
            fn()
        return tracing.spans()
    finally:
        tracing.clear_spans()


def _children(spans, i):
    return [j for j, s in enumerate(spans) if s.parent == i]


@pytest.mark.parametrize("case", ["periodic", "x-dirichlet", "valid"])
def test_stencil_spans_count_the_pass_and_its_ghosts(case):
    gdims = (8, 6, 12)
    grid = ct.make_grid(ct.GridConfig(gdims=gdims, pdims=(1, 1)), "cpu")
    u = _field(gdims, torch.float32, seed=5)
    cells, item = math.prod(gdims), 4
    if case == "valid":
        # corner taps across a y ghost dim: the ghost-extended block
        dense = np.ones((3, 3, 3))
        spans = _spans_of(lambda: [ct.stencil_apply(grid, u, dense, 0,
                                                    (True, False, True))
                                   for _ in range(2)])
        root = P + "stencil_apply_axis0"
        ghost = item * (math.prod(n + 2 for n in gdims) - cells)
        pass_bytes = item * cells + ghost + item * cells
    else:
        periods = PERIODIC if case == "periodic" else (False, True, True)
        spans = _spans_of(lambda: [ct.diffusion_step(grid, u, DT, 0, periods)
                                   for _ in range(2)])
        root = P + "diffusion_step_axis0"
        # all dims wrap inside K4, or x takes two (6, 12) zero planes
        ghost = 0 if case == "periodic" else item * 2 * 6 * 12
        pass_bytes = 2 * item * cells + ghost
    roots = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in roots] == [root, root]
    for i in roots:
        kids = _children(spans, i)
        assert [spans[j].name for j in kids] == [P + "stencil_ghosts",
                                                 P + "stencil_pass"]
        g, p = (spans[j] for j in kids)
        assert g.counts == {"bytes": ghost}
        assert p.counts == {"bytes": pass_bytes, "points": cells}
        assert _children(spans, kids[1]) == []
    if case == "periodic":
        assert pass_bytes == 2 * u.numel() * u.element_size()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_diffusion_step_runs_the_2048x1024x1024_box(cuda):
    # the cell's step through make_grid and K4 at 2**31 cells, held to the
    # float64 reference in blocks (TOL's float32 reason holds at any size)
    grid = ct.make_grid(ct.GridConfig(gdims=BIG, pdims=(1, 1)), cuda)
    u = torch.empty(BIG, dtype=torch.float32, device=cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(11)
    for x in range(0, BIG[0], 256):
        u[x:x + 256].normal_(generator=gen)
    before = S.launch_count
    got = ct.diffusion_step(grid, u, DT, 0, PERIODIC)
    assert S.launch_count == before + 1
    err = 0.0
    for x0, x1, want in heat7.step_blocks(u, DT, block=64):
        err = max(err, float((got[x0:x1].to(torch.float64) - want)
                             .abs().max()))
    assert err <= TOL[torch.float32], err
