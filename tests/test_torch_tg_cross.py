"""Taylor-Green's cross product ``u x omega`` (``ops/cross.py``): one pass
over the fields as the inverse FFT lays them out, returned in the layout
``torch.stack(..., dim=-1)`` gives, so the forward FFT sees the same
strides as before.

On the CPU the wrapper runs its plain twin, the component formula; these
tests hold it, and the nonlinear term's call of it, to ``np.cross`` in
float64.  The ``gpu`` tests hold the CUDA kernel to the twin bit for bit
on the card and count the kernels the ``tg_cross`` span launches; they
skip without a card and import no JAX, so they run with
``python -m pytest --noconftest -m gpu tests/test_torch_tg_cross.py``.
"""

import numpy as np
import pytest
import torch

import cudecomp_tpu_torch as ct
from cudecomp_tpu_torch import performance
from cudecomp_tpu_torch.models import taylor_green as tgm
from cudecomp_tpu_torch.ops import cross as C
from cudecomp_tpu_torch.ops.fft import DistributedFFT
from cudecomp_tpu_torch.utils import cuda_build, tracing

GDIMS = (9, 8, 7)


def _fields(dtype, device="cpu", gdims=GDIMS, seed=0):
    """Two (X, Y, Z, 3) fields laid out as ``DistributedFFT.inverse``
    returns them."""
    grid = ct.make_grid(ct.GridConfig(gdims=gdims, pdims=(1, 1)), device)
    plan = DistributedFFT(grid=grid, real=True)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        x = torch.from_numpy(rng.standard_normal(gdims + (3,))).to(
            dtype=dtype, device=device)
        out.append(plan.inverse(plan.forward(x)))
    return out


def _spy(monkeypatch):
    """Record every ``(u, w, result)`` of the nonlinear term's cross."""
    calls = []

    def spy(u, w):
        out = C.cross(u, w)
        calls.append((u, w, out))
        return out

    monkeypatch.setattr(tgm, "cross", spy)
    return calls


def _assert_is_the_formula(u, w, got, rtol):
    """``got`` is ``np.cross`` of the fields in float64, to ``rtol`` of
    the largest component product, in the layout ``torch.stack`` gives."""
    want = np.cross(u.double().cpu().numpy(), w.double().cpu().numpy())
    scale = float(u.abs().max() * w.abs().max())
    assert np.abs(got.double().cpu().numpy() - want).max() <= rtol * scale
    assert got.dtype == u.dtype
    assert got.stride() == C.cross_ref(u, w).stride()


#: float32: two roundings of a product and one of the difference; float64
#: to 1e-15
TOL = {torch.float32: 4 * 2.0 ** -24, torch.float64: 1e-15}


@pytest.mark.parametrize("split_complex", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_nonlinear_term_takes_one_cross_of_the_inverse_fields(
        monkeypatch, dtype, split_complex):
    grid = ct.make_grid(ct.GridConfig(gdims=GDIMS, pdims=(1, 1)), "cpu")
    solver = tgm.TaylorGreenSolver(grid=grid, nu=0.05,
                                   split_complex=split_complex)
    uh, f = solver.setup(dtype)
    calls = _spy(monkeypatch)
    solver._nonlinear(uh, f)
    assert len(calls) == 1
    u, w, got = calls[0]
    lay = _fields(dtype)[0]
    assert u.stride() == w.stride() == lay.stride()
    assert not u.is_contiguous()  # x innermost, a plane per component
    _assert_is_the_formula(u, w, got, TOL[dtype])


@pytest.mark.parametrize("view", ["inverse", "transposed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cross_matches_the_component_formula(dtype, view):
    u, w = _fields(dtype)
    if view == "transposed":
        u, w = u.transpose(0, 2), w.transpose(0, 2)
        assert not u.is_contiguous() and u.shape == GDIMS[::-1] + (3,)
    _assert_is_the_formula(u, w, C.cross(u, w), TOL[dtype])


def test_cross_rejects_what_it_cannot_take():
    u, w = _fields(torch.float32)
    bad = [(u[..., :2], w[..., :2]), (u, w[:-1]), (u[0], w[0]),
           (u, w.double()), (u.half(), w.half()),
           (u.to(torch.int32), w.to(torch.int32))]
    for a, b in bad:
        with pytest.raises(ValueError, match="cross takes"):
            C.cross(a, b)


def test_cpu_dispatch_never_launches():
    C.reset_launch_count()
    u, w = _fields(torch.float64)
    assert torch.equal(C.cross(u, w), C.cross_ref(u, w))
    assert C.launch_count == 0


def test_the_kernel_library_carries_the_probe():
    srcs = cuda_build.library_sources(C.SOURCES)
    assert srcs[0] == cuda_build.PROBE_SOURCE
    assert all((cuda_build.CSRC_DIR / s).is_file() for s in srcs)
    assert cuda_build.library_path("cross3", srcs).parent == (
        cuda_build.PACKAGE_DIR / "_build")


# -- on the card -------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _kernels_by_range(log_dir):
    """``{innermost library range: [kernel names]}`` of a trace."""
    out = {}
    for events in performance._traces(log_dir):
        lib = [e for e in events if e.get("cat") == "user_annotation"
               and e["name"].startswith(tracing.PREFIX)]
        launches = {e["args"]["correlation"]: e for e in events
                    if e.get("cat") in performance._LAUNCH_CATS
                    and "correlation" in e.get("args", {})}
        for e in events:
            if e.get("cat") != "kernel":
                continue
            host = launches.get(e.get("args", {}).get("correlation"))
            r = performance._innermost_range(lib, host) if host else None
            out.setdefault(r["name"] if r else None, []).append(e["name"])
    return out


@pytest.mark.gpu
def test_gpu_tg_cross_launches_one_kernel_bit_equal_to_the_formula(
        cuda, monkeypatch, tmp_path):
    grid = ct.make_grid(ct.GridConfig(gdims=(64, 64, 64), pdims=(1, 1)),
                        cuda)
    solver = tgm.TaylorGreenSolver(grid=grid, nu=1 / 1600,
                                   integrating_factor=False)
    uh, f = solver.setup(torch.float32)
    C.build()
    solver._nonlinear(uh, f)  # warm: plans, cuFFT, the library
    calls = _spy(monkeypatch)
    C.reset_launch_count()
    with ct.profile_trace(str(tmp_path / "tr")) as d:
        solver._nonlinear(uh, f)
    assert C.launch_count == 1 and len(calls) == 1
    kernels = _kernels_by_range(d)[tracing.PREFIX + "tg_cross"]
    assert len(kernels) == 1 and "cross3_kernel" in kernels[0]
    u, w, got = calls[0]
    assert u.shape == (64, 64, 64, 3) and u.dtype == torch.float32
    ref = C.cross_ref(u, w)
    assert got.stride() == ref.stride() and torch.equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gpu_cross_of_any_strides_is_bit_equal_to_the_formula(cuda, dtype):
    u, w = _fields(dtype, cuda, gdims=(67, 40, 33), seed=3)
    for a, b in ((u, w), (u.transpose(0, 2), w.transpose(0, 2)),
                 (u.contiguous(), w)):
        got = C.cross(a, b)
        ref = C.cross_ref(a, b)
        assert got.stride() == ref.stride() and torch.equal(got, ref)
    with pytest.raises(ValueError, match="no backward"):
        C.cross(u.requires_grad_(True), w)
