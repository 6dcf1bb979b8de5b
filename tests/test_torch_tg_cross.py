"""Taylor-Green's cross product ``u x omega``: one ``torch.linalg.cross``
of the fields as the inverse FFT lays them out, written into a tensor of
that layout (x innermost, a plane per component), which the forward FFT
reads as it is.

These tests hold the nonlinear term's call to ``np.cross`` in float64 and
the forward FFT of the result to that of its contiguous copy.  The
``gpu`` test counts the kernels the ``tg_cross`` span launches on the
card; it skips without a card and imports no JAX, so it runs with
``python -m pytest --noconftest -m gpu tests/test_torch_tg_cross.py``.
"""

import numpy as np
import pytest
import torch

import cudecomp_tpu_torch as ct
from cudecomp_tpu_torch import performance
from cudecomp_tpu_torch.models import taylor_green as tgm
from cudecomp_tpu_torch.ops.fft import DistributedFFT
from cudecomp_tpu_torch.utils import tracing

GDIMS = (9, 8, 7)


def _plan(split_complex=False, device="cpu", gdims=GDIMS):
    grid = ct.make_grid(ct.GridConfig(gdims=gdims, pdims=(1, 1)), device)
    return DistributedFFT(grid=grid, real=True, split_complex=split_complex)


def _fields(dtype, split_complex=False):
    """Two (X, Y, Z, 3) fields laid out as the plan's inverse returns
    them."""
    plan = _plan(split_complex)
    rng = np.random.default_rng(0)
    out = []
    for _ in range(2):
        x = torch.from_numpy(rng.standard_normal(GDIMS + (3,))).to(dtype)
        out.append(plan.inverse_planes(plan.forward_planes(x))
                   if split_complex else plan.inverse(plan.forward(x)))
    return out


def _spy(monkeypatch):
    """Record every ``(u, w, result)`` of ``torch.linalg.cross``."""
    calls = []
    cross = torch.linalg.cross

    def spy(u, w, *args, **kwargs):
        out = cross(u, w, *args, **kwargs)
        calls.append((u, w, out))
        return out

    monkeypatch.setattr(torch.linalg, "cross", spy)
    return calls


def _formula(u, w):
    """The component formula, stacked: what the cross product computes."""
    return torch.stack([
        u[..., 1] * w[..., 2] - u[..., 2] * w[..., 1],
        u[..., 2] * w[..., 0] - u[..., 0] * w[..., 2],
        u[..., 0] * w[..., 1] - u[..., 1] * w[..., 0],
    ], dim=-1)


def _assert_is_the_formula(u, w, got, rtol):
    """``got`` is ``np.cross`` of the fields in float64, to ``rtol`` of
    the largest component product, in ``u``'s layout."""
    want = np.cross(u.double().cpu().numpy(), w.double().cpu().numpy())
    scale = float(u.abs().max() * w.abs().max())
    assert np.abs(got.double().cpu().numpy() - want).max() <= rtol * scale
    assert got.dtype == u.dtype
    assert got.stride() == u.stride()


#: float32: two roundings of a product and one of the difference; float64
#: to 1e-15
TOL = {torch.float32: 4 * 2.0 ** -24, torch.float64: 1e-15}

#: the forward FFT of one field in two layouts, relative to its largest
#: coefficient: 16 units in the last place in float32, 1e-12 in float64
FFT_RTOL = {torch.float32: 16 * 2.0 ** -24, torch.float64: 1e-12}


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
    lay = _fields(dtype, split_complex)[0]
    assert u.stride() == w.stride() == lay.stride()
    assert not u.is_contiguous()  # x innermost, a plane per component
    _assert_is_the_formula(u, w, got, TOL[dtype])


@pytest.mark.parametrize("split_complex", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_forward_fft_reads_the_cross_in_the_inverse_layout(
        dtype, split_complex):
    u, w = _fields(dtype, split_complex)
    nl = torch.linalg.cross(u, w, dim=-1, out=torch.empty_like(u))
    assert nl.stride() == u.stride() and not nl.is_contiguous()
    plan = _plan(split_complex)
    fwd = plan.forward_planes if split_complex else plan.forward
    got, want = fwd(nl), fwd(nl.contiguous())
    if not split_complex:
        got, want = (got,), (want,)
    scale = max(float(p.abs().max()) for p in want)
    for g, r in zip(got, want):
        assert g.shape == r.shape and g.dtype == r.dtype
        assert float((g - r).abs().max()) <= FFT_RTOL[dtype] * scale


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
def test_gpu_tg_cross_launches_the_library_kernel_in_the_inverse_layout(
        cuda, monkeypatch, tmp_path):
    grid = ct.make_grid(ct.GridConfig(gdims=(64, 64, 64), pdims=(1, 1)),
                        cuda)
    solver = tgm.TaylorGreenSolver(grid=grid, nu=1 / 1600,
                                   integrating_factor=False)
    uh, f = solver.setup(torch.float32)
    solver._nonlinear(uh, f)  # warm: plans, cuFFT
    calls = _spy(monkeypatch)
    with ct.profile_trace(str(tmp_path / "tr")) as d:
        solver._nonlinear(uh, f)
    assert len(calls) == 1
    kernels = _kernels_by_range(d)[tracing.PREFIX + "tg_cross"]
    assert len(kernels) == 1 and "cross" in kernels[0].lower()
    assert not any("CatArrayBatchedCopy" in k for k in kernels)
    u, w, got = calls[0]
    assert u.shape == (64, 64, 64, 3) and u.dtype == torch.float32
    assert got.stride() == u.stride()
    want = _formula(u, w)
    scale = float(u.abs().max() * w.abs().max())
    assert float((got - want).abs().max()) <= TOL[torch.float32] * scale
