"""C2 on the card: the spectral curl and the masked Leray projection, one
kernel pass each (``ops/spectral_kernel.py``, ``csrc/spectral3.cu``).

Every test here needs a CUDA card, skips without one and imports no JAX,
so they run with
``python -m pytest --noconftest -m gpu tests/test_torch_spectral_kernel.py``.
They hold the kernel to the plain formulas
(``SpectralOperators._curl_formula``, ``_project_formula``) at odd r2c
shapes, in the FFT's component planes, a component-innermost stack,
pencil layouts of (2, 1) and (1, 2) grids and a split-complex plan's
plane pairs, count one launch a call (and one more a call in the
backward), and trace a Taylor-Green step at 64^3 of either form: one C2
kernel in each curl and projection span, no stack copy, the spans'
counts.
"""

import types

import numpy as np
import pytest
import torch

import cudecomp_tpu_torch as ct
from cudecomp_tpu_torch import performance
from cudecomp_tpu_torch.models import taylor_green as tgm
from cudecomp_tpu_torch.ops import spectral as TS
from cudecomp_tpu_torch.ops import spectral_kernel as SK
from cudecomp_tpu_torch.ops.fft import DistributedFFT
from cudecomp_tpu_torch.utils import tracing

P = tracing.PREFIX
#: units in the last place of the largest term the kernel may differ by:
#: it runs the formulas' operations in their order, each rounded alone
ULPS = 4
EPS = {torch.complex64: 2.0 ** -24, torch.complex128: 2.0 ** -53}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def planar(t):
    """``t`` (..., 3) with a contiguous plane per component."""
    return t.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)


def _fft_case(device, gdims=(9, 8, 7), dtype=torch.float32):
    """The r2c spectrum of a random (X, Y, Z, 3) field as the plan's
    forward returns it (a plane per component) and its operators."""
    grid = ct.make_grid(ct.GridConfig(gdims=gdims, pdims=(1, 1)), device)
    plan = DistributedFFT(grid=grid, real=True)
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.standard_normal(gdims + (3,))).to(dtype)
    vh = plan.forward(u.to(device))
    return vh, TS.SpectralOperators(plan=plan, dtype=dtype)


def _pencil_case(device, pdims, coords, kw, dtype, gdims=(9, 8, 7)):
    """A random state of rank ``coords`` of an r2c grid on ``pdims`` and
    operators whose wavenumbers are random vectors laid out as that
    rank's broadcast blocks."""
    tc = ct.ops.fft.complex_grid_config(
        ct.GridConfig(gdims=gdims, pdims=pdims, **kw))
    cg = types.SimpleNamespace(config=tc, coords=coords, device=device)
    rng = np.random.default_rng(1)
    real = dtype.to_real()
    ks = tuple(TS._local_broadcast(cg, rng.standard_normal(tc.gdims[g]),
                                   g).to(real) for g in range(3))
    shape = ct.geometry.pencil_buffer_shape(tc, 2, None, None) + (3,)
    v = torch.from_numpy(rng.standard_normal(shape)
                         + 1j * rng.standard_normal(shape))
    ops = TS.SpectralOperators(plan=types.SimpleNamespace(split_complex=False))
    ops._cache["k"] = ks
    return v.to(device=device, dtype=dtype), ops


def _check_both_operators(vh, ops):
    """Both operators (the projection with and without a mask) on ``vh``,
    a tensor or a plane pair: one launch each, the input's layout and
    dtype, within ``ULPS`` of the formulas' largest term."""
    ks = ops.wavenumbers()
    kmax = max(float(k.abs().max()) for k in ks)
    planes = vh if isinstance(vh, tuple) else (vh,)
    eps = EPS[torch.complex64 if planes[0].dtype in (torch.complex64,
                                                     torch.float32)
              else torch.complex128]
    vmax = max(float(p.abs().max()) for p in planes)
    rng = np.random.default_rng(2)
    mask = torch.from_numpy(rng.uniform(0, 1, planes[0].shape[:3])).to(
        device=planes[0].device, dtype=planes[0].dtype.to_real())
    for name, m in (("curl", None), ("project", None), ("project", mask)):
        before = SK.launch_count
        if name == "curl":
            got, want = ops.curl(vh), ops._curl_formula(vh)
            scale = kmax * vmax
        else:
            got = ops.project_solenoidal(vh, mask=m)
            want = ops._project_formula(vh, m)
            scale = vmax * (1.0 if m is None else float(m.max()))
        torch.cuda.synchronize()
        assert SK.launch_count == before + 1, name
        triples = (zip(got, want, vh) if isinstance(vh, tuple)
                   else [(got, want, vh)])
        for g, w, p in triples:
            assert g.stride() == p.stride() and g.dtype == p.dtype
            err = float((g - w).abs().max())
            assert err <= ULPS * eps * scale, (name, err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["planar", "interleaved"])
def test_gpu_c2_matches_the_formulas_at_an_odd_r2c_shape(cuda, layout):
    vh, ops = _fft_case(cuda)
    assert vh.shape == (5, 8, 7, 3) and vh.dtype == torch.complex64
    assert not vh.is_contiguous()  # the forward's layout: component planes
    assert vh.stride() == planar(vh).stride()
    _check_both_operators(vh if layout == "planar" else vh.contiguous(), ops)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("pdims,coords,kw", [
    ((2, 1), (1, 0), dict(transpose_axis_contiguous=(True,) * 3)),
    ((1, 2), (0, 1), {}),
])
def test_gpu_c2_matches_the_formulas_on_pencil_layouts(cuda, pdims, coords,
                                                       kw, dtype):
    vh, ops = _pencil_case(cuda, pdims, coords, kw, dtype)
    _check_both_operators(vh, ops)
    _check_both_operators(planar(vh), ops)


def _split(vh):
    """A complex state as the plane pair of a split-complex plan."""
    return (vh.real.contiguous(), vh.imag.contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["planar", "interleaved"])
def test_gpu_c2_matches_the_formulas_on_plane_pairs(cuda, layout):
    vh, cops = _fft_case(cuda)
    pair = tuple(planar(p) if layout == "planar" else p
                 for p in _split(vh))
    ops = TS.SpectralOperators(plan=types.SimpleNamespace(split_complex=True))
    ops._cache["k"] = cops.wavenumbers()
    assert SK.takes(pair)
    _check_both_operators(pair, ops)


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["complex", "planes"])
def test_gpu_c2_differentiates_in_one_pass_each_way(cuda, form):
    """Curl, then the masked projection, under autograd: two launches
    forward and two backward (both operators are self-adjoint), and the
    gradient within a few ulps of the formulas' autograd."""
    vh, ops = _fft_case(cuda, dtype=torch.float64)
    split = form == "planes"
    sops = TS.SpectralOperators(
        plan=types.SimpleNamespace(split_complex=split))
    sops._cache["k"] = ops.wavenumbers()
    mask = ops.mask()
    grads = []
    for kernel in (True, False):
        xs = tuple(p.detach().clone().requires_grad_(True)
                   for p in (_split(vh) if split else (vh,)))
        state = xs if split else xs[0]
        before = SK.launch_count
        if kernel:
            w = sops.project_solenoidal(sops.curl(state), mask=mask)
        else:
            w = sops._project_formula(sops._curl_formula(state), mask)
        loss = sum((p.abs() ** 2).sum()
                   for p in (w if split else (w,)))
        loss.backward()
        torch.cuda.synchronize()
        assert SK.launch_count == before + (4 if kernel else 0)
        grads.append([x.grad for x in xs])
    for g, w in zip(*grads):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 64 * EPS[torch.complex128] * scale


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
@pytest.mark.parametrize("split", [False, True])
def test_gpu_a_tg_step_runs_one_c2_pass_per_operator(cuda, tmp_path, split):
    grid = ct.make_grid(ct.GridConfig(gdims=(64, 64, 64), pdims=(1, 1)),
                        cuda)
    solver = tgm.TaylorGreenSolver(grid=grid, nu=1 / 1600,
                                   integrating_factor=False,
                                   split_complex=split)
    uh, f = solver.setup(torch.float32)
    solver.step(uh, f, 1e-3)  # warm: plans, cuFFT, the library
    tracing.clear_spans()
    before = SK.launch_count
    with ct.profile_trace(str(tmp_path / "tr")) as d:
        out = solver.step(uh, f, 1e-3)
    assert SK.launch_count == before + 8
    if not split:  # the planes of a split state are views of a complex one
        assert out.stride() == uh.stride()
    planes = uh if split else (uh,)
    by_range = _kernels_by_range(d)
    for op in ("curl", "project_solenoidal"):
        kernels = by_range[P + op]
        assert len(kernels) == 4, kernels
        assert all("spectral3_kernel" in k for k in kernels), kernels
    for r in ("tg_curl", "tg_project"):
        assert not by_range.get(P + r), by_range.get(P + r)
    spans = tracing.spans()
    state = sum(p.numel() * p.element_size() for p in planes)
    mask = f["mask"].numel() * f["mask"].element_size()
    for name, nbytes in (("curl", 2 * state),
                         ("project_solenoidal", 2 * state + mask)):
        got = [s.counts for s in spans if s.name == P + name]
        assert got == [{"bytes": nbytes, "kernel": 1}] * 4, (name, got)
