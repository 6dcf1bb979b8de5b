"""The distributed FFT of cudecomp_tpu_torch against cudecomp_tpu on a
``pdims (1, 1)`` grid (multi-rank grids: ``test_torch_slice.py``).

float64/complex128 must agree with JAX to atol 1e-10.  float32/complex64
agree to a relative L2 error of 1e-5: the two sides sum in different
orders (JAX's matmul FFT against pocketfft/cuFFT).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import cudecomp_tpu as cd
from cudecomp_tpu.ops.fft import DistributedFFT as JFFT
from cudecomp_tpu.ops.fft import complex_grid_config as j_complex_cfg

import cudecomp_tpu_torch as ct
from cudecomp_tpu_torch.ops.fft import DistributedFFT as TFFT
from cudecomp_tpu_torch.ops.fft import complex_grid_config, plan_stages
from cudecomp_tpu_torch.utils import tracing

LAYOUTS = {
    "natural": {},
    "axis_contiguous": dict(transpose_axis_contiguous=(True, True, True)),
    "mem_order": dict(transpose_mem_order=((2, 1, 0), (0, 2, 1), (1, 2, 0))),
}
P = tracing.PREFIX


def twin_grids(gdims, **kw):
    jcfg = cd.GridConfig(gdims=gdims, pdims=(1, 1), **kw)
    jgrid = cd.make_grid(jcfg, devices=jax.devices()[:1])
    tgrid = ct.make_grid(ct.GridConfig.from_dict(dataclasses.asdict(jcfg)),
                         "cpu")
    return jgrid, tgrid


def rel_l2(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def check(got, want, real_dtype):
    """atol 1e-10 for float64, relative L2 1e-5 for float32."""
    got = [t.numpy() for t in got] if isinstance(got, tuple) else got.numpy()
    want = ([np.asarray(w) for w in want] if isinstance(want, tuple)
            else np.asarray(want))
    for g, w in (zip(got, want) if isinstance(got, list) else [(got, want)]):
        assert g.shape == w.shape
        if real_dtype == np.float64:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-10)
        else:
            assert rel_l2(g, w) <= 1e-5


def inputs(kind, form, gdims, real_dtype, seed=3):
    """The X-pencil input of one (kind, form) in JAX and torch, from one
    numpy field."""
    rng = np.random.default_rng(seed)
    re = rng.standard_normal(gdims).astype(real_dtype)
    if kind == "r2c":
        return re
    im = rng.standard_normal(gdims).astype(real_dtype)
    if form == "complex":
        return re + 1j * im
    if form == "split":
        return np.stack([re, im], -1)
    return (re, im)


def run_case(kind, form, gdims, layout, real_dtype):
    jgrid, tgrid = twin_grids(gdims, **LAYOUTS[layout])
    real = kind == "r2c"
    split = form != "complex"
    jplan = JFFT(grid=jgrid, real=real, split_complex=split)
    tplan = TFFT(grid=tgrid, real=real, split_complex=split)
    x = inputs(kind, form, gdims, real_dtype)

    def scatter(grid_mod, grid, v):
        if isinstance(v, tuple):
            return tuple(grid_mod.scatter_global(grid, p, 0) for p in v)
        if v.ndim == 4:  # split (..., 2): scatter each part
            return grid_mod.scatter_global(grid, v[..., 0], 0), \
                grid_mod.scatter_global(grid, v[..., 1], 0)
        return grid_mod.scatter_global(grid, v, 0)

    jx, tx = scatter(cd, jgrid, x), scatter(ct, tgrid, x)
    if form == "split" and kind == "c2c":
        jx = jax.numpy.stack(jx, -1)
        tx = torch.stack(tx, -1)
    fwd_j = jplan.forward_planes if form == "planes" else jplan.forward
    inv_j = jplan.inverse_planes if form == "planes" else jplan.inverse
    fwd_t = tplan.forward_planes if form == "planes" else tplan.forward
    inv_t = tplan.inverse_planes if form == "planes" else tplan.inverse

    jh, th = fwd_j(jx), fwd_t(tx)
    check(th, jh, real_dtype)
    # the inverse of the same (JAX) spectrum in both packages
    jh_t = (tuple(torch.from_numpy(np.array(p)) for p in jh)
            if isinstance(jh, tuple) else torch.from_numpy(np.array(jh)))
    check(inv_t(jh_t), inv_j(jh), real_dtype)
    # and the port's own round trip returns its input
    back = inv_t(th)
    check(back, tuple(v.numpy() for v in tx) if isinstance(tx, tuple)
          else tx.numpy(), real_dtype)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("gdims", [(8, 8, 8), (9, 10, 11)])
@pytest.mark.parametrize("form", ["complex", "split", "planes"])
@pytest.mark.parametrize("kind", ["c2c", "r2c"])
def test_fft_f64_matches_jax(kind, form, gdims, layout):
    run_case(kind, form, gdims, layout, np.float64)


@pytest.mark.parametrize("form", ["complex", "split", "planes"])
@pytest.mark.parametrize("kind", ["c2c", "r2c"])
def test_fft_f32_matches_jax(kind, form):
    run_case(kind, form, (16, 12, 10), "axis_contiguous", np.float32)


@pytest.mark.parametrize("gdims", [(9, 8, 8), (10, 9, 11)])
def test_r2c_odd_and_uneven_x(gdims):
    run_case("r2c", "complex", gdims, "axis_contiguous", np.float64)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_c2r_ignores_dc_and_nyquist_imag(layout):
    # a spectrum that is not Hermitian: both packages (and numpy's irfft)
    # drop the imaginary parts of the X DC and Nyquist bins
    gdims = (8, 6, 5)
    jgrid, tgrid = twin_grids(gdims, **LAYOUTS[layout])
    tplan = TFFT(grid=tgrid, real=True)
    jplan = JFFT(grid=jgrid, real=True)
    cg = tplan.complex_grid
    rng = np.random.default_rng(7)
    cgd = cg.gdims
    s = rng.standard_normal(cgd) + 1j * rng.standard_normal(cgd)
    ts = ct.scatter_global(cg, s, 2)
    before = ts.clone()
    got = tplan.inverse(ts)
    assert torch.equal(ts, before)  # the caller's spectrum is not written
    want = jplan.inverse(cd.scatter_global(jplan.complex_grid, s, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10,
                               rtol=0)
    ref = np.fft.irfft(np.fft.ifftn(s, axes=(1, 2)), n=gdims[0], axis=0)
    np.testing.assert_allclose(ct.gather_global(tgrid, got, 0).numpy(), ref,
                               atol=1e-12, rtol=0)


def test_split_inverse_leaves_input_alone():
    _, tgrid = twin_grids((8, 8, 8), **LAYOUTS["axis_contiguous"])
    plan = TFFT(grid=tgrid, real=True, split_complex=True)
    x = torch.randn(tgrid.buffer_shape(0), dtype=torch.float64)
    xh = plan.forward(x)
    assert xh.shape[-1] == 2
    keep = xh.clone()
    back = plan.inverse(xh)
    assert torch.equal(xh, keep)
    torch.testing.assert_close(back, x, atol=1e-12, rtol=0)


def test_stage_planner_matches_jax():
    cases = [((8, 8, 8), p, lay) for p in [(1, 1), (1, 4), (4, 1), (2, 2)]
             for lay in LAYOUTS]
    for gdims, pdims, layout in cases:
        jcfg = cd.GridConfig(gdims=gdims, pdims=pdims, **LAYOUTS[layout])
        jgrid = cd.make_grid(jcfg, devices=jax.devices()[:pdims[0] * pdims[1]])
        tcfg = ct.GridConfig.from_dict(dataclasses.asdict(jcfg))
        for real in (False, True):
            want = JFFT(grid=jgrid, real=real)._stages()
            cfg = complex_grid_config(tcfg) if real else tcfg
            assert plan_stages(cfg) == want, (pdims, layout, real)


@pytest.mark.parametrize("kw", [
    dict(gdims=(9, 8, 8)),
    dict(gdims=(16, 8, 8), gdims_dist=(12, 8, 8)),
    dict(gdims=(16, 8, 8), gdims_dist=(4, 8, 6)),
])
def test_complex_grid_config_matches_jax(kw):
    jcfg = cd.GridConfig(pdims=(2, 2), **kw)
    tcfg = ct.GridConfig.from_dict(dataclasses.asdict(jcfg))
    assert (dataclasses.asdict(complex_grid_config(tcfg))
            == dataclasses.asdict(ct.GridConfig.from_dict(
                dataclasses.asdict(j_complex_cfg(jcfg)))))


@pytest.mark.parametrize("kw", [dict(precision="high"), dict(gauss=True),
                                dict(precision="highest", gauss=False)])
def test_tpu_matmul_policy_rejected(kw):
    _, tgrid = twin_grids((8, 8, 8))
    with pytest.raises(ValueError, match="cuFFT"):
        TFFT(grid=tgrid, split_complex=True, **kw)


def test_form_errors():
    _, tgrid = twin_grids((8, 8, 8))
    with pytest.raises(ValueError, match="split_complex"):
        TFFT(grid=tgrid).forward_planes((torch.zeros(8, 8, 8),) * 2)
    with pytest.raises(ValueError, match="split_complex"):
        TFFT(grid=tgrid).inverse_planes((torch.zeros(8, 8, 8),) * 2)
    with pytest.raises(ValueError, match="trailing dim 2"):
        TFFT(grid=tgrid, split_complex=True).forward(torch.zeros(8, 8, 8, 3))


def test_fft3d_one_shot():
    jgrid, tgrid = twin_grids((6, 5, 4), **LAYOUTS["axis_contiguous"])
    x = inputs("c2c", "complex", (6, 5, 4), np.float64)
    tx = ct.scatter_global(tgrid, x, 0)
    xh = ct.fft3d(tgrid, tx)
    check(xh, JFFT(grid=jgrid).forward(cd.scatter_global(jgrid, x, 0)),
          np.float64)
    torch.testing.assert_close(ct.ifft3d(tgrid, xh), tx, atol=1e-12, rtol=0)
    np.testing.assert_allclose(ct.gather_global(tgrid, xh, 2).numpy(),
                               np.fft.fftn(x), atol=1e-10, rtol=0)


# -- the inverse's one 1/N pass --------------------------------------------------

def _inverse_under_profiler(plan, xh, planes):
    """Run ``plan``'s inverse of ``xh`` with the profiler on: the output,
    the spans and the ``torch.fft`` ops run under ``fft3d_inverse``."""
    tracing.clear_spans()
    with torch.profiler.profile() as prof:
        out = plan.inverse_planes(xh) if planes else plan.inverse(xh)
    spans = tracing.spans()
    tracing.clear_spans()
    ffts = 0
    for e in prof.events():
        up, p = [], e.cpu_parent
        while p is not None:
            up.append(p.name)
            p = p.cpu_parent
        if (e.name.startswith("aten::_fft_")
                and tracing.PREFIX + "fft3d_inverse" in up):
            ffts += 1
    return out, spans, ffts


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("form", ["complex", "split", "planes"])
@pytest.mark.parametrize("kind", ["c2c", "r2c"])
def test_inverse_scales_once_under_one_span(kind, form, layout):
    gdims = (8, 6, 10)
    _, tgrid = twin_grids(gdims, **LAYOUTS[layout])
    plan = TFFT(grid=tgrid, real=kind == "r2c",
                split_complex=form != "complex")
    x = inputs(kind, form, gdims, np.float64)
    if isinstance(x, tuple):
        tx = tuple(ct.scatter_global(tgrid, v, 0) for v in x)
    elif x.ndim == 4:
        tx = torch.stack([ct.scatter_global(tgrid, x[..., j], 0)
                          for j in (0, 1)], -1)
    else:
        tx = ct.scatter_global(tgrid, x, 0)
    planes = form == "planes"
    xh = plan.forward_planes(tx) if planes else plan.forward(tx)
    back, spans, ffts = _inverse_under_profiler(plan, xh, planes)

    roots = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in roots] == [P + "fft3d_inverse"]
    scales = [s for s in spans if s.name == P + "fft_scale"]
    assert len(scales) == 1 and scales[0].parent == roots[0]
    # one torch.fft call a stage, and the r2c's fused stage two (ifftn
    # then irfft): three stages but where the layout fuses them
    n_stages = sum(1 for s in plan_stages(plan.complex_grid.config)
                   if s[0] == "fft")
    want = n_stages + (kind == "r2c" and layout == "natural")
    assert scales[0].counts == {"stages": want} and ffts == want
    for g, w in (zip(back, tx) if planes else [(back, tx)]):
        torch.testing.assert_close(g, w, atol=1e-12, rtol=0)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_complex_inverse_leaves_input_alone(layout):
    _, tgrid = twin_grids((8, 6, 10), **LAYOUTS[layout])
    plan = TFFT(grid=tgrid)
    x = ct.scatter_global(tgrid, inputs("c2c", "complex", (8, 6, 10),
                                        np.float64), 0)
    xh = plan.forward(x)
    keep = xh.clone()
    back = plan.inverse(xh)
    assert torch.equal(xh, keep)
    torch.testing.assert_close(back, x, atol=1e-12, rtol=0)


@pytest.mark.parametrize("gdims,passes", [((4, 8, 128), 1),
                                          ((1, 8, 128), 0)])
def test_k5_keeps_its_own_factor(gdims, passes):
    # K5 (its plain version on the CPU) scales its (1, 2) pair by
    # 1/(N1*N2) itself; the one pass carries the rest, and is left out
    # where K5's factor is the whole 1/N
    _, tgrid = twin_grids(gdims)
    x = torch.from_numpy(inputs("c2c", "split", gdims, np.float32))
    outs = {}
    for fused2 in (False, True):
        plan = TFFT(grid=tgrid, split_complex=True, fused2=fused2)
        xh = plan.forward(x)
        back, spans, ffts = _inverse_under_profiler(plan, xh, False)
        scales = [s.counts for s in spans if s.name == P + "fft_scale"]
        assert scales == ([{"stages": 1}] if passes or not fused2 else [])
        assert ffts == 1
        torch.testing.assert_close(back, x, atol=1e-5, rtol=0)
        outs[fused2] = back
    torch.testing.assert_close(outs[True], outs[False], atol=1e-5, rtol=0)
