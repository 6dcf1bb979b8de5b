"""The spectral operators of cudecomp_tpu_torch (``ops/spectral.py``)
against the JAX package's on the same spectral state, made with numpy:
every operator, r2c and c2c plans, complex and split (plane) state, the
natural and an axis-contiguous layout, to 1e-12 in float64.  The padded
per-rank wavenumber layout is held to the JAX package's on uneven grids
at pdims other than (1, 1); the 4-rank gloo cases (``test_torch_models.py``)
run the operators on sharded state."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudecomp_tpu as cd
from cudecomp_tpu.ops import spectral as JS
from cudecomp_tpu.ops.fft import DistributedFFT as JFFT

import cudecomp_tpu_torch as ct
from cudecomp_tpu_torch.ops import spectral as TS
from cudecomp_tpu_torch.ops.fft import DistributedFFT as TFFT

GDIMS = (16, 12, 8)
LAYOUTS = {"natural": {},
           "axis_contiguous": dict(transpose_axis_contiguous=(True,) * 3)}
ATOL = 1e-12


def twin_plans(real, split, layout, gdims=GDIMS):
    jcfg = cd.GridConfig(gdims=gdims, pdims=(1, 1), **LAYOUTS[layout])
    jgrid = cd.make_grid(jcfg, devices=jax.devices()[:1])
    tgrid = ct.make_grid(ct.GridConfig.from_dict(dataclasses.asdict(jcfg)),
                         "cpu")
    return (JFFT(grid=jgrid, real=real, split_complex=split),
            TFFT(grid=tgrid, real=real, split_complex=split))


def twin_ops(real, split, layout, **kw):
    jp, tp = twin_plans(real, split, layout)
    return (JS.SpectralOperators(plan=jp, dtype=np.float64, **kw),
            TS.SpectralOperators(plan=tp, dtype=np.float64, **kw))


def state(tplan, split, comp=False, seed=0):
    """Random spectral state on the plan's Z-pencil as (jax, torch)."""
    shape = tplan.complex_grid.buffer_shape(2) + ((3,) if comp else ())
    rng = np.random.default_rng(seed)
    r, i = rng.standard_normal(shape), rng.standard_normal(shape)
    if split:
        return ((jnp.asarray(r), jnp.asarray(i)),
                (torch.from_numpy(r), torch.from_numpy(i)))
    c = r + 1j * i
    return jnp.asarray(c), torch.from_numpy(c)


def as_np(x):
    if isinstance(x, tuple):
        return np.asarray(x[0]) + 1j * np.asarray(x[1])
    return np.asarray(x)


def same(got, want, atol=ATOL):
    g, w = as_np(got), as_np(want)
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=0, atol=atol)


def _fields(jo, to, split):
    for a, b in zip(jo.wavenumbers(), to.wavenumbers()):
        same(b.numpy(), a)
    same(to.k_squared().numpy(), jo.k_squared())
    same(to.inv_k_squared().numpy(), jo.inv_k_squared())
    for frac in (2.0 / 3.0, 0.5):
        same(to.mask(frac).numpy(), jo.mask(frac))


def _derivative(jo, to, split):
    js, ts = state(to.plan, split)
    for axis in range(3):
        for order in (1, 2, 3, 4):
            same(to.derivative(ts, axis, order), jo.derivative(js, axis, order))


def _gradient(jo, to, split):
    js, ts = state(to.plan, split)
    same(to.gradient(ts), jo.gradient(js))


def _divergence(jo, to, split):
    js, ts = state(to.plan, split, comp=True)
    same(to.divergence(ts), jo.divergence(js))


def _curl(jo, to, split):
    js, ts = state(to.plan, split, comp=True)
    same(to.curl(ts), jo.curl(js))


def _laplacian(jo, to, split):
    js, ts = state(to.plan, split)
    same(to.laplacian(ts), jo.laplacian(js))
    js, ts = state(to.plan, split, comp=True)
    same(to.laplacian(ts, comp=True), jo.laplacian(js, comp=True))


def _dealias(jo, to, split):
    js, ts = state(to.plan, split)
    same(to.dealias(ts), jo.dealias(js))
    js, ts = state(to.plan, split, comp=True)
    same(to.dealias(ts, 0.5, comp=True), jo.dealias(js, 0.5, comp=True))


def _shell_spectrum(jo, to, split):
    js, ts = state(to.plan, split)
    same(to.shell_spectrum(ts).numpy(), jo.shell_spectrum(js))
    # too few bins: shells past the last are dropped, as segment_sum does
    same(to.shell_spectrum(ts, nbins=3).numpy(),
         jo.shell_spectrum(js, nbins=3))
    js, ts = state(to.plan, split, comp=True)
    same(to.shell_spectrum(ts, comp=True).numpy(),
         jo.shell_spectrum(js, comp=True))


def _project_solenoidal(jo, to, split):
    js, ts = state(to.plan, split, comp=True)
    same(to.project_solenoidal(ts), jo.project_solenoidal(js))


OPS = {f.__name__[1:]: f for f in (
    _fields, _derivative, _gradient, _divergence, _curl, _laplacian,
    _dealias, _shell_spectrum, _project_solenoidal)}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("op", list(OPS))
def test_operator_matches_jax(op, real, split, layout):
    jo, to = twin_ops(real, split, layout)
    OPS[op](jo, to, split)


def test_anisotropic_lengths_match_jax():
    L = (4.0, 2 * np.pi, np.pi)
    jo, to = twin_ops(True, False, "natural", lengths=L)
    js, ts = state(to.plan, False, comp=True)
    same(to.curl(ts), jo.curl(js))
    same(to.shell_spectrum(ts, comp=True).numpy(),
         jo.shell_spectrum(js, comp=True))


def test_materialized_fields_match_jax():
    for layout in LAYOUTS:
        jp, tp = twin_plans(True, False, layout)
        for a, b in zip(JS.wavenumber_fields(jp), TS.wavenumber_fields(tp)):
            same(b.numpy(), a)
        same(TS.dealias_mask(tp).numpy(), JS.dealias_mask(jp))
        ops = TS.SpectralOperators(plan=tp, dtype=np.float64)
        kx, ky, kz = TS.wavenumber_fields(tp)
        same((kx * kx + ky * ky + kz * kz).numpy(), ops.k_squared().numpy())


@pytest.mark.parametrize("pdims,gdims,kw", [
    ((2, 2), (9, 10, 11), {}),
    ((1, 4), (9, 10, 11), {}),
    ((4, 1), (16, 10, 7), {}),
    ((2, 2), (9, 10, 11), LAYOUTS["axis_contiguous"]),
    ((3, 2), (8, 12, 10), dict(gdims_dist=(8, 10, 8))),
])
def test_padded_axis_vector_matches_jax(pdims, gdims, kw):
    # the per-shard [valid | zero tail] layout of the padded spectral
    # Z-pencil, and this rank's block of it at every coordinate
    jcfg = cd.GridConfig(gdims=gdims, pdims=pdims, **kw)
    tcfg = ct.GridConfig.from_dict(dataclasses.asdict(jcfg))
    for real in (True, False):
        jc = cd.ops.fft.complex_grid_config(jcfg) if real else jcfg
        tc = ct.ops.fft.complex_grid_config(tcfg) if real else tcfg
        n = jc.gdims
        for g in range(3):
            vals = np.arange(1, n[g] + 1, dtype=np.float64)
            want = JS._padded_axis_vector(types.SimpleNamespace(config=jc),
                                          vals, g)
            got = TS._padded_axis_vector(types.SimpleNamespace(config=tc),
                                         vals, g)
            np.testing.assert_array_equal(got, want)
            for pr in range(pdims[0]):
                for pc in range(pdims[1]):
                    cg = types.SimpleNamespace(config=tc, coords=(pr, pc),
                                               device=torch.device("cpu"))
                    blk = TS._local_broadcast(cg, vals, g).reshape(-1)
                    info = ct.get_pencil_info(tc, 2, (pr, pc))
                    valid = info.hi_g[g] - info.lo_g[g] + 1
                    np.testing.assert_array_equal(
                        blk[:valid].numpy(),
                        vals[info.lo_g[g]:info.hi_g[g] + 1])
                    assert not bool(blk[valid:].any())


def test_f32_state_stays_f32_through_f64_fields():
    _, tp = twin_plans(True, False, "natural")
    ops = TS.SpectralOperators(plan=tp, dtype=np.float64)
    _, ts = state(tp, False, comp=True)
    ts = ts.to(torch.complex64)
    for out in (ops.curl(ts), ops.project_solenoidal(ts),
                ops.laplacian(ts, comp=True), ops.dealias(ts, comp=True)):
        assert out.dtype == torch.complex64
    _, tp = twin_plans(True, True, "natural")
    ops = TS.SpectralOperators(plan=tp, dtype=np.float64)
    _, (r, i) = state(tp, True, comp=True)
    out = ops.curl((r.float(), i.float()))
    assert all(p.dtype == torch.float32 for p in out)


# -- the curl and the masked projection: layout, mask, dispatch, C2's addressing --

from cudecomp_tpu_torch.ops import spectral_kernel as SK  # noqa: E402


def planar(t):
    """``t`` (..., 3) with a contiguous plane per component: the layout
    the distributed FFT gives a vector state."""
    return t.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)


def _masked_ops():
    _, to = twin_ops(True, False, "natural")
    _, ts = state(to.plan, False, comp=True, seed=3)
    rng = np.random.default_rng(4)
    m = torch.from_numpy(rng.uniform(0.0, 1.0, ts.shape[:3]))
    return to, ts, m


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("split", [False, True])
def test_masked_projection_is_the_projection_of_the_masked_state(split,
                                                                 layout):
    _, to = twin_ops(True, split, layout)
    _, ts = state(to.plan, split, comp=True, seed=1)
    shape = (ts[0] if split else ts).shape[:3]
    m = torch.from_numpy(np.random.default_rng(2).uniform(0.0, 1.0, shape))
    got = to.project_solenoidal(ts, mask=m)
    want = to.project_solenoidal(
        tuple(m[..., None] * p for p in ts) if split else m[..., None] * ts)
    for g, w in zip(*((got, want) if split else ((got,), (want,)))):
        assert torch.equal(g, w)


@pytest.mark.parametrize("op", ["curl", "project", "project_masked"])
@pytest.mark.parametrize("lay", ["planar", "interleaved"])
def test_curl_and_projection_keep_the_input_layout(op, lay):
    to, ts, m = _masked_ops()
    vh = planar(ts) if lay == "planar" else ts
    assert vh.is_contiguous() == (lay == "interleaved")
    fn = {"curl": to.curl, "project": to.project_solenoidal,
          "project_masked": lambda v: to.project_solenoidal(v, mask=m)}[op]
    got = fn(vh)
    assert got.stride() == vh.stride() and got.dtype == vh.dtype
    assert torch.equal(got, fn(vh.contiguous()))


def test_grad_plane_tuples_and_other_dtypes_take_the_formula():
    # on the CPU every state takes the formulas, and counts say so
    to, ts, m = _masked_ops()
    x = ts.clone().requires_grad_(True)
    for vh in (ts, ts.to(torch.complex64), x, (ts.real, ts.imag),
               ts.real, ts[..., :2]):
        assert not SK.takes(vh)
    assert SK.counts(ts) == {"bytes": 2 * ts.numel() * 16, "kernel": 0}
    assert SK.counts(ts, m) == {"bytes": 2 * ts.numel() * 16
                                + m.numel() * 8, "kernel": 0}
    assert SK.counts((ts.real, ts.imag))["bytes"] == 2 * ts.numel() * 16
    # the formulas differentiate, in the input's layout
    x = planar(ts).requires_grad_(True)
    for fn in (to.curl, lambda v: to.project_solenoidal(v, mask=m)):
        out = fn(x)
        assert out.requires_grad and out.stride() == x.stride()
        assert torch.autograd.gradcheck(fn, (x,), fast_mode=True)


@pytest.mark.parametrize("op", ["curl", "project", "project_masked"])
def test_curl_and_projection_keep_a_plane_pairs_layout(op):
    to, ts, m = _masked_ops()
    to = _ops_with(to.wavenumbers(), split=True)
    vh = (planar(ts.real.contiguous()), planar(ts.imag.contiguous()))
    fn = {"curl": to.curl, "project": to.project_solenoidal,
          "project_masked": lambda v: to.project_solenoidal(v, mask=m)}[op]
    got = fn(vh)
    want = fn(tuple(p.contiguous() for p in vh))
    for g, w, p in zip(got, want, vh):
        assert g.stride() == p.stride() and torch.equal(g, w)


def _kernel_model(words, planes, outs, ks, mask, project):
    """C2 as its ``Geometry`` words address memory: every tensor read
    through ``as_strided`` views of its storage by the words alone (a
    plane pair's two tensors by the same words), the kernel's arithmetic
    per point, the result written through views of the outputs'
    storage."""
    n, vs, os_, kst, ms = (words[0:3], words[3:7], words[7:11],
                           words[11:20], words[20:23])
    view = lambda t, size, st: torch.as_strided(t, size, st,
                                                t.storage_offset())
    comp = lambda t, st, c: torch.as_strided(
        t, n, st[:3], t.storage_offset() + c * st[3])
    if len(planes) == 2:
        a = [torch.complex(comp(planes[0], vs, c), comp(planes[1], vs, c))
             for c in range(3)]
    else:
        a = [comp(planes[0], vs, c) for c in range(3)]
    kx, ky, kz = (view(k, n, kst[3 * g:3 * g + 3]) for g, k in enumerate(ks))
    if project:
        if mask is not None:
            mm = view(mask, n, ms)
            a = [mm * c for c in a]
        k2 = kx * kx + ky * ky + kz * kz
        inv = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0), 0.0)
        s = inv * (kx * a[0] + ky * a[1] + kz * a[2])
        w = [a[0] - kx * s, a[1] - ky * s, a[2] - kz * s]
    else:
        w = [1j * (ky * a[2] - kz * a[1]), 1j * (kz * a[0] - kx * a[2]),
             1j * (kx * a[1] - ky * a[0])]
    for c in range(3):
        if len(outs) == 2:
            comp(outs[0], os_, c).copy_(w[c].real)
            comp(outs[1], os_, c).copy_(w[c].imag)
        else:
            comp(outs[0], os_, c).copy_(w[c])
    return outs


def _pencil_case(pdims, coords, kw, gdims=(9, 8, 7), seed=0):
    """A random (X, Y, Z, 3) state of the rank ``coords`` of an r2c grid
    on ``pdims``, with random per-axis wavenumber vectors laid out as
    that rank's broadcast blocks: a Z-pencil whose dims may hold the
    global axes in another order."""
    tc = ct.ops.fft.complex_grid_config(
        ct.GridConfig(gdims=gdims, pdims=pdims, **kw))
    cg = types.SimpleNamespace(config=tc, coords=coords,
                               device=torch.device("cpu"))
    rng = np.random.default_rng(seed)
    ks = tuple(TS._local_broadcast(cg, rng.standard_normal(tc.gdims[g]), g)
               for g in range(3))
    shape = ct.geometry.pencil_buffer_shape(tc, 2, None, None) + (3,)
    v = torch.from_numpy(rng.standard_normal(shape)
                         + 1j * rng.standard_normal(shape))
    return v, ks


def _ops_with(ks, split=False):
    """Spectral operators whose wavenumbers are ``ks``."""
    ops = TS.SpectralOperators(plan=types.SimpleNamespace(split_complex=split))
    ops._cache["k"] = ks
    return ops


@pytest.mark.parametrize("case", ["planar", "interleaved", "pencil_2x1_ac",
                                  "pencil_1x2"])
@pytest.mark.parametrize("op", ["curl", "project", "project_masked"])
def test_kernel_geometry_addresses_the_formula(case, op):
    if case.startswith("pencil"):
        pd, kw = (((2, 1), LAYOUTS["axis_contiguous"]) if case.endswith("ac")
                  else ((1, 2), {}))
        v, ks = _pencil_case(pd, (1, 0) if pd == (2, 1) else (0, 1), kw)
    else:
        v, ks = _pencil_case((1, 1), (0, 0), {})
        v = planar(v) if case == "planar" else v
    mask = None
    if op == "project_masked":
        mask = torch.from_numpy(
            np.random.default_rng(5).uniform(0, 1, v.shape[:3]))
    ops = _ops_with(ks)
    want = (ops._curl_formula(v) if op == "curl"
            else ops._project_formula(v, mask))
    out = torch.empty_like(v)
    spatial = v.shape[:3]
    kx = [k.expand(spatial) for k in ks]
    mx = None if mask is None else mask.expand(spatial)
    words = SK.geometry(v, out, kx, mx)
    assert len(words) == SK.GEOMETRY_WORDS
    assert sorted(words[:3]) == sorted(spatial)
    inner = words[5]  # the input stride of the walked dim
    assert inner == min(abs(v.stride(d)) for d in range(3) if v.shape[d] > 1)
    (got,) = _kernel_model(words, (v,), (out,), kx, mx, op != "curl")
    assert got.stride() == v.stride()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-13)


def _model_launch(calls):
    """A stand-in for ``spectral_kernel._launch`` that runs
    :func:`_kernel_model` on the wrapper's own operands, recording each
    entry it is asked for."""
    def launch(entry, planes, ks, mask):
        calls.append(entry)
        planes, outs, ks, mask, words = SK.operands(planes, ks, mask)
        return _kernel_model(words, planes, outs, ks, mask,
                             entry == "project")
    return launch


@pytest.mark.parametrize("case", ["planar", "pencil_2x1_ac"])
@pytest.mark.parametrize("op", ["curl", "project", "project_masked"])
def test_kernel_geometry_addresses_the_formula_on_plane_pairs(monkeypatch,
                                                               case, op):
    if case == "planar":
        v, ks = _pencil_case((1, 1), (0, 0), {})
        v = planar(v)
    else:
        v, ks = _pencil_case((2, 1), (1, 0), LAYOUTS["axis_contiguous"])
    pair = (v.real.contiguous(), v.imag.contiguous())
    if case == "planar":  # two layouts: the wrapper aligns them
        pair = (planar(pair[0]), pair[1])
    mask = None
    if op == "project_masked":
        mask = torch.from_numpy(
            np.random.default_rng(6).uniform(0, 1, v.shape[:3]))
    calls = []
    monkeypatch.setattr(SK, "_launch", _model_launch(calls))
    ops = _ops_with(ks, split=True)
    got = (SK.curl(pair, ks) if op == "curl"
           else SK.project(pair, ks, mask))
    want = (ops._curl_formula(pair) if op == "curl"
            else ops._project_formula(pair, mask))
    assert calls == ["curl" if op == "curl" else "project"]
    assert isinstance(got, tuple) and len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-13)


@pytest.mark.parametrize("form", ["complex", "planes"])
@pytest.mark.parametrize("op", ["curl", "project", "project_masked"])
def test_c2_backward_is_one_pass_of_the_same_entry(monkeypatch, form, op):
    """The gradient of the state is one more pass of the forward's entry
    (both operators are self-adjoint), the mask's one unmasked projection
    pass more; gradcheck holds both, and their own gradients, to finite
    differences of the forward."""
    calls = []
    monkeypatch.setattr(SK, "_launch", _model_launch(calls))
    v, ks = _pencil_case((1, 1), (0, 0), {})
    v = planar(v)
    rng = np.random.default_rng(7)
    mask = (torch.from_numpy(rng.uniform(0.5, 1.0, v.shape[:3]))
            .requires_grad_(True) if op == "project_masked" else None)
    if form == "complex":
        ins = (v.clone().requires_grad_(True),)
    else:
        ins = tuple(planar(p.contiguous()).requires_grad_(True)
                    for p in (v.real, v.imag))
    entry = "curl" if op == "curl" else "project"

    def fn(*xs):
        state = xs[0] if form == "complex" else tuple(xs[:2])
        m = xs[-1] if mask is not None else None
        return (SK.curl(state, ks) if entry == "curl"
                else SK.project(state, ks, m))

    args = ins + (() if mask is None else (mask,))
    out = fn(*args)
    outs = out if isinstance(out, tuple) else (out,)
    assert all(o.stride() == ins[0].stride() for o in outs)
    calls.clear()
    sum((o.abs() ** 2).sum() for o in outs).backward()
    assert calls == [entry] + (["project"] if mask is not None else [])
    assert all(x.grad is not None for x in args)
    assert torch.autograd.gradcheck(fn, args, fast_mode=True)
    assert torch.autograd.gradgradcheck(fn, args, fast_mode=True)
