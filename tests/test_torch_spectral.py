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
