"""The spectral solvers of cudecomp_tpu_torch against the JAX package's on
the same inputs: the spectral Poisson solve (``solve``, ``jitted``,
continuous and discrete, r2c and c2c, complex and split), the
Taylor-Green solver (IF-RK4 and explicit, complex and plane state, with
its diagnostics) and the projection solver (RK2 and RK4), to 1e-10 in
float64 at pdims (1, 1); the float32 solve with K5 switched on, to 1e-5;
checkpoints written by one package and read by the other on other pdims;
and the 4-rank gloo run of the spectral path against the JAX shards."""

import dataclasses
import enum
import os
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudecomp_tpu as cd
from cudecomp_tpu.models import PoissonSolver as JPoisson
from cudecomp_tpu.models import ProjectionSolver as JProjection
from cudecomp_tpu.models import TaylorGreenSolver as JTG
from cudecomp_tpu.utils import checkpoint as jckpt

import cudecomp_tpu_torch as ct
from cudecomp_tpu_torch.models.incompressible import rk_stability
from cudecomp_tpu_torch.ops import dft2 as D
from cudecomp_tpu_torch.utils import checkpoint as tckpt
from cudecomp_tpu_torch.utils.testing import multirank_worker

AC = dict(transpose_axis_contiguous=(True, True, True))


def twin_grids(gdims, pdims=(1, 1), **kw):
    jcfg = cd.GridConfig(gdims=gdims, pdims=pdims, **kw)
    n = pdims[0] * pdims[1]
    jgrid = cd.make_grid(jcfg, devices=jax.devices()[:n])
    tgrid = ct.make_grid(ct.GridConfig.from_dict(dataclasses.asdict(jcfg)),
                         "cpu") if pdims == (1, 1) else None
    return jgrid, tgrid


def as_np(x):
    if isinstance(x, tuple):
        return np.asarray(x[0]) + 1j * np.asarray(x[1])
    return np.asarray(x)


def close(got, want, tol):
    """Max abs difference <= ``tol`` times max(1, max|want|): spectral
    state of an N^3 grid carries magnitudes up to N^3."""
    g, w = as_np(got), as_np(want)
    assert g.shape == w.shape
    scale = max(1.0, float(np.max(np.abs(w)))) if w.size else 1.0
    np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale)


# -- Poisson ---------------------------------------------------------------------

def poisson_rhs(gdims, real, split, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal(gdims)
    if real:
        return f
    f = f + 1j * rng.standard_normal(gdims)
    return np.stack([f.real, f.imag], axis=-1) if split else f


@pytest.mark.parametrize("layout", ["natural", "axis_contiguous"])
@pytest.mark.parametrize("discrete", [False, True])
@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("real", [True, False])
def test_poisson_solve_matches_jax(real, split, discrete, layout):
    gdims = (12, 10, 8)
    jg, tg = twin_grids(gdims, **(AC if layout == "axis_contiguous" else {}))
    kw = dict(real=real, split_complex=split, lengths=(2 * np.pi, 3.0, 5.0))
    js, ts = JPoisson(grid=jg, **kw), ct.models.PoissonSolver(grid=tg, **kw)
    f = poisson_rhs(gdims, real, split)
    jf = cd.scatter_global(jg, f, 0) if f.ndim == 3 else jnp.stack(
        [cd.scatter_global(jg, f[..., j], 0) for j in range(2)], axis=-1)
    tf = torch.from_numpy(np.asarray(jf))
    got = ts.solve(tf, discrete=discrete)
    close(got.numpy(), js.solve(jf, discrete=discrete), 1e-10)
    if not discrete:
        close(ts.jitted()(tf).numpy(), js.jitted()(jf), 1e-10)
    assert got.dtype == tf.dtype


def test_poisson_scale_fields_match_jax_and_are_cached():
    jg, tg = twin_grids((9, 10, 12), **AC)
    js, ts = JPoisson(grid=jg), ct.models.PoissonSolver(grid=tg)
    close(ts._inv_k2().numpy(), js._inv_k2(), 1e-12)
    close(ts._inv_symbol_fd().numpy(), js._inv_symbol_fd(), 1e-12)
    assert ts._inv_k2() is ts._inv_k2()
    assert ts._scale(False, torch.float32).dtype == torch.float32
    assert ts.plan.real and not ts.plan.split_complex
    other = dataclasses.replace(ts, lengths=(4 * np.pi,) * 3)
    assert other._cache is not ts._cache


def test_poisson_f32_with_k5_matches_jax(monkeypatch):
    # the knob on: the port's r2c split solve runs the (1, 2) pair through
    # dft2 (its plain version on the CPU) twice per solve; JAX runs its
    # Pallas kernel in interpret mode
    monkeypatch.setenv("CUDECOMP_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("CUDECOMP_TPU_FFT_FUSED2", "1")
    gdims = (8, 8, 128)
    jg, tg = twin_grids(gdims)
    f = np.random.default_rng(4).standard_normal(gdims).astype(np.float32)
    want = np.asarray(JPoisson(grid=jg, split_complex=True).solve(
        jnp.asarray(f)))
    calls = []
    real_dft2 = D.dft2
    monkeypatch.setattr("cudecomp_tpu_torch.ops.fft.dft2",
                        lambda x, inv=False: calls.append(inv)
                        or real_dft2(x, inv))
    solver = ct.models.PoissonSolver(grid=tg, split_complex=True)
    got = solver.solve(torch.from_numpy(f))
    assert calls == [False, True] and got.dtype == torch.float32
    assert np.max(np.abs(got.numpy() - want)) <= 1e-5 * np.max(np.abs(want))
    monkeypatch.setenv("CUDECOMP_TPU_FFT_FUSED2", "0")
    off = solver.solve(torch.from_numpy(f))
    assert calls == [False, True]
    assert np.max(np.abs(off.numpy() - got.numpy())) <= 1e-5 * np.max(
        np.abs(want))


# -- Taylor-Green ------------------------------------------------------------------

@pytest.mark.parametrize("integrating_factor", [True, False])
@pytest.mark.parametrize("split", [False, True])
def test_taylor_green_matches_jax(split, integrating_factor):
    gdims, nu, dt = (16, 16, 16), 0.01, 0.01
    jg, tg = twin_grids(gdims)
    kw = dict(nu=nu, split_complex=split,
              integrating_factor=integrating_factor)
    js, ts = JTG(grid=jg, **kw), ct.models.TaylorGreenSolver(grid=tg, **kw)
    juh, jf = js.setup()
    tuh, tf = ts.setup()
    close(tuple(p.numpy() for p in tuh) if split else tuh.numpy(), juh, 1e-12)
    jstep = jax.jit(lambda s: js.step(s, jf, dt))
    for _ in range(3):
        juh = jstep(juh)
        tuh = ts.step(tuh, tf, dt)
    close(tuple(p.numpy() for p in tuh) if split else tuh.numpy(), juh,
          1e-10)
    for name in ("energy", "enstrophy", "dissipation"):
        got = float(getattr(ts, name)(tuh, tf))
        want = float(getattr(js, name)(juh, jf))
        assert abs(got - want) <= 1e-10 * abs(want), name
    close(ts.spectrum(tuh, tf).numpy(), js.spectrum(juh, jf), 1e-12)
    close(ts.spectrum(tuh, tf, nbins=4).numpy(),
          js.spectrum(juh, jf, nbins=4), 1e-12)
    assert abs(float(ts.cfl_dt(tuh, tf, 0.5))
               - float(js.cfl_dt(juh, jf, 0.5))) <= 1e-12


def test_taylor_green_f32_matches_jax_f32():
    # float32 arithmetic against float32 arithmetic: 250 IF-RK4 steps at
    # Re 1600 (JAX with x64 off, so its float64 k fields land in float32,
    # as on an accelerator).  XLA folds JAX's exp(x) * exp(x) into
    # exp(2x); a full-step factor squared in float32 instead rounds twice,
    # the same way every step, and drifts about 3e-5 from JAX here
    gdims, nu, dt, steps = (16, 16, 16), 1.0 / 1600.0, 2e-3, 250
    jg, tg = twin_grids(gdims)
    with jax.enable_x64(False):
        js = JTG(grid=jg, nu=nu, split_complex=True)
        juh, jf = js.setup()
        juh = tuple(p.astype(jnp.float32) for p in juh)
        jstep = jax.jit(lambda s: js.step(s, jf, dt))
        for _ in range(steps):
            juh = jstep(juh)
        want = [float(js.energy(juh, jf)), float(js.dissipation(juh, jf))]
        assert juh[0].dtype == jnp.float32
    ts = ct.models.TaylorGreenSolver(grid=tg, nu=nu, split_complex=True)
    tuh, tf = ts.setup(torch.float32)
    for _ in range(steps):
        tuh = ts.step(tuh, tf, dt)
    assert tuh[0].dtype == torch.float32
    close(tuple(p.numpy() for p in tuh), juh, 1e-5)
    got = [float(ts.energy(tuh, tf)), float(ts.dissipation(tuh, tf))]
    for a, b in zip(got, want):
        assert abs(a - b) <= 1e-5 * abs(b)


def test_taylor_green_run_matches_jax():
    jg, tg = twin_grids((16, 12, 8))
    _, jh = JTG(grid=jg, nu=0.02).run(2, 0.01)
    uh, th = ct.models.TaylorGreenSolver(grid=tg, nu=0.02).run(2, 0.01)
    np.testing.assert_allclose(th, jh, rtol=1e-10)
    assert uh.dtype == torch.complex128  # float64 on the CPU by default


# -- projection solver -------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["rk2", "rk4"])
@pytest.mark.parametrize("split", [False, True])
def test_projection_solver_matches_jax(split, scheme):
    gdims, nu, dt = (16, 16, 8), 0.05, 0.02  # hx == hy: the R(z) contract
    jg, tg = twin_grids(gdims)
    kw = dict(nu=nu, split_complex=split, scheme=scheme)
    js, ts = JProjection(grid=jg, **kw), ct.models.ProjectionSolver(grid=tg,
                                                                    **kw)
    ju, jf = js.setup_tg()
    tu, tf = ts.setup_tg()
    close(tf["inv_sym"].numpy(), jf["inv_sym"], 1e-12)
    jstep = jax.jit(lambda v: js.step(v, jf, dt))
    for _ in range(2):
        ju = jstep(ju)
        tu = ts.step(tu, tf, dt)
    close(tu.numpy(), ju, 1e-10)
    # the extruded TG contract: R(z)^n * u0, divergence-free
    u0, _ = ts.setup_tg()
    amp = rk_stability(scheme, ts.viscous_eigenvalue((1, 1, 0)) * dt) ** 2
    close(tu.numpy(), amp * u0.numpy(), 1e-11)
    assert float(ts.max_divergence(tu)) < 1e-11
    assert abs(float(ts.energy(tu)) - float(js.energy(ju))) <= 1e-12
    # a random field: the Leray projection and run_scan
    v = np.random.default_rng(5).standard_normal(gdims + (3,))
    close(ts.leray(torch.from_numpy(v), tf).numpy(),
          js.leray(jnp.asarray(v), jf), 1e-10)
    close(ts.run_scan(torch.from_numpy(v), tf, 2, dt).numpy(),
          js.run_scan(jnp.asarray(v), jf, 2, dt), 1e-10)


def test_projection_solver_rejects_an_unknown_scheme():
    _, tg = twin_grids((8, 8, 8))
    with pytest.raises(ValueError, match="unknown scheme"):
        ct.models.ProjectionSolver(grid=tg, scheme="rk3")


# -- dtypes --------------------------------------------------------------------------

@pytest.mark.parametrize("split", [False, True])
def test_f32_state_stays_f32(split):
    # the solvers build their k-derived fields in float64; a float32
    # state must not be promoted to float64 / complex128 by them
    gdims = (16, 8, 8)
    _, tg = twin_grids(gdims)
    tgs = ct.models.TaylorGreenSolver(grid=tg, split_complex=split)
    uh, f = tgs.setup(dtype=torch.float32)
    uh = tgs.step(uh, f, 0.01)
    if split:
        assert all(p.dtype == torch.float32 for p in uh)
    else:
        assert uh.dtype == torch.complex64
    assert tgs.energy(uh, f).dtype == torch.float32
    ps = ct.models.PoissonSolver(grid=tg, split_complex=split)
    x = torch.randn(gdims, generator=torch.Generator().manual_seed(0))
    assert ps.solve(x).dtype == torch.float32
    assert ps.solve(x, discrete=True).dtype == torch.float32
    ns = ct.models.ProjectionSolver(grid=tg, split_complex=split)
    u, nf = ns.setup_tg(dtype=torch.float32)
    plan = nf["plan"]
    dh = (plan.forward_planes if split else plan.forward)(ns.divergence(u))
    assert (dh[0] if split else dh).dtype == (torch.float32 if split
                                              else torch.complex64)
    assert ns.step(u, nf, 0.01).dtype == torch.float32


# -- checkpoints -----------------------------------------------------------------------

def test_checkpoint_jax_written_loads_into_the_port(tmp_path):
    gdims = (16, 12, 10)
    jg, _ = twin_grids(gdims, pdims=(2, 4))
    js = JTG(grid=jg, nu=0.02)
    uh, f = js.setup()
    uh = js.step(uh, f, 0.01)
    cgrid = f["plan"].complex_grid
    jckpt.save_pencil(str(tmp_path / "tg"), cgrid, uh, 2)
    want = np.stack([np.asarray(cd.gather_global(cgrid, uh[..., c], 2))
                     for c in range(3)], axis=-1)
    for kw in ({}, AC):
        _, tg = twin_grids(gdims, **kw)
        tplan = ct.DistributedFFT(grid=tg, real=True)
        got = tckpt.load_pencil(str(tmp_path / "tg"), tplan.complex_grid,
                                axis=2)
        assert got.dtype == torch.complex128
        back = ct.gather_global(tplan.complex_grid, got, 2).numpy()
        np.testing.assert_array_equal(back, want)


def test_checkpoint_port_written_loads_into_jax(tmp_path):
    gdims = (9, 10, 12)
    _, tg = twin_grids(gdims, **AC)
    rng = np.random.default_rng(6)
    x = rng.standard_normal(gdims + (3,)).astype(np.float32)
    local = torch.stack([ct.scatter_global(tg, torch.from_numpy(x[..., c]),
                                           1) for c in range(3)], dim=-1)
    tckpt.save_pencil(str(tmp_path / "v"), tg, local, 1)
    jg, _ = twin_grids(gdims, pdims=(2, 2))
    got = jckpt.load_pencil(str(tmp_path / "v"), jg)
    assert got.dtype == jnp.float32
    back = np.stack([np.asarray(cd.gather_global(jg, got[..., c], 1))
                     for c in range(3)], axis=-1)
    np.testing.assert_array_equal(back, x)


def test_checkpoint_halos_and_errors(tmp_path):
    gdims = (8, 10, 12)
    _, tg = twin_grids(gdims)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(gdims))
    he = (1, 2, 1)
    buf = ct.scatter_global(tg, x, 0, halo_extents=he)
    tckpt.save_pencil(str(tmp_path / "h"), tg, buf, 0, halo_extents=he)
    got = tckpt.load_pencil(str(tmp_path / "h"), tg, fill_halos=True)
    want = ct.scatter_global(tg, x, 0, halo_extents=he, fill_halos=True)
    assert torch.equal(got, want)
    plain = tckpt.load_pencil(str(tmp_path / "h"), tg, axis=2,
                              halo_extents=(0, 0, 0))
    assert torch.equal(plain, ct.scatter_global(tg, x, 2))
    _, other = twin_grids((8, 10, 11))
    with pytest.raises(ValueError, match="gdims"):
        tckpt.load_pencil(str(tmp_path / "h"), other)
    with pytest.raises(ValueError, match="layout"):
        tckpt.save_pencil(str(tmp_path / "bad"), tg, x[:4], 0)


# -- 4 gloo ranks against the JAX shards ------------------------------------------

def _shards(grid, arr, axis):
    from cudecomp_tpu import geometry as jgeo
    from cudecomp_tpu.utils.arrays import coords_of_shard_index
    local = jgeo.pencil_buffer_shape(grid.config, axis)
    out = {}
    for shard in arr.addressable_shards:
        coords = coords_of_shard_index(grid, axis, shard.index, local)
        out[tuple(int(c) for c in coords)] = np.asarray(shard.data)
    return out


def _jax_spectral_case(name, tmp_path, nu=0.02, dt=0.01, **kw):
    jcfg = cd.GridConfig(**kw)
    n = jcfg.pdims[0] * jcfg.pdims[1]
    grid = cd.make_grid(jcfg, devices=jax.devices()[:n])
    f = np.random.default_rng(zlib.crc32(name.encode())).standard_normal(
        jcfg.gdims)
    u = JPoisson(grid=grid).solve(cd.scatter_global(grid, f, 0))
    solver = JTG(grid=grid, nu=nu)
    uh, fields = solver.setup()
    uh = jax.jit(lambda s: solver.step(s, fields, dt))(uh)
    cgrid = fields["plan"].complex_grid
    tg_global = np.stack([np.asarray(cd.gather_global(cgrid, uh[..., c], 2))
                          for c in range(3)], axis=-1)
    config = {k: (v.value if isinstance(v, enum.Enum) else v)
              for k, v in dataclasses.asdict(jcfg).items()}
    case = dict(name=name, kind="spectral", config=config, field=f, nu=nu,
                dt=dt, ckpt=str(tmp_path / name),
                spectrum=np.asarray(solver.spectrum(uh, fields)),
                shards={"poisson": _shards(grid, u, 0),
                        "tg": _shards(cgrid, uh, 2)})
    return case, tg_global


def test_four_gloo_ranks_run_the_spectral_path(tmp_path):
    built = [_jax_spectral_case("spectral-uneven-2x2", tmp_path,
                                gdims=(9, 10, 11), pdims=(2, 2)),
             _jax_spectral_case("spectral-uneven-1x4-ac", tmp_path,
                                gdims=(9, 10, 11), pdims=(1, 4), **AC)]
    cases = [c for c, _ in built]
    ctx = torch.multiprocessing.start_processes(
        multirank_worker, args=(4, str(tmp_path / "pg_init"), cases),
        nprocs=4, join=False, start_method="spawn")
    deadline = time.monotonic() + 300
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            for p in ctx.processes:
                p.join(10)
            pytest.fail("the 4-rank gloo run did not finish in 300 s")
    assert all(p.exitcode == 0 for p in ctx.processes)
    # the ranks' checkpoint of the stepped state, read back by JAX on 1
    # device
    for case, want in built:
        jcfg = cd.GridConfig(gdims=case["config"]["gdims"], pdims=(1, 1))
        grid = cd.make_grid(jcfg, devices=jax.devices()[:1])
        cgrid = cd.DistributedFFT(grid=grid, real=True).complex_grid
        got = np.asarray(jckpt.load_pencil(case["ckpt"], cgrid))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


# -- the spectral headlines ------------------------------------------------------

def test_spectral_headlines_need_cuda(monkeypatch):
    from cudecomp_tpu_torch import bench
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (bench.poisson_headline, bench.tg_headline, bench.ns_headline):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(N=8)


def test_fused2_knob_is_restored(monkeypatch):
    from cudecomp_tpu_torch import bench
    from cudecomp_tpu_torch.utils.env import fft_fused2
    monkeypatch.delenv("CUDECOMP_TPU_FFT_FUSED2", raising=False)
    assert not fft_fused2()
    with bench.fused2(True):
        assert fft_fused2()
        with bench.fused2(False):
            assert not fft_fused2()
        assert fft_fused2()
    assert "CUDECOMP_TPU_FFT_FUSED2" not in os.environ
