"""The port's slices end to end: the benchmark's round trip against the
JAX package, the 4-rank gloo run of transposes, FFTs, halo updates, the
ghost-plane stencil path, the CG solve and the kernel exchanges' path
(``PALLAS_A2A``, ``HaloMethod.PALLAS``) against the JAX shards, and the
port's independence from JAX."""

import dataclasses
import enum
import os
import re
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudecomp_tpu as cd
from cudecomp_tpu import geometry as jgeo
from cudecomp_tpu.models import PoissonSolver as JPoisson
from cudecomp_tpu.ops.fft import DistributedFFT as JFFT
from cudecomp_tpu.utils.arrays import coords_of_shard_index

from cudecomp_tpu_torch import bench, performance
from cudecomp_tpu_torch.utils.testing import multirank_worker, run_ranks

ROOT = Path(__file__).resolve().parent.parent


def test_bench_cycle_matches_jax_planes():
    # the port's benchmark cycle (complex64, interleaved) at 32^3 against
    # the JAX bench's plane-carried cycle on the same field
    N = 32
    plan = bench.make_plan(N, axis_contiguous=True, device="cpu")
    assert plan.grid.config.transpose_axis_contiguous == (True, True, True)
    x = bench.make_field(plan.grid, seed=0)
    assert x.dtype == torch.complex64 and tuple(x.shape) == (N, N, N)
    xh = plan.forward(x)
    out = bench.cycle(plan, x)

    jcfg = cd.GridConfig(gdims=(N, N, N), pdims=(1, 1),
                         transpose_axis_contiguous=(True, True, True))
    jgrid = cd.make_grid(jcfg, devices=jax.devices()[:1])
    jplan = JFFT(grid=jgrid, split_complex=True)
    planes = (jnp.asarray(x.real.numpy()), jnp.asarray(x.imag.numpy()))
    jh = jplan.forward_planes(planes)
    jout = jplan.inverse_planes(jh)

    want_h = np.asarray(jh[0]) + 1j * np.asarray(jh[1])
    rel = np.linalg.norm(xh.numpy() - want_h) / np.linalg.norm(want_h)
    assert rel <= 1e-5
    want = np.asarray(jout[0]) + 1j * np.asarray(jout[1])
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-5)
    assert bench.max_abs_err(out, x) < bench.GATE


def test_bench_and_timing_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(N=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        performance.time_fn(lambda: None)


def test_bench_field_is_seeded():
    plan = bench.make_plan(8, device="cpu")
    a = bench.make_field(plan.grid, seed=5)
    assert torch.equal(a, bench.make_field(plan.grid, seed=5))
    assert not torch.equal(a, bench.make_field(plan.grid, seed=6))
    r = bench.make_field(plan.grid, seed=5, dtype=torch.float32)
    assert r.dtype == torch.float32 and tuple(r.shape) == (8, 8, 8)


def test_port_never_imports_jax():
    code = ("import sys, cudecomp_tpu_torch, cudecomp_tpu_torch.bench, "
            "cudecomp_tpu_torch.performance, "
            "cudecomp_tpu_torch.ops.cuda_kernels, "
            "cudecomp_tpu_torch.ops.stencil_kernel, "
            "cudecomp_tpu_torch.ops.halo, cudecomp_tpu_torch.ops.stencil, "
            "cudecomp_tpu_torch.ops.dft2, cudecomp_tpu_torch.ops.spectral, "
            "cudecomp_tpu_torch.models, cudecomp_tpu_torch.utils.checkpoint, "
            "cudecomp_tpu_torch.models.taylor_green, "
            "cudecomp_tpu_torch.models.incompressible, "
            "cudecomp_tpu_torch.utils.cuda_build, "
            "cudecomp_tpu_torch.ops.peer_kernels, "
            "cudecomp_tpu_torch.parallel.symmetric, "
            "cudecomp_tpu_torch.utils.testing, cudecomp_tpu_torch.utils.env\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'cudecomp_tpu' "
            "or m.startswith('cudecomp_tpu.')]\n"
            "assert not bad, bad\nprint('CLEAN')")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0 and "CLEAN" in res.stdout, res.stderr[-2000:]
    pat = re.compile(r"^\s*(import|from) (jax|cudecomp_tpu)\b", re.M)
    for src in sorted((ROOT / "cudecomp_tpu_torch").rglob("*.py")):
        assert not pat.search(src.read_text()), src
    assert not pat.search((ROOT / "chip_smoke.py").read_text())


def test_chip_smoke_fails_without_cuda_or_repo(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=240, env=env)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=240, env=env)
    assert res.returncode != 0 and '"ok"' not in res.stdout


# -- 4 gloo ranks against the JAX shards ------------------------------------------

def _shards(grid, arr, axis):
    """{(pr, pc): numpy local tensor} of a JAX padded-pencil array."""
    local = jgeo.pencil_buffer_shape(grid.config, axis)
    out = {}
    for shard in arr.addressable_shards:
        if getattr(shard, "replica_id", 0) != 0:
            continue
        coords = coords_of_shard_index(grid, axis, shard.index, local)
        out[tuple(int(c) for c in coords)] = np.asarray(shard.data)
    return out


def _spec(jcfg):
    """The config as plain values: the ranks never import the JAX package."""
    return {k: (v.value if isinstance(v, enum.Enum) else v)
            for k, v in dataclasses.asdict(jcfg).items()}


def _jax_case(name, **kw):
    jcfg = cd.GridConfig(**kw)
    n = jcfg.pdims[0] * jcfg.pdims[1]
    grid = cd.make_grid(jcfg, devices=jax.devices()[:n])
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    f = rng.standard_normal(jcfg.gdims)
    cf = f + 1j * rng.standard_normal(jcfg.gdims)
    shards = {}
    x = cd.scatter_global(grid, f, 0)
    shards["x"] = _shards(grid, x, 0)
    buf = x
    for op, axis in (("x_to_y", 1), ("y_to_z", 2), ("z_to_y", 1),
                     ("y_to_x", 0)):
        buf = getattr(cd, f"transpose_{op}")(grid, buf)
        shards[op] = _shards(grid, buf, axis)
    plan = JFFT(grid=grid)
    xh = plan.forward(cd.scatter_global(grid, cf, 0))
    shards["fft"] = _shards(grid, xh, 2)
    shards["ifft"] = _shards(grid, plan.inverse(xh), 0)
    rplan = JFFT(grid=grid, real=True)
    rh = rplan.forward(x)
    shards["rfft"] = _shards(rplan.complex_grid, rh, 2)
    shards["irfft"] = _shards(grid, rplan.inverse(rh), 0)
    return dict(name=name, config=_spec(jcfg), field=f,
                cfield=cf, shards=shards)


def _jax_grid(**kw):
    jcfg = cd.GridConfig(**kw)
    n = jcfg.pdims[0] * jcfg.pdims[1]
    return jcfg, cd.make_grid(jcfg, devices=jax.devices()[:n])


def _jax_halo_case(name, axis, he, periods, **kw):
    jcfg, grid = _jax_grid(**kw)
    f = np.random.default_rng(zlib.crc32(name.encode())).standard_normal(
        jcfg.gdims)
    buf = cd.scatter_global(grid, f, axis, halo_extents=he)
    out = cd.update_halos(grid, buf, axis, he, periods)
    local = jgeo.pencil_buffer_shape(jcfg, axis, he)
    shards = {}
    for shard in out.addressable_shards:
        coords = coords_of_shard_index(grid, axis, shard.index, local)
        shards[tuple(int(c) for c in coords)] = np.asarray(shard.data)
    return dict(name=name, kind="halo", config=_spec(jcfg), field=f,
                axis=axis, halo_extents=he, periods=periods,
                shards={"halo": shards})


def _jax_box7(ue):
    return (ue[:-2, 1:-1, 1:-1] + ue[2:, 1:-1, 1:-1] + ue[1:-1, :-2, 1:-1]
            + ue[1:-1, 2:, 1:-1] + ue[1:-1, 1:-1, :-2] + ue[1:-1, 1:-1, 2:]
            + ue[1:-1, 1:-1, 1:-1])


def _jax_stencil_case(name, periods, **kw):
    jcfg, grid = _jax_grid(**kw)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    f = rng.standard_normal(jcfg.gdims)
    c = rng.standard_normal(jcfg.gdims)
    w = rng.standard_normal((3, 3, 3))
    u = cd.scatter_global(grid, f, 0)
    cv = cd.scatter_global(grid, c, 0)
    grad = jax.grad(lambda v: jnp.sum(
        cd.stencil_apply(grid, v, w, 0, periods) * cv))(u)
    outs = {"stencil": cd.stencil_apply(grid, u, w, 0, periods),
            "lap": cd.laplacian7(grid, u, 0, periods),
            "diffusion": cd.diffusion_step(grid, u, 0.05, 0, periods),
            "box": cd.halo_map(grid, u, _jax_box7, 0, 1, periods),
            "grad": grad}
    return dict(name=name, kind="stencil", config=_spec(jcfg), field=f,
                cotangent=c, weights=w, periods=periods,
                shards={k: _shards(grid, v, 0) for k, v in outs.items()})


def _jax_cg_case(name, **kw):
    jcfg, grid = _jax_grid(**kw)
    f = np.random.default_rng(zlib.crc32(name.encode())).standard_normal(
        jcfg.gdims)
    u, iters, _ = JPoisson(grid=grid).solve_cg(
        cd.scatter_global(grid, f, 0), tol=1e-12, check_every=8)
    return dict(name=name, kind="cg", config=_spec(jcfg), field=f,
                tol=1e-12, check_every=8, iters=int(iters),
                shards={"u": _shards(grid, u, 0)})


def _jax_peer_case(name, axis, he, periods, **kw):
    """The kernel exchanges' path in the JAX package (which takes
    lax.all_to_all and the ppermute ring on the CPU mesh): the four
    transposes, the c2c FFT and a halo update."""
    jcfg, grid = _jax_grid(transpose_method=cd.TransposeMethod.PALLAS_A2A,
                           halo_method=cd.HaloMethod.PALLAS, **kw)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    f = rng.standard_normal(jcfg.gdims)
    cf = f + 1j * rng.standard_normal(jcfg.gdims)
    shards = {}
    buf = cd.scatter_global(grid, f, 0)
    for op, ax in (("x_to_y", 1), ("y_to_z", 2), ("z_to_y", 1),
                   ("y_to_x", 0)):
        buf = getattr(cd, f"transpose_{op}")(grid, buf)
        shards[op] = _shards(grid, buf, ax)
    plan = JFFT(grid=grid)
    xh = plan.forward(cd.scatter_global(grid, cf, 0))
    shards["fft"] = _shards(grid, xh, 2)
    shards["ifft"] = _shards(grid, plan.inverse(xh), 0)
    hb = cd.update_halos(grid, cd.scatter_global(grid, f, axis,
                                                 halo_extents=he),
                         axis, he, periods)
    local = jgeo.pencil_buffer_shape(jcfg, axis, he)
    shards["halo"] = {
        tuple(int(c) for c in coords_of_shard_index(grid, axis, s.index,
                                                    local)):
        np.asarray(s.data) for s in hb.addressable_shards}
    return dict(name=name, kind="peer", config=_spec(jcfg), field=f,
                cfield=cf, axis=axis, halo_extents=he, periods=periods,
                shards=shards)


def _jax_ring_case(name, method, he, pad, hosts=None, **kw):
    """The four transposes with a per-peer method in the JAX package, each
    op with halo extents ``he`` and padding ``pad`` in and out."""
    jcfg, grid = _jax_grid(transpose_method=method, **kw)
    f = np.random.default_rng(zlib.crc32(name.encode())).standard_normal(
        jcfg.gdims)
    opkw = dict(input_halo_extents=he, output_halo_extents=he,
                input_padding=pad, output_padding=pad)
    buf = cd.scatter_global(grid, f, 0, halo_extents=he, padding=pad)
    shards = {}
    for op, axis in (("x_to_y", 1), ("y_to_z", 2), ("z_to_y", 1),
                     ("y_to_x", 0)):
        buf = getattr(cd, f"transpose_{op}")(grid, buf, **opkw)
        local = jgeo.pencil_buffer_shape(jcfg, axis, he, pad)
        shards[op] = {tuple(int(c) for c in coords_of_shard_index(
            grid, axis, s.index, local)): np.asarray(s.data)
            for s in buf.addressable_shards}
    return dict(name=name, kind="ring", config=_spec(jcfg), field=f,
                halo_extents=he, padding=pad, hosts=hosts, shards=shards)


_RINGS = ("ring", "ring_xor", "ring_hier", "ring_pipelined")
# each method meets both sizes and both payloads over its process grids
_RING_SHAPES = (((16, 16, 16), None), ((66, 70, 74), ((1, 1, 2), (2, 0, 1))),
                ((66, 70, 74), None), ((16, 16, 16), ((2, 1, 1), (0, 3, 1))))


def _ring_cases(pdims_list, hosts):
    cases = []
    for m, method in enumerate(_RINGS):
        for d, pdims in enumerate(pdims_list):
            gdims, payload = _RING_SHAPES[(m + d) % 4]
            he, pad = payload or ((0, 0, 0), (0, 0, 0))
            cases.append(_jax_ring_case(
                f"{method}-{pdims[0]}x{pdims[1]}-{gdims[0]}", method, he,
                pad, hosts=hosts, gdims=gdims, pdims=pdims))
    return cases


def test_four_gloo_ranks_match_jax_shards(tmp_path):
    ac = dict(transpose_axis_contiguous=(True, True, True))
    cases = [
        _jax_case("even-2x2", gdims=(8, 8, 8), pdims=(2, 2)),
        _jax_case("uneven-2x2", gdims=(9, 10, 11), pdims=(2, 2)),
        _jax_case("even-1x4", gdims=(8, 8, 8), pdims=(1, 4)),
        _jax_case("uneven-1x4", gdims=(9, 10, 11), pdims=(1, 4)),
        _jax_case("even-4x1", gdims=(8, 8, 8), pdims=(4, 1)),
        _jax_case("uneven-4x1", gdims=(9, 10, 11), pdims=(4, 1)),
        _jax_case("uneven-2x2-ac", gdims=(9, 10, 11), pdims=(2, 2), **ac),
        _jax_case("colmajor-mem-order", gdims=(8, 12, 10), pdims=(2, 2),
                  rank_order=cd.RankOrder.COL_MAJOR,
                  transpose_mem_order=((2, 1, 0), (0, 2, 1), (1, 2, 0))),
        dict(name="empty-pencil", expect_error="empty pencil",
             config=_spec(cd.GridConfig(gdims=(2, 2, 8), pdims=(4, 1)))),
        # the halo engine: sharded exchanges, uneven splits, edges kept
        _jax_halo_case("halo-2x2", 0, (1, 2, 1), (True, False, True),
                       gdims=(8, 8, 8), pdims=(2, 2)),
        _jax_halo_case("halo-uneven-2x2", 1, (1, 1, 2), (False, True, True),
                       gdims=(9, 10, 11), pdims=(2, 2)),
        _jax_halo_case("halo-1x4-pallas", 2, (2, 2, 1), (True, True, False),
                       gdims=(9, 10, 11), pdims=(1, 4),
                       halo_method=cd.HaloMethod.PALLAS),
        _jax_halo_case("halo-uneven-1x4-ac", 0, (1, 1, 1), (True, True, True),
                       gdims=(9, 10, 11), pdims=(1, 4),
                       transpose_axis_contiguous=(True, True, True)),
        # the stencil path with sharded ghosts: periodic (sharded y and z
        # ghost planes serve the face taps) and Dirichlet (the dense taps
        # take the ghost-extended block: x with zero ghosts, y wrapping
        # locally, z sharded with zero edge ghosts)
        _jax_stencil_case("stencil-2x2", (True, True, True),
                          gdims=(8, 8, 12), pdims=(2, 2)),
        _jax_stencil_case("stencil-1x4-dirichlet", (False, True, False),
                          gdims=(8, 8, 12), pdims=(1, 4)),
        dict(name="stencil-uneven", kind="stencil", axis=1,
             expect_error="divisible",
             config=_spec(cd.GridConfig(gdims=(9, 8, 8), pdims=(2, 2)))),
        # the CG solve's dots summed over the ranks
        _jax_cg_case("cg-2x2", gdims=(8, 8, 8), pdims=(2, 2)),
        _jax_cg_case("cg-1x4", gdims=(8, 8, 8), pdims=(1, 4)),
        # the kernel exchanges' path (K2, K3; their plain versions on the
        # CPU), uneven, both rank orders, with K2's and K3's plans
        _jax_peer_case("peer-2x2-colmajor", 0, (1, 1, 1), (True, False, True),
                       gdims=(9, 10, 11), pdims=(2, 2),
                       rank_order=cd.RankOrder.COL_MAJOR),
        _jax_peer_case("peer-1x4", 1, (1, 2, 1), (False, True, True),
                       gdims=(9, 10, 11), pdims=(1, 4)),
        _jax_peer_case("peer-4x1", 2, (2, 1, 1), (True, True, False),
                       gdims=(9, 10, 11), pdims=(4, 1)),
    ]
    # the per-peer methods; two ranks per host, so that ring_hier runs its
    # two-tier schedule over the dims of 4 ranks
    cases += _ring_cases(((2, 2), (1, 4), (4, 1)), ("h0", "h0", "h1", "h1"))
    run_ranks(multirank_worker, 4, (4, str(tmp_path / "pg_init"), cases),
              300, "the 4-rank gloo run")


def test_three_gloo_ranks_rings_match_jax_shards(tmp_path):
    # P = 3: ring_xor takes the increment ring, the two-tier schedule
    # finds no even grouping of hosts (a, a, b) and runs flat
    cases = _ring_cases(((1, 3), (3, 1)), ("a", "a", "b"))
    run_ranks(multirank_worker, 3, (3, str(tmp_path / "pg_init"), cases),
              300, "the 3-rank gloo run")
