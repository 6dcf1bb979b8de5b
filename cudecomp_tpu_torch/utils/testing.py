"""Test oracles, and the worker of the multi-rank gloo test.

The reference initializes each pencil element to its *global linear index*
and checks outputs against analytically computed pencils
(``tests/ctest/transpose_tests.cc:333-378``).  :func:`global_index_field`
and :func:`check_shards_match_pencil` are that oracle for this rank's
local tensors.

:func:`multirank_worker` runs in each spawned rank of the multi-rank test:
it lives in the package so that spawned children can import it.
"""

from __future__ import annotations

import numpy as np
import torch

from cudecomp_tpu_torch import geometry


def global_index_field(gdims, dtype=torch.float64) -> torch.Tensor:
    """Global tensor whose value is its global linear index (x-major)."""
    n = int(np.prod(gdims))
    return torch.arange(n, dtype=dtype).reshape(tuple(gdims))


def check_shards_match_pencil(grid, local, axis, x_global, halo_extents=None,
                              padding=None):
    """Check this rank's local interior against PencilInfo directly
    (independent of scatter_global/gather_global); raises AssertionError."""
    cfg = grid.config
    order = cfg.mem_order(axis)
    halo = geometry._check_extents(halo_extents, "halo_extents")
    pad = geometry._check_extents(padding, "padding")
    pinfo = geometry.get_pencil_info(cfg, axis, grid.coords, halo, pad)
    lo_g, hi_g = pinfo.lo_g, pinfo.hi_g
    sl_buf, sl_src = [], [None] * 3
    for i in range(3):
        g = order[i]
        valid = hi_g[g] - lo_g[g] + 1
        sl_buf.append(slice(halo[g], halo[g] + valid))
        sl_src[g] = slice(lo_g[g], lo_g[g] + valid)
    expected = torch.as_tensor(x_global)[tuple(sl_src)].permute(order)
    got = local[tuple(sl_buf)].to(expected.device)
    if not torch.equal(got, expected):
        raise AssertionError(f"pencil {axis} at coords {grid.coords}: "
                             f"interior differs from the global field")


# -- multi-rank worker -----------------------------------------------------------

_TRANSPOSES = ("x_to_y", "y_to_z", "z_to_y", "y_to_x")


def _checker(case, grid, rank_world):
    """``check(name, got, atol)``: this rank's tensor against the expected
    shard ``case["shards"][name][coords]``, bit for bit when atol is 0."""
    coords = grid.coords
    want = case["shards"]  # name -> {coords: numpy local tensor}

    def check(name, got, atol=0.0):
        exp = torch.from_numpy(want[name][coords])
        if tuple(got.shape) != tuple(exp.shape):
            raise AssertionError(f"{case['name']} {name} rank {rank_world} "
                                 f"{coords}: shape {tuple(got.shape)} != "
                                 f"{tuple(exp.shape)}")
        if atol == 0.0:
            ok = torch.equal(got, exp)
        else:
            ok = bool(torch.allclose(got, exp, rtol=0, atol=atol))
        if not ok:
            err = float((got - exp).abs().max())
            raise AssertionError(f"{case['name']} {name} rank {rank_world} "
                                 f"{coords}: max abs diff {err}")

    return check


def _run_case(case, rank_world):
    """Check one case on this rank: 4 transposes bit-equal, FFT to atol."""
    import cudecomp_tpu_torch as ct
    from cudecomp_tpu_torch.ops.fft import DistributedFFT

    cfg = ct.GridConfig.from_dict(case["config"])
    grid = ct.make_grid(cfg, "cpu")
    check = _checker(case, grid, rank_world)

    x_global = torch.from_numpy(case["field"])
    buf = ct.scatter_global(grid, x_global, 0)
    check("x", buf)
    check_shards_match_pencil(grid, buf, 0, x_global)
    for name in _TRANSPOSES:
        buf = getattr(ct, f"transpose_{name}")(grid, buf)
        check(name, buf)
    back = ct.gather_global(grid, buf, 0)
    if not torch.equal(back, x_global):
        raise AssertionError(f"{case['name']}: gathered round trip differs")

    cplx = torch.from_numpy(case["cfield"])
    plan = DistributedFFT(grid=grid)
    xh = plan.forward(ct.scatter_global(grid, cplx, 0))
    check("fft", xh, atol=1e-10)
    check("ifft", plan.inverse(xh), atol=1e-10)
    rplan = DistributedFFT(grid=grid, real=True)
    rh = rplan.forward(buf)
    check("rfft", rh, atol=1e-10)
    check("irfft", rplan.inverse(rh), atol=1e-10)


def _run_halo_case(case, rank_world):
    """update_halos in place, bit-equal to the JAX buffer."""
    import cudecomp_tpu_torch as ct
    grid = ct.make_grid(ct.GridConfig.from_dict(case["config"]), "cpu")
    check = _checker(case, grid, rank_world)
    axis, he, periods = case["axis"], case["halo_extents"], case["periods"]
    buf = ct.scatter_global(grid, torch.from_numpy(case["field"]), axis,
                            halo_extents=he)
    out = ct.update_halos(grid, buf, axis, he, periods)
    if out is not buf:
        raise AssertionError(f"{case['name']}: update_halos returned a new "
                             f"tensor")
    check("halo", out)


def _run_stencil_case(case, rank_world):
    """The ghost-plane path with sharded ghosts, to 1e-12 of JAX."""
    import cudecomp_tpu_torch as ct
    grid = ct.make_grid(ct.GridConfig.from_dict(case["config"]), "cpu")
    check = _checker(case, grid, rank_world)
    periods, w = case["periods"], case["weights"]
    u = ct.scatter_global(grid, torch.from_numpy(case["field"]), 0)
    c = ct.scatter_global(grid, torch.from_numpy(case["cotangent"]), 0)
    check("stencil", ct.stencil_apply(grid, u, w, 0, periods), 1e-12)
    check("lap", ct.laplacian7(grid, u, 0, periods), 1e-12)
    check("diffusion", ct.diffusion_step(grid, u, 0.05, 0, periods), 1e-12)
    check("box", ct.halo_map(grid, u, _box7, 0, 1, periods), 1e-12)
    x = u.clone().requires_grad_(True)
    (g,) = torch.autograd.grad((ct.stencil_apply(grid, x, w, 0, periods)
                                * c).sum(), x)
    check("grad", g, 1e-12)


def _box7(ue):
    """Sum of the 7-point neighbourhood of each interior cell."""
    return (ue[:-2, 1:-1, 1:-1] + ue[2:, 1:-1, 1:-1] + ue[1:-1, :-2, 1:-1]
            + ue[1:-1, 2:, 1:-1] + ue[1:-1, 1:-1, :-2] + ue[1:-1, 1:-1, 2:]
            + ue[1:-1, 1:-1, 1:-1])


def _run_cg_case(case, rank_world):
    """solve_cg: the iteration count of JAX, the solution to 1e-9."""
    import cudecomp_tpu_torch as ct
    grid = ct.make_grid(ct.GridConfig.from_dict(case["config"]), "cpu")
    check = _checker(case, grid, rank_world)
    f = ct.scatter_global(grid, torch.from_numpy(case["field"]), 0)
    u, iters, _ = ct.models.PoissonSolver(grid=grid).solve_cg(
        f, tol=case["tol"], check_every=case["check_every"])
    if iters != case["iters"]:
        raise AssertionError(f"{case['name']}: {iters} iterations, JAX "
                             f"took {case['iters']}")
    check("u", u, 1e-9)


def _run_spectral_case(case, rank_world):
    """The spectral path on sharded state, to 1e-10 of JAX: the spectral
    Poisson solve, one Taylor-Green step and its shell spectrum (summed
    over the ranks); the stepped state is then saved as a checkpoint into
    ``case["ckpt"]`` for the parent to load."""
    import cudecomp_tpu_torch as ct
    from cudecomp_tpu_torch.utils import checkpoint
    grid = ct.make_grid(ct.GridConfig.from_dict(case["config"]), "cpu")
    check = _checker(case, grid, rank_world)
    f = ct.scatter_global(grid, torch.from_numpy(case["field"]), 0)
    check("poisson", ct.models.PoissonSolver(grid=grid).solve(f), 1e-10)
    tg = ct.models.TaylorGreenSolver(grid=grid, nu=case["nu"])
    uh, fields = tg.setup()
    uh = tg.step(uh, fields, case["dt"])
    check("tg", uh, 1e-10)
    spec = tg.spectrum(uh, fields)
    want = torch.from_numpy(case["spectrum"])
    if spec.shape != want.shape or not torch.allclose(spec, want, rtol=0,
                                                      atol=1e-12):
        raise AssertionError(f"{case['name']} spectrum rank {rank_world}: "
                             f"differs from JAX's")
    checkpoint.save_pencil(case["ckpt"], fields["plan"].complex_grid, uh, 2)


_KINDS = {"transpose": _run_case, "halo": _run_halo_case,
          "stencil": _run_stencil_case, "cg": _run_cg_case,
          "spectral": _run_spectral_case}


def _expect_error(case):
    """The case's op must raise ValueError with the case's text."""
    import cudecomp_tpu_torch as ct
    cfg = ct.GridConfig.from_dict(case["config"])
    grid = ct.make_grid(cfg, "cpu")
    try:
        if case.get("kind") == "stencil":
            axis = case["axis"]
            ct.laplacian7(grid, torch.zeros(grid.buffer_shape(axis)), axis)
        else:
            ct.transpose_x_to_y(grid, torch.zeros(grid.buffer_shape(0)))
    except ValueError as e:
        if case["expect_error"] not in str(e):
            raise
    else:
        raise AssertionError(f"{case['name']}: no ValueError")


def multirank_worker(rank: int, world: int, init_file: str, cases) -> None:
    """One rank of the multi-rank test: gloo process group, then every case.

    ``cases``: dicts with ``name``, ``config`` (a GridConfig field dict),
    ``shards`` (op name -> {(pr, pc): expected local tensor as numpy}) and
    a ``kind``: ``transpose`` (the default: the four transposes and the
    FFTs of ``field`` and ``cfield``), ``halo`` (``update_halos`` of
    ``field`` with ``axis``, ``halo_extents`` and ``periods``), ``stencil``
    (the ghost-plane path of ``field`` with ``weights`` and ``periods``,
    and the gradient against ``cotangent``), ``cg`` (``solve_cg`` of
    ``field`` with ``tol`` and ``check_every``, taking ``iters``
    iterations) or ``spectral`` (the spectral Poisson solve of ``field``,
    a Taylor-Green step of ``dt`` at viscosity ``nu`` with its
    ``spectrum``, and a checkpoint of the state into ``ckpt``).  A case
    with ``expect_error`` instead checks that its op
    (the X->Y transpose, or ``laplacian7`` on pencil ``axis`` for a stencil
    case) raises ValueError with that text.
    """
    import torch.distributed as dist

    import cudecomp_tpu_torch as ct

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        for case in cases:
            if "expect_error" in case:
                _expect_error(case)
            else:
                _KINDS[case.get("kind", "transpose")](case, rank)
        dist.barrier()
    finally:
        ct.clear_plan_caches()
        dist.destroy_process_group()
