"""Test oracles, and the worker of the multi-rank gloo test.

The reference initializes each pencil element to its *global linear index*
and checks outputs against analytically computed pencils
(``tests/ctest/transpose_tests.cc:333-378``).  :func:`global_index_field`
and :func:`check_shards_match_pencil` are that oracle for this rank's
local tensors.

:func:`expected_halo_buffer` is the halo oracle: this rank's buffer after
``update_halos``, built from the global field by index.

:func:`multirank_worker` runs in each spawned rank of the multi-rank test:
it lives in the package so that spawned children can import it.
:func:`run_ranks` spawns ranks and joins them with a deadline.
"""

from __future__ import annotations

import dataclasses
import os
import time

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


def expected_halo_buffer(grid, x_global, axis, halo_extents, periods):
    """This rank's buffer after ``update_halos`` of every dim with a halo,
    built from the global field ``x_global`` by index: a halo cell holds
    the global cell it wraps to on a periodic dim and keeps its old value,
    0 after ``scatter_global``, across a non-periodic edge; the padding
    between a rank's valid extent and the max split is 0.  On the global
    field's device and dtype."""
    cfg = grid.config
    order = cfg.mem_order(axis)
    halo = geometry._check_extents(halo_extents, "halo_extents")
    pinfo = geometry.get_pencil_info(cfg, axis, grid.coords, halo)
    shape = geometry.pencil_buffer_shape(cfg, axis, halo)
    ms = geometry.max_splits(cfg, axis)
    dev = x_global.device
    out = x_global.permute(tuple(order) + tuple(range(3, x_global.dim())))
    mask = torch.ones((), dtype=torch.bool, device=dev)
    for i in range(3):
        g = order[i]
        n, h, m, lo = cfg.gdims[g], halo[g], ms[g], pinfo.lo_g[g]
        v = pinfo.hi_g[g] - lo + 1
        loc = torch.arange(shape[i], device=dev)
        gi = torch.where(loc < h + m, lo - h + loc, lo + v + loc - h - m)
        ok = (loc < h + v) | (loc >= h + m)
        if periods[g]:
            gi = gi % n
        else:
            ok &= (gi >= 0) & (gi < n)
        out = out.index_select(i, gi.clamp(0, n - 1))
        mask = mask & ok.reshape((-1,) + (1,) * (2 - i))
    mask = mask.reshape(mask.shape + (1,) * (out.dim() - 3))
    return torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                              device=dev))


def run_ranks(fn, world: int, args, timeout: float, what: str) -> None:
    """Spawn ``world`` processes running ``fn(rank, *args)`` and join them;
    a rank that raises raises here, and a run past ``timeout`` seconds is
    killed and raises."""
    ctx = torch.multiprocessing.start_processes(
        fn, args=args, nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            for p in ctx.processes:
                p.join(10)
            raise RuntimeError(f"{what} did not finish in {timeout:g} s")
    codes = [p.exitcode for p in ctx.processes]
    if any(codes):
        raise RuntimeError(f"{what}: exit codes {codes}")


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


def _run_peer_case(case, rank_world):
    """The kernel exchanges' path (``PALLAS_A2A`` transposes and the c2c FFT,
    a ``HaloMethod.PALLAS`` update) against the JAX shards; the group rank
    of every sharded mesh dim equal to the mesh coordinate along it; and
    K2's and K3's plans, run by the plain executor on every rank's data,
    equal to what the exchange over the group returns (on the CPU, the
    ``all_to_all`` and the ``ppermute`` ring)."""
    import torch.distributed as dist

    import cudecomp_tpu_torch as ct
    from cudecomp_tpu_torch.ops import halo
    from cudecomp_tpu_torch.ops import peer_kernels as PK
    from cudecomp_tpu_torch.ops.fft import DistributedFFT
    from cudecomp_tpu_torch.parallel import collectives
    grid = ct.make_grid(ct.GridConfig.from_dict(case["config"]), "cpu")
    check = _checker(case, grid, rank_world)
    cfg = grid.config
    for pd, name in enumerate(grid.axis_names):
        if cfg.pdims[pd] > 1 and dist.get_rank(grid.group(name)) != \
                grid.coords[pd]:
            raise AssertionError(f"{case['name']}: group rank of {name} is "
                                 f"not the mesh coordinate {grid.coords}")
    x_global = torch.from_numpy(case["field"])
    buf = ct.scatter_global(grid, x_global, 0)
    for name in _TRANSPOSES:
        buf = getattr(ct, f"transpose_{name}")(grid, buf)
        check(name, buf)
    plan = DistributedFFT(grid=grid)
    xh = plan.forward(ct.scatter_global(grid, torch.from_numpy(
        case["cfield"]), 0))
    check("fft", xh, atol=1e-10)
    check("ifft", plan.inverse(xh), atol=1e-10)
    axis, he, periods = case["axis"], case["halo_extents"], case["periods"]
    hb = ct.scatter_global(grid, x_global, axis, halo_extents=he)
    ct.update_halos(grid, hb, axis, he, periods)
    check("halo", hb)
    want = expected_halo_buffer(grid, x_global, axis, he, periods)
    if not torch.equal(hb, want):
        raise AssertionError(f"{case['name']}: expected_halo_buffer differs "
                             f"from the JAX shard")

    gen = torch.Generator().manual_seed(rank_world)
    for pd, name in enumerate(grid.axis_names):
        P = cfg.pdims[pd]
        if P == 1:
            continue
        group = grid.group(name)
        me = dist.get_rank(group)
        blocks = torch.randn((3 * P, 5), generator=gen, dtype=torch.float64)
        every = [torch.empty_like(blocks) for _ in range(P)]
        dist.all_gather(every, blocks, group=group)
        plans = [PK.a2a_plan(P, r, 3 * 5 * 8) for r in range(P)]
        outs = PK.apply_plans(plans, every, [torch.empty_like(b)
                                            for b in every])
        if not torch.equal(collectives.exchange_pallas_a2a(blocks, group, P,
                                                           3), outs[me]):
            raise AssertionError(f"{case['name']}: K2's plan differs from "
                                 f"all_to_all over {name}")
        splits = tuple(P + 1 - r % 2 for r in range(P))  # uneven: 5, 4, ...
        m, h = max(splits), 2
        slab = torch.randn((3, 2 * h + m, 4), generator=gen,
                           dtype=torch.float64)
        every = [torch.empty_like(slab) for _ in range(P)]
        dist.all_gather(every, slab, group=group)
        for periodic in (True, False):
            plans = [PK.halo_plan(slab.shape, 8, 1, h, m, splits, r, periodic)
                     for r in range(P)]
            mine = [b.clone() for b in every]
            outs = PK.apply_plans(plans, mine, mine)
            got = slab.clone()
            halo.halo_ring(got, group, 1, h, m, splits, periodic)
            if not torch.equal(got, outs[me]):
                raise AssertionError(f"{case['name']}: K3's plan differs "
                                     f"from the ring over {name} "
                                     f"(periodic={periodic})")


def _run_ring_case(case, rank_world):
    """The four transposes with a per-peer method (``ring``, ``ring_xor``,
    ``ring_hier``, ``ring_pipelined``), each op with the case's halo
    extents and padding in and out, bit-equal to the JAX shards; and the
    block contract of every ring exchange over each sharded mesh dim,
    equal to ``exchange_all_to_all``.  ``hosts`` (a host name per world
    rank), when given, stands in for the mesh's hosts, so that
    ``ring_hier`` takes its two-tier schedule."""
    import torch.distributed as dist

    import cudecomp_tpu_torch as ct
    from cudecomp_tpu_torch.parallel import collectives as C
    from cudecomp_tpu_torch.parallel import mesh as M
    grid = ct.make_grid(ct.GridConfig.from_dict(case["config"]), "cpu")
    if case.get("hosts"):
        grid = dataclasses.replace(grid, hosts=tuple(case["hosts"]))
    check = _checker(case, grid, rank_world)
    he, pad = case["halo_extents"], case["padding"]
    kw = dict(input_halo_extents=he, output_halo_extents=he,
              input_padding=pad, output_padding=pad)
    x_global = torch.from_numpy(case["field"])
    buf = ct.scatter_global(grid, x_global, 0, halo_extents=he, padding=pad)
    for name in _TRANSPOSES:
        buf = getattr(ct, f"transpose_{name}")(grid, buf, **kw)
        check(name, buf)
    back = ct.gather_global(grid, buf, 0, halo_extents=he, padding=pad)
    if not torch.equal(back, x_global):
        raise AssertionError(f"{case['name']}: gathered round trip differs")

    gen = torch.Generator().manual_seed(rank_world)
    for pd, name in enumerate(grid.axis_names):
        P = grid.pdims[pd]
        if P == 1:
            continue
        group = grid.group(name)
        npg = M.axis_group_size(grid.mesh, name, grid.hosts)
        for dtype in (torch.float64, torch.complex64):
            blocks = torch.randn((3 * P, 2, 5), generator=gen, dtype=dtype)
            want = C.exchange_all_to_all(blocks, group, P, 3)
            for what, got in (
                    ("ring", C.exchange_ring(blocks, group, P, 3)),
                    ("ring_xor", C.exchange_ring_xor(blocks, group, P, 3)),
                    (f"ring_hier/{npg}", C.exchange_ring_hier(
                        blocks, group, P, 3, npergroup=npg)),
                    ("ring_hier/2", C.exchange_ring_hier(
                        blocks, group, P, 3, npergroup=2))):
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"{case['name']}: {what} over {name} (P = {P}) "
                        f"breaks the block contract on rank {rank_world}")
    dist.barrier()


def _shard(case, name, grid) -> torch.Tensor:
    """This rank's tensor of ``case["shards"][name]``, writable."""
    return torch.from_numpy(np.array(case["shards"][name][grid.coords]))


def _grad_of(fn, x: torch.Tensor, ct) -> torch.Tensor:
    """The gradient at ``x`` of ``<ct, fn(x)>``, the real inner product
    summed over each output (a tensor, or a tuple paired with a tuple of
    cotangents); complex parts pair re with re and im with im."""
    x = x.clone().requires_grad_(True)
    outs, cts = fn(x), ct
    if not isinstance(outs, tuple):
        outs, cts = (outs,), (ct,)
    loss = sum((torch.view_as_real(o) * torch.view_as_real(c)).sum()
               if o.is_complex() else (o * c).sum()
               for o, c in zip(outs, cts))
    (g,) = torch.autograd.grad(loss, x)
    return g


def _grid_of(case):
    import cudecomp_tpu_torch as ct
    grid = ct.make_grid(ct.GridConfig.from_dict(case["config"]), "cpu")
    if case.get("hosts"):
        grid = dataclasses.replace(grid, hosts=tuple(case["hosts"]))
    return grid


def _run_grad_transpose_case(case, rank_world):
    """The gradient of each of the four transposes (the case's method,
    halo extents and padding in and out) at the shard ``in_<op>`` against
    the cotangent ``ct_<op>``, bit-equal to JAX's ``grad_<op>``."""
    import cudecomp_tpu_torch as ct
    grid = _grid_of(case)
    check = _checker(case, grid, rank_world)
    he, pad = case["halo_extents"], case["padding"]
    kw = dict(input_halo_extents=he, output_halo_extents=he,
              input_padding=pad, output_padding=pad)
    for name in _TRANSPOSES:
        op = getattr(ct, f"transpose_{name}")
        check(f"grad_{name}", _grad_of(lambda v: op(grid, v, **kw),
                                       _shard(case, f"in_{name}", grid),
                                       _shard(case, f"ct_{name}", grid)))


def _run_grad_halo_case(case, rank_world):
    """The gradient of ``update_halos`` (on a clone: it writes in place)
    bit-equal to JAX's, and the adjoint of ``sum(out)``: the set of
    gradient values over every rank equals ``adjoint_values``."""
    import torch.distributed as dist

    import cudecomp_tpu_torch as ct
    grid = _grid_of(case)
    check = _checker(case, grid, rank_world)
    axis, he, periods = case["axis"], case["halo_extents"], case["periods"]

    def run(v):
        return ct.update_halos(grid, v.clone(), axis, he, periods)

    x = _shard(case, "in", grid)
    check("grad", _grad_of(run, x, _shard(case, "ct", grid)))
    g = _grad_of(run, x, torch.ones_like(x))
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, sorted(set(g.flatten().tolist())))
    values = sorted(set().union(*seen))
    if values != list(case["adjoint_values"]):
        raise AssertionError(f"{case['name']}: the adjoint of sum(out) "
                             f"takes the values {values}, not "
                             f"{case['adjoint_values']}")


def _run_grad_fft_case(case, rank_world):
    """The gradients of the c2c and r2c FFTs, both directions, and of the
    c2c plane forms, to 1e-10 of JAX's (conjugated where the input is
    complex: torch's convention); then two independent exchanges in one
    graph, whose backward must finish with the gradient of a sum."""
    import cudecomp_tpu_torch as ct
    from cudecomp_tpu_torch.ops.fft import DistributedFFT
    grid = _grid_of(case)
    check = _checker(case, grid, rank_world)
    plan = DistributedFFT(grid=grid)
    rplan = DistributedFFT(grid=grid, real=True)
    pplan = DistributedFFT(grid=grid, split_complex=True)
    cgrid = rplan.complex_grid

    def local(name, g=grid):
        return _shard(case, name, g)

    check("c_grad", _grad_of(plan.forward, local("c_in"), local("c_ct")),
          1e-10)
    check("ci_grad", _grad_of(plan.inverse, local("ci_in"), local("ci_ct")),
          1e-10)
    check("r_grad", _grad_of(rplan.forward, local("r_in"), local("r_ct")),
          1e-10)
    check("ri_grad", _grad_of(rplan.inverse, local("ri_in", cgrid),
                              local("ri_ct")), 1e-10)
    pr, pi = local("p_in_r"), local("p_in_i")
    cts = (local("p_ct_r"), local("p_ct_i"))
    check("p_grad_r", _grad_of(lambda v: pplan.forward_planes((v, pi)), pr,
                               cts), 1e-10)
    check("p_grad_i", _grad_of(lambda v: pplan.forward_planes((pr, v)), pi,
                               cts), 1e-10)
    zi = local("pi_in_i")
    check("pi_grad_r", _grad_of(lambda v: pplan.inverse_planes((v, zi)),
                                local("pi_in_r"),
                                (local("pi_ct_r"), local("pi_ct_i"))), 1e-10)

    # two independent exchanges in one graph: a transpose and a
    # non-periodic halo update, whose edge ranks drop a shift's result
    he = (1, 1, 1)
    a = torch.randn(grid.buffer_shape(0), dtype=torch.float64,
                    requires_grad=True)
    b = torch.randn(grid.buffer_shape(0, he), dtype=torch.float64,
                    requires_grad=True)
    loss = (ct.transpose_x_to_y(grid, a).sum()
            + ct.update_halos(grid, b.clone(), 0, he,
                              (False, False, False)).sum())
    loss.backward()
    from cudecomp_tpu_torch.utils.arrays import valid_interior_mask
    inside = valid_interior_mask(grid, 0)
    if not bool((a.grad[inside] == 1).all()):
        raise AssertionError(f"{case['name']}: the transpose's gradient of a "
                             f"sum is not one on the interior")


def compat_queries(cc, handle, grid, he=(1, 1, 1)) -> dict:
    """What the ``compat`` module (``cc``, the JAX package's or the port's)
    answers about ``grid``: the config struct, the transpose and halo
    workspace sizes, the data-type sizes and every shifted rank."""
    rt = cc.cudecompGetGridDescConfig(handle, grid)
    cfg = {k: (tuple(tuple(r) for r in v) if k == "transpose_mem_order"
               else tuple(v) if isinstance(v, (tuple, list)) else v)
           for k, v in dataclasses.asdict(rt).items()}
    n = grid.config.pdims[0] * grid.config.pdims[1]
    shifted = [cc.cudecompGetShiftedRank(handle, grid, axis, dim, disp,
                                         periodic, rank=r)
               for axis in range(3) for dim in range(3)
               for disp in (-2, -1, 1, 2, 5) for periodic in (True, False)
               for r in range(n)]
    return dict(config=cfg, shifted=shifted,
                transpose_ws=[cc.cudecompGetTransposeWorkspaceSize(
                    handle, grid, eb) for eb in (4, 8, 16)],
                halo_ws=[cc.cudecompGetHaloWorkspaceSize(handle, grid, a, he,
                                                         eb)
                         for a in range(3) for eb in (4, 8)],
                type_sizes=[cc.cudecompGetDataTypeSize(t) for t in (
                    cc.CUDECOMP_FLOAT, cc.CUDECOMP_DOUBLE,
                    cc.CUDECOMP_FLOAT_COMPLEX, cc.CUDECOMP_DOUBLE_COMPLEX)])


def _run_compat_case(case, rank_world):
    """The cases of ``tests/test_compat.py`` through ``compat`` on a (2, 2)
    grid: the basic-usage flow (four transposes and a periodic width-1
    halo update) bit-equal to JAX compat's shards, the queries equal to
    JAX's (:func:`compat_queries`), the backend enums' mapping, and the
    autotuned config copied back into the caller's struct."""
    from cudecomp_tpu_torch import compat as cc
    from cudecomp_tpu_torch.config import HaloMethod, TransposeMethod
    import cudecomp_tpu_torch as ct
    handle = cc.cudecompInit(device="cpu")
    config = cc.cudecompGridDescConfigSetDefaults()
    config.gdims = tuple(case["gdims"])
    config.pdims = (2, 2)
    config.transpose_comm_backend = cc.CUDECOMP_TRANSPOSE_COMM_MPI_A2A
    grid = cc.cudecompGridDescCreate(handle, config)
    _ok(grid.config.transpose_method == TransposeMethod.ALL_TO_ALL)
    check = _checker(case, grid, rank_world)
    pinfo = cc.cudecompGetPencilInfo(handle, grid, 0)
    _ok(pinfo.size == int(np.prod(pinfo.shape)), "pencil size")
    f = torch.from_numpy(case["field"])
    x = ct.scatter_global(grid, f, 0)
    y = cc.cudecompTransposeXToY(handle, grid, x)
    z = cc.cudecompTransposeYToZ(handle, grid, y)
    y2 = cc.cudecompTransposeZToY(handle, grid, z)
    x2 = cc.cudecompTransposeYToX(handle, grid, y2)
    for name, got in (("y", y), ("z", z), ("y2", y2), ("x2", x2)):
        check(name, got)
    _ok(torch.equal(ct.gather_global(grid, x2, 0), f), "round trip")
    he = (1, 1, 1)
    h = ct.scatter_global(grid, f, 0, halo_extents=he)
    h2 = cc.cudecompUpdateHalosX(handle, grid, h, halo_extents=he,
                                 halo_periods=(True, True, True))
    _ok(h2 is h, "the halo entry returns its updated input")
    check("halo", h2)
    got = compat_queries(cc, handle, grid)
    _ok(got == case["queries"], f"queries {got} != {case['queries']}")
    _ok(cc.cudecompGetShiftedRank(handle, grid, 0, 1, 1, True)
        == grid.shifted_rank(0, 1, 1, True, rank_world), "default rank")
    _ok(cc.cudecompMalloc(handle, grid, 1024) is None)
    _ok(cc.cudecompFree(handle, grid, None) is None)
    cc.cudecompGridDescDestroy(handle, grid)

    for be, m in ((cc.CUDECOMP_TRANSPOSE_COMM_MPI_P2P, TransposeMethod.RING),
                  (cc.CUDECOMP_TRANSPOSE_COMM_MPI_P2P_PL,
                   TransposeMethod.RING_PIPELINED),
                  (cc.CUDECOMP_TRANSPOSE_COMM_NCCL, TransposeMethod.RING_XOR),
                  (cc.CUDECOMP_TRANSPOSE_COMM_NVSHMEM,
                   TransposeMethod.PALLAS_A2A)):
        config = cc.cudecompGridDescConfigSetDefaults()
        config.gdims, config.pdims = (8, 8, 8), (2, 2)
        config.transpose_comm_backend = be
        _ok(cc.cudecompGridDescCreate(handle, config).config.transpose_method
            == m, f"backend {be}")
    config = cc.cudecompGridDescConfigSetDefaults()
    config.gdims, config.pdims = (8, 8, 8), (2, 2)
    config.halo_comm_backend = cc.CUDECOMP_HALO_COMM_NVSHMEM
    _ok(cc.cudecompGridDescCreate(handle, config).config.halo_method
        == HaloMethod.PALLAS, "halo backend")

    # the autotuned config is copied back (src/cudecomp.cc:1248-1265)
    config = cc.cudecompGridDescConfigSetDefaults()
    config.gdims, config.pdims = (16, 16, 16), (0, 0)
    options = cc.cudecompGridDescAutotuneOptionsSetDefaults()
    options.n_warmup_trials, options.n_trials = 0, 1
    options.autotune_transpose_backend = True
    options.disable_nccl_backends = True
    options.disable_nvshmem_backends = True
    grid = cc.cudecompGridDescCreate(handle, config, options)
    _ok(tuple(config.pdims) == tuple(grid.pdims), "pdims copied back")
    _ok(config.transpose_comm_backend in (
        cc.CUDECOMP_TRANSPOSE_COMM_MPI_P2P,
        cc.CUDECOMP_TRANSPOSE_COMM_MPI_P2P_PL,
        cc.CUDECOMP_TRANSPOSE_COMM_MPI_A2A), "backend copied back")
    _same_on_every_rank((tuple(config.pdims), config.transpose_comm_backend),
                        "the autotuned config")
    cc.cudecompFinalize(handle)


_KINDS = {"transpose": _run_case, "ring": _run_ring_case,
          "halo": _run_halo_case,
          "stencil": _run_stencil_case, "cg": _run_cg_case,
          "spectral": _run_spectral_case, "peer": _run_peer_case,
          "grad_transpose": _run_grad_transpose_case,
          "grad_halo": _run_grad_halo_case, "grad_fft": _run_grad_fft_case,
          "compat": _run_compat_case}


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
    ``spectrum``, and a checkpoint of the state into ``ckpt``) or ``peer``
    (the kernel exchanges' path on a config with ``PALLAS_A2A`` and
    ``HaloMethod.PALLAS``: the four transposes and the c2c FFT of
    ``field``/``cfield``, the halo update of ``field`` with ``axis``,
    ``halo_extents`` and ``periods``, and K2's and K3's plans) or ``ring``
    (the four transposes of ``field`` with a per-peer method, each with
    ``halo_extents`` and ``padding`` in and out, and the rings' block
    contract; ``hosts`` may stand in for the mesh's hosts) or
    ``grad_transpose``, ``grad_halo``, ``grad_fft`` (gradients against
    JAX's) or ``compat`` (the ``cudecomp*`` flow): see those functions.
    A case
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


# -- the kernel exchanges on ranks that share a card ---------------------------

def check_peer_kernels(device, gdims=(66, 70, 74), seed=0) -> dict:
    """In one rank of a gloo world whose W ranks share ``device``: K2 and K3
    on a small uneven grid at pdims (1, W) and (W, 1), each result bit-equal
    to its plain version run on CPU copies over gloo groups of the same
    ranks:

      * K2 called directly over each sharded mesh dim, twice in a row with
        different data (the two halves of its receive region make reusing
        the workspace safe);
      * the four ``PALLAS_A2A`` transposes of a seeded field;
      * ``HaloMethod.PALLAS`` updates of the x-pencil, widths 1 and 2,
        periodic and not, also held to :func:`expected_halo_buffer`.

    Raises AssertionError on a difference; returns the K2 and K3 launches
    it made."""
    import torch.distributed as dist

    import cudecomp_tpu_torch as ct
    from cudecomp_tpu_torch.ops import peer_kernels as PK
    from cudecomp_tpu_torch.parallel import collectives

    W = dist.get_world_size()
    rank = dist.get_rank()
    a2a0, halo0 = PK.a2a_launch_count, PK.halo_launch_count
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(tuple(gdims), generator=gen, dtype=torch.float64)
    mine = torch.Generator().manual_seed(seed * 1000 + rank + 1)

    def same(got, want, what):
        if got.shape != want.shape or not torch.equal(got.cpu(), want):
            raise AssertionError(f"{what} differs from its plain version on "
                                 f"rank {rank}")

    for pdims in ((1, W), (W, 1)):
        cfg = ct.GridConfig(gdims=tuple(gdims), pdims=pdims,
                            transpose_method=ct.TransposeMethod.PALLAS_A2A,
                            halo_method=ct.HaloMethod.PALLAS)
        gpu, cpu = ct.make_grid(cfg, device), ct.make_grid(cfg, "cpu")
        for pd, name in enumerate(gpu.axis_names):
            P = pdims[pd]
            if P == 1:
                continue
            for k in range(2):
                blocks = torch.randn((3 * P, 7, 5), generator=mine,
                                     dtype=torch.float32)
                same(PK.a2a(blocks.to(device), gpu.group(name)),
                     collectives.exchange_all_to_all(blocks, cpu.group(name),
                                                     P, 3),
                     f"K2 over {name} at pdims {pdims} (exchange {k})")
        g, c = ct.scatter_global(gpu, x.to(device), 0), ct.scatter_global(
            cpu, x, 0)
        for op in _TRANSPOSES:
            g = getattr(ct, f"transpose_{op}")(gpu, g)
            c = getattr(ct, f"transpose_{op}")(cpu, c)
            same(g, c, f"PALLAS_A2A transpose {op} at pdims {pdims}")
        for w in (1, 2):
            he = (w, w, w)
            for periods in ((True, True, True), (False, True, False)):
                g = ct.scatter_global(gpu, x.to(device), 0, halo_extents=he)
                c = ct.scatter_global(cpu, x, 0, halo_extents=he)
                ct.update_halos(gpu, g, 0, he, periods)
                ct.update_halos(cpu, c, 0, he, periods)
                what = f"halo update {he} {periods} at pdims {pdims}"
                same(g, c, what)
                same(g, expected_halo_buffer(cpu, x, 0, he, periods), what)
    return {"K2": PK.a2a_launch_count - a2a0,
            "K3": PK.halo_launch_count - halo0}


def check_workspace_growth(device, seed=0) -> None:
    """In one rank of a gloo world whose W ranks share ``device``: K2 over
    the world on small blocks, then on blocks whose W-1 receive slots
    exceed the first workspace, each bit-equal to ``exchange_all_to_all``
    of CPU copies.  The second exchange grows the world's workspace: a new
    one with the larger receive region, its exchange count started at 0
    and only the second plan's launch record in it; the old one is
    released.  Each exchange is two kernels and 2 (W - 1) stream memory
    operations, as the C entry reports them, and after it every other
    rank's signal is in this rank's pad.  Raises AssertionError on a
    difference."""
    import torch.distributed as dist

    from cudecomp_tpu_torch.ops import peer_kernels as PK
    from cudecomp_tpu_torch.parallel import collectives, symmetric

    W, rank = dist.get_world_size(), dist.get_rank()
    if W < 2:
        raise ValueError("a workspace grows over two ranks or more")
    gen = torch.Generator().manual_seed(seed * 1000 + rank + 1)
    seen, cuda0, memops0 = [], PK.a2a_cuda_launch_count, PK.a2a_memop_count
    for cols in (64, symmetric.GROW_ALIGN // 4 // (W - 1) + 1):
        blocks = torch.randn((W, cols), generator=gen, dtype=torch.float32)
        got = PK.a2a(blocks.to(device), None)
        want = collectives.exchange_all_to_all(blocks, None, W, 1)
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"K2 over the world of {cols} columns "
                                 f"differs from its plain version on rank "
                                 f"{rank}")
        seen.append((symmetric.workspace(None, got.device, 0), 4 * cols))
    (small, bb_small), (grown, bb) = seen
    halves = PK.HALVES * (W - 1)
    need = -(-halves * bb // symmetric.GROW_ALIGN) * symmetric.GROW_ALIGN
    pad = grown.signals()
    facts = {
        "a new workspace": grown is not small,
        "the old one released": small.bases_dev is None
        and not small.launches,
        "the first one too small for the second exchange":
            halves * bb_small <= small.recv_bytes < halves * bb,
        f"a receive region of {need} bytes": grown.recv_bytes == need,
        "its exchanges counted from 0": grown.exchanges == 1,
        "only the new plan's launch record":
            [k[0] for k in grown.launches] == [("a2a", bb)],
        "two kernels per exchange": PK.a2a_cuda_launch_count - cuda0 == 4,
        "2 (W - 1) stream memory operations per exchange":
            PK.a2a_memop_count - memops0 == 4 * (W - 1),
        "every other rank's signal of epoch 0 in the pad":
            all(v >= 1 for r, v in enumerate(pad) if r != rank),
    }
    failed = [k for k, ok in facts.items() if not ok]
    if failed:
        raise AssertionError(f"rank {rank}: K2's workspace growth fails "
                             f"{failed} (recv_bytes {small.recv_bytes} -> "
                             f"{grown.recv_bytes}, exchanges "
                             f"{grown.exchanges}, launches "
                             f"{list(grown.launches)}, kernels "
                             f"{PK.a2a_cuda_launch_count - cuda0}, stream "
                             f"memory operations "
                             f"{PK.a2a_memop_count - memops0}, pad {pad})")


def ranks_worker(rank: int, world: int, init_file: str, device: str, body,
                 *args) -> None:
    """One of ``world`` ranks over a gloo world joined through
    ``init_file``, on ``device``: ``"cpu"``, or ``"cuda"`` for ranks that
    share ``cuda:0``.  Runs ``body(rank, *args)``; on the card then
    releases the workspaces of the kernel exchanges (collectively); clears
    the plan caches and leaves the world."""
    import torch.distributed as dist

    import cudecomp_tpu_torch as ct
    from cudecomp_tpu_torch.parallel import symmetric

    on_card = device == "cuda"
    if on_card:
        torch.cuda.set_device(0)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        body(rank, *args)
        if on_card:
            symmetric.release_workspaces()
        dist.barrier()
    finally:
        ct.clear_plan_caches()
        dist.destroy_process_group()


def check_peer_ranks(rank: int, gdims=(10, 12, 14)) -> None:
    """A :func:`run_card_ranks` body: :func:`check_peer_kernels` and
    :func:`check_workspace_growth` on ``cuda:0``."""
    check_peer_kernels(torch.device("cuda", 0), gdims)
    check_workspace_growth(torch.device("cuda", 0))


def lost_peer_rank(rank: int, init_file: str, bound_s: float) -> None:
    """One of two ranks on ``cuda:0`` over a gloo world joined through
    ``init_file``, whose rank 1 is lost: both make the world's workspace;
    rank 0 runs one K2 exchange and waits for it, which cannot end, so
    the watchdog ends rank 0's process ``bound_s`` seconds after its stream
    reached the exchange (``peer_kernels.LOST_PEER_EXIT``, the message on
    stderr); rank 1 never makes the exchange and leaves unannounced after
    ``bound_s`` + 60 seconds."""
    import torch.distributed as dist

    from cudecomp_tpu_torch.ops import peer_kernels as PK

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=2)
    PK.WAIT_BOUND_S = bound_s
    blocks = torch.zeros((2, 1024), device="cuda")
    if rank == 0:
        PK.a2a(blocks, None)
        torch.cuda.synchronize()
        raise SystemExit("the exchange ended without its peer's signal")
    PK._workspace(None, blocks.device, blocks.numel() * 4 // 2)
    time.sleep(bound_s + 60)
    os._exit(0)


def run_card_ranks(body, world: int, init_file: str, args, timeout: float,
                   what: str) -> None:
    """:func:`run_ranks` of ``world`` :func:`ranks_worker` processes that
    share ``cuda:0`` and run ``body(rank, *args)``; ``body`` is a
    module-level function."""
    run_ranks(ranks_worker, world,
              (world, init_file, "cuda", body) + tuple(args), timeout, what)


def run_cpu_ranks(body, world: int, init_file: str, args, timeout: float,
                  what: str) -> None:
    """:func:`run_card_ranks` for gloo CPU ranks."""
    run_ranks(ranks_worker, world,
              (world, init_file, "cpu", body) + tuple(args), timeout, what)


# -- the autotuner's protocol and the performance report on gloo ranks ----------

def _ok(cond, what=None) -> None:
    """Raise AssertionError with ``what`` unless ``cond``."""
    if not cond:
        raise AssertionError(what)


def _same_on_every_rank(value, what: str) -> None:
    import torch.distributed as dist
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, value)
    if any(v != seen[0] for v in seen):
        raise AssertionError(f"{what} differs between the ranks: {seen}")


def _expect_raises(exc, text, fn, what):
    try:
        fn()
    except exc as e:
        if text not in str(e):
            raise AssertionError(f"{what}: {e!r} does not say {text!r}")
    else:
        raise AssertionError(f"{what}: no {exc.__name__}")


def _check_autotune_protocol(rank: int) -> None:
    """The cases of ``tests/test_autotune.py`` on the CPU ranks of a gloo
    world of 4: the sweep end to end, fixed pdims, the halo phase,
    ``make_grid``, the skip-threshold probe, a halo candidate that cannot
    run, the per-op weights' exact sums, ``grid_mode='halo'``, the trial
    payloads, the error of a sweep in which every candidate cannot run,
    any other error stopping the sweep, and the default candidates by
    device and backend; every rank must choose alike."""
    import importlib

    import torch.distributed as dist

    import cudecomp_tpu_torch as ct
    from cudecomp_tpu_torch import performance as perf
    from cudecomp_tpu_torch.config import (AutotuneOptions, CannotRun,
                                           GridConfig, HaloMethod,
                                           TransposeMethod)

    # the module: the package's name ``autotune`` is the function
    at = importlib.import_module("cudecomp_tpu_torch.autotune")
    TM, HM = TransposeMethod, HaloMethod
    cube = GridConfig(gdims=(16, 16, 16))

    def tune(cfg=cube, **kw):
        res = at.autotune(cfg, "cpu", AutotuneOptions(**kw))
        _same_on_every_rank((res.best_pdims, res.best_method,
                             res.best_halo_method,
                             res.grid.config.transpose_axis_contiguous),
                            f"the choice of autotune({kw})")
        return res

    res = at.autotune(cube, "cpu", AutotuneOptions(n_warmup=1, n_trials=2),
                      dtype=torch.complex64)
    _same_on_every_rank((res.best_pdims, res.best_method), "the choice")
    _ok(res.best_pdims in ((1, 4), (2, 2), (4, 1)), res.best_pdims)
    _ok(res.grid.config.pdims == res.best_pdims)
    _ok(res.grid.config.transpose_method == res.best_method)
    tried = {(t.pdims, t.method) for t in res.trials if not t.skipped}
    _ok(tried == {(p, m.value) for p in ((1, 4), (2, 2), (4, 1))
                  for m in (TM.ALL_TO_ALL, TM.RING, TM.RING_XOR,
                            TM.RING_PIPELINED)}, tried)
    _ok("selected" in res.report())

    res = tune(GridConfig(gdims=(16, 16, 16), pdims=(2, 2)), n_warmup=1,
               n_trials=2)
    _ok(res.best_pdims == (2, 2))
    _ok({t.pdims for t in res.trials} == {(2, 2)})

    res = tune(n_warmup=1, n_trials=2, autotune_halo_method=True,
               halo_extents=(1, 1, 1))
    _ok(res.best_halo_method == HM.PPERMUTE and res.halo_trials)

    grid = ct.make_grid(cube, "cpu", autotune_options=AutotuneOptions(
        n_warmup=0, n_trials=1))
    _ok(grid.pdims[0] * grid.pdims[1] == 4)
    _expect_raises(ValueError, "explicit mesh", lambda: ct.make_grid(
        cube, "cpu", mesh=grid.mesh, autotune_options=AutotuneOptions()),
        "make_grid with a mesh and autotuning")

    res = tune(n_warmup=0, n_trials=1, autotune_layouts=True,
               methods=(TM.ALL_TO_ALL,))
    tags = {t.method for t in res.trials}
    _ok(tags == {"all_to_all/ac=0", "all_to_all/ac=1"}, tags)

    # the probe: one warm-up call and one trial on the candidate's own
    # input; a candidate past the threshold runs nothing more
    calls = []
    real_time_fn = perf.time_fn

    def counting(fn, *args, n_warmup, n_trials, **kw):
        calls.append((n_warmup, n_trials))
        return real_time_fn(fn, *args, n_warmup=n_warmup,
                            n_trials=n_trials, **kw)

    g41 = ct.make_grid(GridConfig(gdims=(16, 16, 16), pdims=(4, 1)), "cpu")
    perf.time_fn = counting
    try:
        times, skipped = at._time_roundtrip(g41, torch.float32, (1.0,) * 4,
                                            2, 3, 1e-12)
        _ok(skipped and len(times) == 1 and calls == [(1, 1)], calls)
        calls.clear()
        times, skipped = at._time_roundtrip(g41, torch.float32, (1.0,) * 4,
                                            2, 3, 1e12)
        _ok(not skipped and len(times) == 3, times)
        _ok(calls == [(1, 1), (0, 3)], calls)
    finally:
        perf.time_fn = real_time_fn

    # the weights' exact sums, on fake per-part times 0.1, 0.2, ...
    def fake(fn, *args, n_warmup, n_trials, **kw):
        calls.append(1)
        return [0.1 * len(calls)] * n_trials

    g22 = ct.make_grid(GridConfig(gdims=(16, 16, 16), pdims=(2, 2)), "cpu")
    perf.time_fn = fake
    try:
        for weights, parts, want in (((8.0, 4.0, 2.0, 1.0), 4, 2.6),
                                     ((4.0, 4.0, 1.0, 1.0), 2, 0.6),
                                     ((0.0, 0.0, 0.0, 1.0), 1, 0.1)):
            calls.clear()
            times, skipped = at._time_roundtrip(g22, torch.float32, weights,
                                                1, 2, None)
            _ok(len(calls) == parts and not skipped, (weights, calls))
            _ok(all(abs(t - want) < 1e-12 for t in times), (weights,
                                                            times))
    finally:
        perf.time_fn = real_time_fn

    # a halo candidate that cannot run is skipped with its error; one that
    # fails otherwise (a kernel that does not build or launch) stops the
    # sweep, in either halo phase
    real_time_halo = at._time_halo

    def halo_boom(exc):
        def run(grid, *a, **k):
            if grid.config.halo_method == HM.PALLAS:
                raise exc
            return real_time_halo(grid, *a, **k)
        return run

    halo_cfg = GridConfig(gdims=(16, 16, 16), pdims=(2, 2))
    halo_kw = dict(n_warmup=0, n_trials=1, autotune_halo_method=True,
                   halo_extents=(1, 1, 1),
                   halo_methods=(HM.PPERMUTE, HM.PALLAS),
                   methods=(TM.ALL_TO_ALL,))
    at._time_halo = halo_boom(CannotRun("halo kaboom"))
    try:
        res = tune(halo_cfg, **halo_kw)
    finally:
        at._time_halo = real_time_halo
    _ok(res.best_halo_method == HM.PPERMUTE)
    bad = [t for t in res.halo_trials if t.skipped]
    _ok(len(bad) == 1 and "halo kaboom" in bad[0].error, res.halo_trials)
    _ok("halo kaboom" in res.report())
    for exc in (RuntimeError("K3 launch failed"), ValueError("a bug")):
        at._time_halo = halo_boom(exc)
        try:
            for mode in ("transpose", "halo"):
                _expect_raises(type(exc), str(exc), lambda: at.autotune(
                    halo_cfg, "cpu", AutotuneOptions(grid_mode=mode,
                                                     **halo_kw)),
                    f"a halo candidate raising {exc!r} ({mode} mode)")
        finally:
            at._time_halo = real_time_halo

    res = tune(n_warmup=1, n_trials=2, grid_mode="halo",
               halo_extents=(1, 1, 1), autotune_halo_method=True)
    _ok(res.grid.config.halo_method == res.best_halo_method)
    _ok(len({t.pdims for t in res.halo_trials}) == 3)
    _ok({t.pdims for t in res.trials} == {res.best_pdims})
    res = tune(GridConfig(gdims=(16, 16, 16), halo_method=HM.PPERMUTE),
               n_warmup=1, n_trials=1, grid_mode="halo",
               halo_extents=(1, 1, 1))
    _ok({t.method for t in res.halo_trials} == {"ppermute"})
    _expect_raises(ValueError, "halo_extents", lambda: at.autotune(
        cube, "cpu", AutotuneOptions(grid_mode="halo")), "grid_mode='halo'")

    he, pads = ((1, 1, 1),) * 4, ((1, 0, 0),) * 4
    for weights in ((1.0,) * 4, (2.0, 1.0, 1.0, 2.0)):
        res = tune(n_warmup=1, n_trials=1, transpose_op_weights=weights,
                   transpose_input_halo_extents=he,
                   transpose_output_halo_extents=he,
                   transpose_input_padding=pads,
                   transpose_output_padding=pads)
        _ok(res.best_time_s > 0)
    _expect_raises(ValueError, "do not chain", lambda: at.autotune(
        cube, "cpu", AutotuneOptions(transpose_input_halo_extents=he)),
        "payloads that do not chain")
    res = tune(GridConfig(gdims=(16, 16, 16), pdims=(2, 2)), n_warmup=0,
               n_trials=1, n_components=1, dtype="float32",
               methods=(TM.ALL_TO_ALL,), autotune_halo_method=True,
               halo_extents=(1, 1, 1))
    _ok(res.best_method == TM.ALL_TO_ALL and res.halo_trials)

    # every candidate cannot run: the first error is chained and recorded
    real_rt = at._time_roundtrip

    def boom(grid, *a, **k):
        raise CannotRun("kaboom-inner")

    at._time_roundtrip = boom
    try:
        _expect_raises(RuntimeError, "every candidate was skipped; first "
                       "failure: CannotRun('kaboom-inner')",
                       lambda: at.autotune(cube, "cpu", AutotuneOptions(
                           n_warmup=0, n_trials=1)),
                       "a sweep in which every candidate cannot run")
    finally:
        at._time_roundtrip = real_rt

    # a candidate that fails otherwise stops the sweep with its own error,
    # even where another method could win (a kernel that does not build or
    # launch never gives way to the plain version)
    for exc in (RuntimeError("K2 launch failed"), ValueError("a bug")):
        def fails(grid, *a, exc=exc, **k):
            if grid.config.transpose_method == TM.RING:
                raise exc
            return real_rt(grid, *a, **k)

        at._time_roundtrip = fails
        try:
            _expect_raises(type(exc), str(exc), lambda: at.autotune(
                cube, "cpu", AutotuneOptions(
                    n_warmup=0, n_trials=1,
                    methods=(TM.ALL_TO_ALL, TM.RING))),
                f"a candidate raising {exc!r}")
        finally:
            at._time_roundtrip = real_rt

    # the default candidates follow the device and the backend (gloo: the
    # CPU's); a method the knob names is tried even where it cannot run
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    hosts = ("h",) * dist.get_world_size()
    opts = AutotuneOptions()
    _ok(at._transpose_method_candidates(opts, cpu, hosts) == [
        TM.ALL_TO_ALL, TM.RING, TM.RING_XOR, TM.RING_PIPELINED])
    _ok(at._transpose_method_candidates(opts, cpu, ("a", "a", "b", "b")
                                        )[-1] == TM.RING_HIER)
    _ok(at._transpose_method_candidates(opts, cuda, hosts) == [
        TM.PALLAS_A2A])
    _ok(at._halo_method_candidates(opts, cpu) == [HM.PPERMUTE])
    _ok(at._halo_method_candidates(opts, cuda) == [HM.PALLAS])
    os.environ[at.METHODS_KNOB] = "ring,pallas_a2a"
    try:
        _ok(at._transpose_method_candidates(opts, cuda, hosts) == [
            TM.RING, TM.PALLAS_A2A])
        real_rt = at._time_roundtrip

        def cannot(grid, *a, **k):
            if grid.config.transpose_method == TM.RING:
                raise CannotRun("ppermute of a cuda tensor over gloo")
            return real_rt(grid, *a, **k)

        at._time_roundtrip = cannot
        try:
            res = tune(GridConfig(gdims=(16, 16, 16), pdims=(2, 2)),
                       n_warmup=0, n_trials=1)
        finally:
            at._time_roundtrip = real_rt
        _ok(res.best_method == TM.PALLAS_A2A)
        (ring,) = [t for t in res.trials if t.method == "ring"]
        _ok(ring.skipped and "over gloo" in ring.error, ring)
        os.environ[at.METHODS_KNOB] = "^pallas_a2a"
        _ok(at._transpose_method_candidates(opts, cuda, hosts) == [
            TM.PALLAS_A2A])  # nothing left: the knob is ignored
    finally:
        del os.environ[at.METHODS_KNOB]


def _check_performance(rank: int) -> None:
    """On the CPU ranks of a gloo world of 4: ``segment_roundtrip`` at
    pdims (2, 2) and (1, 4), the cross-rank reduction of the report's
    rows, and a profiled round trip whose exchanges count as
    communication."""
    import tempfile

    import torch.distributed as dist

    import cudecomp_tpu_torch as ct
    from cudecomp_tpu_torch import performance as perf
    from cudecomp_tpu_torch.config import GridConfig

    for pdims in ((2, 2), (1, 4)):
        grid = ct.make_grid(GridConfig(gdims=(16, 16, 16), pdims=pdims),
                            "cpu")
        seg = perf.segment_roundtrip(grid, torch.float32, iters=2,
                                     n_warmup=1, n_trials=1, record=False)
        _ok(set(seg) == {"total_ms", "a2a_ms", "local_ms", "a2a_gbps"})
        _ok(seg["total_ms"] > 0 and 0 < seg["a2a_ms"] <= seg["total_ms"])
        _ok(abs(seg["total_ms"] - seg["a2a_ms"] - seg["local_ms"]) < 1e-9)
        _ok(seg["a2a_gbps"] > 0)

    reg = perf.PerfRegistry()
    for ms in (1.0, 2.0 + rank, 4.0 + 2 * rank):  # the first is discarded
        reg.record(("op", (16, 16, 16)), ms, 1024)
    reg.record(("warm only",), 1.0)  # no rank has samples past it
    (row,) = reg.rows(cross_host=True)
    means = [3.0 + 1.5 * r for r in range(4)]
    want = {"config": "op/(16, 16, 16)", "count": 8,
            "avg_ms": sum(means) / 4, "min_ms": 2.0, "max_ms": 10.0,
            "std_ms": sum((2.0 + r) / 2 for r in range(4)) / 4}
    for k, v in want.items():
        _ok(row[k] == v, (k, row[k], v))
    (local,) = reg.rows()
    _ok(local["count"] == 2 and local["avg_ms"] == means[rank])

    grid = ct.make_grid(GridConfig(gdims=(16, 16, 16), pdims=(2, 2)), "cpu")
    x = torch.zeros(grid.buffer_shape(0))
    with tempfile.TemporaryDirectory() as d:
        with perf.profile_trace(d):
            ct.transpose_y_to_x(grid, ct.transpose_x_to_y(grid, x))
        a = perf.device_op_attribution(d)
    _ok(a["comm_ms"] > 0 and a["local_ms"] > 0, a)
    _ok("cudecomp_tpu_torch.exchange.all_to_all" in a["ranges"], a)
    _ok(abs(a["total_ms"] - a["comm_ms"] - a["local_ms"]) < 1e-9)
    dist.barrier()


def _check_autotune_fft(rank: int) -> None:
    """``autotune_fft`` on 4 CPU ranks: on an uneven (2, 2) grid the gate
    data is zero outside the valid interior and every rank records the
    same trials and picks the same policy; on a (4, 1) grid whose (1, 2)
    stage K5 takes, both candidates run and every rank picks alike."""
    import cudecomp_tpu_torch as ct
    from cudecomp_tpu_torch.ops import fft as F
    from cudecomp_tpu_torch.utils.arrays import valid_interior_mask

    seen = []
    planes = F.DistributedFFT.forward_planes

    def spy(self, x):
        seen.append(x)
        return planes(self, x)

    F.DistributedFFT.forward_planes = spy
    try:
        grid = ct.make_grid(ct.GridConfig(gdims=(9, 10, 11), pdims=(2, 2)),
                            "cpu")
        res = F.autotune_fft(grid, n_warmup=0, n_trials=2, iters=1)
        outside = ~valid_interior_mask(grid, 0)
        import torch.distributed as dist
        padded = [None] * dist.get_world_size()
        dist.all_gather_object(padded, bool(outside.any()))
        _ok(any(padded), "the grid is uneven")
        for x in seen:
            for v in x:
                _ok(not bool(v[outside].any()), "gate data in the padding")
        _ok([t.fused2 for t in res.trials] == [False, True], "candidates")
        _ok(res.trials[0].gate_passed and res.trials[1].reason is not None,
            "the cuFFT candidate passes; K5 has no stage here")
        _same_on_every_rank([(t.fused2, t.err, t.gate_passed, t.times_s)
                             for t in res.trials], "the uneven trials")
        seen.clear()
        grid = ct.make_grid(ct.GridConfig(gdims=(8, 8, 128), pdims=(4, 1)),
                            "cpu")
        res = F.autotune_fft(grid, n_warmup=0, n_trials=2, iters=1)
        _ok(all(t.gate_passed for t in res.trials), "both run and pass")
        _same_on_every_rank(([(t.fused2, t.err, t.times_s)
                              for t in res.trials], res.plan.fused2,
                             res.best_time_s), "the trials and the winner")
    finally:
        F.DistributedFFT.forward_planes = planes


def protocol_worker(rank: int, world: int, init_file: str,
                    checks) -> None:
    """One CPU rank of a gloo world (``file://`` init): runs each named
    check of ``_check_autotune_protocol``, ``_check_performance`` and
    ``_check_autotune_fft``."""
    import torch.distributed as dist

    import cudecomp_tpu_torch as ct

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        for name in checks:
            {"autotune": _check_autotune_protocol,
             "performance": _check_performance,
             "autotune_fft": _check_autotune_fft}[name](rank)
        dist.barrier()
    finally:
        ct.clear_plan_caches()
        dist.destroy_process_group()
