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


_KINDS = {"transpose": _run_case, "halo": _run_halo_case,
          "stencil": _run_stencil_case, "cg": _run_cg_case,
          "spectral": _run_spectral_case, "peer": _run_peer_case}


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
    ``halo_extents`` and ``periods``, and K2's and K3's plans).  A case
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
        different data (its entry barrier makes reusing the workspace safe);
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
    released.  Each exchange is four CUDA launches, as the C entry reports
    them.  Raises AssertionError on a difference."""
    import torch.distributed as dist

    from cudecomp_tpu_torch.ops import peer_kernels as PK
    from cudecomp_tpu_torch.parallel import collectives, symmetric

    W, rank = dist.get_world_size(), dist.get_rank()
    if W < 2:
        raise ValueError("a workspace grows over two ranks or more")
    gen = torch.Generator().manual_seed(seed * 1000 + rank + 1)
    seen, cuda0 = [], PK.a2a_cuda_launch_count
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
    need = -(-(W - 1) * bb // symmetric.GROW_ALIGN) * symmetric.GROW_ALIGN
    facts = {
        "a new workspace": grown is not small,
        "the old one released": small.bases_dev is None
        and not small.launches,
        "the first one too small for the second exchange":
            (W - 1) * bb_small <= small.recv_bytes < (W - 1) * bb,
        f"a receive region of {need} bytes": grown.recv_bytes == need,
        "its exchanges counted from 0": grown.exchanges == 1,
        "only the new plan's launch record":
            [k[0] for k in grown.launches] == [("a2a", bb)],
        "four CUDA launches per exchange":
            PK.a2a_cuda_launch_count - cuda0 == 8,
    }
    failed = [k for k, ok in facts.items() if not ok]
    if failed:
        raise AssertionError(f"rank {rank}: K2's workspace growth fails "
                             f"{failed} (recv_bytes {small.recv_bytes} -> "
                             f"{grown.recv_bytes}, exchanges "
                             f"{grown.exchanges}, launches "
                             f"{list(grown.launches)}, CUDA launches "
                             f"{PK.a2a_cuda_launch_count - cuda0})")


def card_ranks_worker(rank: int, world: int, init_file: str, body,
                      *args) -> None:
    """One of ``world`` ranks that share ``cuda:0`` over a gloo world joined
    through ``init_file``: runs ``body(rank, *args)``, then releases the
    workspaces of the kernel exchanges (collectively), clears the plan
    caches and leaves the world."""
    import torch.distributed as dist

    import cudecomp_tpu_torch as ct
    from cudecomp_tpu_torch.parallel import symmetric

    torch.cuda.set_device(0)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        body(rank, *args)
        symmetric.release_workspaces()
        dist.barrier()
    finally:
        ct.clear_plan_caches()
        dist.destroy_process_group()


def check_peer_ranks(rank: int, gdims=(10, 12, 14)) -> None:
    """A :func:`card_ranks_worker` body: :func:`check_peer_kernels` and
    :func:`check_workspace_growth` on ``cuda:0``."""
    check_peer_kernels(torch.device("cuda", 0), gdims)
    check_workspace_growth(torch.device("cuda", 0))


def run_card_ranks(body, world: int, init_file: str, args, timeout: float,
                   what: str) -> None:
    """:func:`run_ranks` of ``world`` :func:`card_ranks_worker` processes
    that run ``body(rank, *args)``; ``body`` is a module-level function."""
    run_ranks(card_ranks_worker, world,
              (world, init_file, body) + tuple(args), timeout, what)
