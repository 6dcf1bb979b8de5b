"""Benchmark — distributed 3D c2c FFT round trip on one GPU.

Methodology of the reference FFT benchmark (``benchmark/benchmark.cu:
501-665``): forward+inverse round trips of complex64 data in cuFFT's
native interleaved layout, the time halved for one direction, and
GFLOPS = 5 * N^3 * log2(N^3) / t.  The grid is ``pdims (1, 1)`` with
axis-contiguous pencils by default, so each 1D FFT runs along the
contiguous axis and the four slab transposes of a round trip each run
the K1 local-permute kernel.

One round trip is gated at the reference's single-precision tolerance,
max abs error < 5e-4 (``benchmark.cu:23-27``), before timing, and the
output of the timed run is held to the same gate.  Times are CUDA-event
times (``performance.time_fn``); the rate is all timed round trips over
all the time they took, and the per-trial times are reported beside it.

Run: ``python -m cudecomp_tpu_torch.bench [N] [iters]``; prints one JSON
line.

Beside the FFT, the halo and stencil path's three headlines, each one
JSON dict, mirroring the JAX bench table (``bench_full.py:265-342``):
:func:`stencil_headline` (the fused diffusion step, 512^3 f32),
:func:`halo_headline` (a width-1 periodic halo update, 512^3 f32) and
:func:`cg_headline` (the CG Poisson solve, 256^3 f32, tol 1e-5); and the
spectral path's three: :func:`poisson_headline` (the r2c split-complex
spectral Poisson solve, 256^3 f32, with K5 on and off),
:func:`tg_headline` (one Taylor-Green IF-RK4 step, 256^3 f32) and
:func:`ns_headline` (one RK4 step of the projection solver, 256^3 f32,
with K5 on and off).  Data comes from a seeded generator on the card;
times are CUDA-event times over the whole timed window.

The one-sided exchange path's headline, :func:`peer_headline`, runs on
four ranks that share one card (processes over gloo, every rank on
``cuda:0``): K2 per exchange (512^3 c64, pdims (2, 2)), the
``PALLAS_A2A`` FFT round trip, K3 per dim and the ``HaloMethod.PALLAS``
update (512^3 f32, width 1).  Each rank times with CUDA events; a time is
the slowest rank's.  It says whether MPS was on: without MPS the four
processes time-slice the card, and every time is that of a shared card.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from cudecomp_tpu_torch.config import GridConfig, HaloMethod, TransposeMethod
from cudecomp_tpu_torch.grid import make_grid
from cudecomp_tpu_torch.models.incompressible import ProjectionSolver
from cudecomp_tpu_torch.models.poisson import PoissonSolver
from cudecomp_tpu_torch.models.taylor_green import TaylorGreenSolver
from cudecomp_tpu_torch.ops.fft import DistributedFFT
from cudecomp_tpu_torch.ops.halo import update_halos
from cudecomp_tpu_torch.ops.stencil import diffusion_step
from cudecomp_tpu_torch.ops import peer_kernels
from cudecomp_tpu_torch.performance import time_fn

GATE = 5e-4


def make_plan(N: int, axis_contiguous: bool = True, device="cuda",
              real: bool = False) -> DistributedFFT:
    """The benchmark's plan: an N^3 grid on one rank (``pdims (1, 1)``)."""
    ac = bool(axis_contiguous)
    cfg = GridConfig(gdims=(N, N, N), pdims=(1, 1),
                     transpose_axis_contiguous=(ac, ac, ac))
    return DistributedFFT(grid=make_grid(cfg, device), real=real)


def make_field(grid, seed: int = 0, dtype=torch.complex64) -> torch.Tensor:
    """Standard-normal real and imaginary parts (or real values, for a
    real ``dtype``) in the grid's X-pencil layout, from a seeded generator
    on the grid's device."""
    gen = torch.Generator(device=grid.device)
    gen.manual_seed(seed)
    shape = grid.buffer_shape(0)
    if dtype.is_complex:
        parts = torch.randn(shape + (2,), generator=gen, device=grid.device,
                            dtype=dtype.to_real())
        return torch.view_as_complex(parts)
    return torch.randn(shape, generator=gen, device=grid.device, dtype=dtype)


def cycle(plan: DistributedFFT, x: torch.Tensor) -> torch.Tensor:
    """One forward + inverse round trip."""
    return plan.inverse(plan.forward(x))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def _gate(err: float, what: str) -> None:
    if not err < GATE:
        raise RuntimeError(f"{what}: max abs err {err} is not < {GATE}")


def main(N: int = 512, iters: int = 20, n_trials: int = 3,
         axis_contiguous: bool = True) -> dict:
    """Time the N^3 c2c round trip on the current GPU; returns and prints
    the result."""
    _need_cuda()
    plan = make_plan(N, axis_contiguous, "cuda")
    x = make_field(plan.grid, seed=0)
    err = max_abs_err(cycle(plan, x), x)
    _gate(err, "gate round trip")

    last = {}

    def timed():
        last["y"] = cycle(plan, x)

    times = time_fn(timed, n_warmup=2, n_trials=n_trials, iters=iters)
    timed_err = max_abs_err(last["y"], x)
    _gate(timed_err, "timed round trip")

    # all the work over the whole timed window; the trials show the spread
    t = sum(times) / len(times) / 2.0  # one direction
    n_total = N ** 3
    gflops = 5.0 * n_total * math.log2(n_total) / t / 1e9
    payload = {
        "metric": f"{N}^3 c2c FFT single-direction (complex64, pdims (1, 1), "
                  f"{'axis-contiguous' if axis_contiguous else 'natural'})",
        "value": gflops,
        "unit": "GFLOPS",
        "ms_per_direction": t * 1e3,
        "round_trip_ms_trials": [s * 1e3 for s in times],
        "gate_err": err,
        "timed_err": timed_err,
        "device": torch.cuda.get_device_name(0),
    }
    print(json.dumps(payload))
    return payload


def _need_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("the benchmark measures the GPU and needs CUDA")


def _cube_grid(N: int, device="cuda"):
    """An N^3 grid on one rank in the natural layout, as the JAX bench's
    stencil, halo and CG headlines use."""
    return make_grid(GridConfig(gdims=(N, N, N), pdims=(1, 1)), device)


def halo_bytes(grid, axis: int, halo_extents, itemsize: int) -> int:
    """Bytes a halo update of every dim moves: each halo slab read once
    from the interior and written once, over the buffer's full face."""
    cfg = grid.config
    shape = grid.buffer_shape(axis, halo_extents)
    inv = cfg.inv_mem_order(axis)
    total = 0
    for d in range(3):
        face = math.prod(n for i, n in enumerate(shape) if i != inv[d])
        total += 2 * halo_extents[d] * face
    return 2 * total * itemsize


def stencil_headline(N: int = 512, iters: int = 20, n_trials: int = 3,
                     dt: float = 0.1) -> dict:
    """ms per fused diffusion step ``u + dt * lap(u)`` (periodic, f32) and
    its rate, one read plus one write of the field."""
    _need_cuda()
    grid = _cube_grid(N)
    x = make_field(grid, seed=2, dtype=torch.float32)
    times = time_fn(lambda: diffusion_step(grid, x, dt, 0, (True,) * 3),
                    n_warmup=2, n_trials=n_trials, iters=iters)
    t = sum(times) / len(times)
    return {"metric": f"{N}^3 f32 fused diffusion step (ghost-plane "
                      f"stencil, pdims (1, 1))",
            "value": t * 1e3, "unit": "ms",
            "gbps": 2 * x.numel() * x.element_size() / t / 1e9,
            "trials_ms": [s * 1e3 for s in times],
            "device": torch.cuda.get_device_name(0)}


def halo_headline(N: int = 512, width: int = 1, iters: int = 20,
                  n_trials: int = 3) -> dict:
    """ms per halo update of the X-pencil with ``width`` halos on every
    dim, periodic (f32), and its rate over the slabs it moves."""
    _need_cuda()
    grid = _cube_grid(N)
    he = (width, width, width)
    gen = torch.Generator(device=grid.device)
    gen.manual_seed(4)
    x = torch.randn(grid.buffer_shape(0, he), generator=gen,
                    device=grid.device)
    times = time_fn(lambda: update_halos(grid, x, 0, he, (True,) * 3),
                    n_warmup=2, n_trials=n_trials, iters=iters)
    t = sum(times) / len(times)
    return {"metric": f"{N}^3 f32 halo update (x-pencil, width {width}, "
                      f"periodic, pdims (1, 1))",
            "value": t * 1e3, "unit": "ms",
            "gbps": halo_bytes(grid, 0, he, x.element_size()) / t / 1e9,
            "trials_ms": [s * 1e3 for s in times],
            "device": torch.cuda.get_device_name(0)}


def cg_headline(N: int = 256, tol: float = 1e-5,
                maxiter: int = 2000) -> dict:
    """The CG Poisson solve of a standard-normal f32 rhs: total ms (after
    one untimed solve), iterations, ms per iteration, and the residual."""
    _need_cuda()
    solver = PoissonSolver(grid=_cube_grid(N))
    f = make_field(solver.grid, seed=3, dtype=torch.float32)
    last = {}

    def solve():
        last["out"] = solver.solve_cg(f, tol=tol, maxiter=maxiter)

    (t,) = time_fn(solve, n_warmup=1, n_trials=1)
    _, iters, rel = last["out"]
    return {"metric": f"{N}^3 f32 Poisson CG solve (K4 matvec, tol {tol:g}, "
                      f"pdims (1, 1))",
            "value": t * 1e3, "unit": "ms", "iters": int(iters),
            "rel_residual": float(rel),
            "ms_per_iter": t * 1e3 / max(int(iters), 1),
            "device": torch.cuda.get_device_name(0)}



@contextlib.contextmanager
def fused2(on: bool):
    """``CUDECOMP_TPU_FFT_FUSED2`` set to ``on`` inside the block, and
    restored after."""
    name = "CUDECOMP_TPU_FFT_FUSED2"
    old = os.environ.get(name)
    os.environ[name] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def _on_off(fn, iters: int, n_trials: int) -> dict:
    """ms per call of ``fn`` with K5 off and on, in the order off, on,
    on, off (drift shows as disagreeing pairs); the mean per side."""
    runs = {"off": [], "on": []}
    for side in ("off", "on", "on", "off"):
        with fused2(side == "on"):
            times = time_fn(fn, n_warmup=1, n_trials=n_trials, iters=iters)
        runs[side].append(sum(times) / len(times) * 1e3)
    return {"on_ms": sum(runs["on"]) / 2, "off_ms": sum(runs["off"]) / 2,
            "runs_ms": runs}


def poisson_headline(N: int = 256, iters: int = 10, n_trials: int = 3
                     ) -> dict:
    """ms per r2c split-complex spectral Poisson solve of an N^3 f32
    field, with K5 off (``value``, the default path) and on."""
    _need_cuda()
    solver = PoissonSolver(grid=_cube_grid(N), split_complex=True)
    f = make_field(solver.grid, seed=5, dtype=torch.float32)
    t = _on_off(lambda: solver.solve(f), iters, n_trials)
    return {"metric": f"{N}^3 f32 spectral Poisson solve (r2c, "
                      f"split-complex, pdims (1, 1))",
            "value": t["off_ms"], "unit": "ms", **t,
            "device": torch.cuda.get_device_name(0)}


def tg_headline(N: int = 256, iters: int = 3, n_trials: int = 3,
                dt: float = 2e-3) -> dict:
    """ms per Taylor-Green IF-RK4 step at N^3, f32 split-complex state,
    Re 1600 (K5 never runs there: the state has a component dim)."""
    _need_cuda()
    solver = TaylorGreenSolver(grid=_cube_grid(N), nu=1.0 / 1600.0,
                               split_complex=True)
    uh, f = solver.setup(torch.float32)
    times = time_fn(lambda: solver.step(uh, f, dt), n_warmup=1,
                    n_trials=n_trials, iters=iters)
    t = sum(times) / len(times)
    return {"metric": f"{N}^3 f32 Taylor-Green IF-RK4 step (split-complex, "
                      f"Re 1600, pdims (1, 1))",
            "value": t * 1e3, "unit": "ms",
            "trials_ms": [s * 1e3 for s in times],
            "device": torch.cuda.get_device_name(0)}


def ns_headline(N: int = 256, iters: int = 3, n_trials: int = 3,
                dt: float = 1e-2) -> dict:
    """ms per RK4 step of the projection solver on the extruded
    Taylor-Green field at N^3 f32 (split-complex pressure FFTs), with K5
    off (``value``, the default path) and on."""
    _need_cuda()
    solver = ProjectionSolver(grid=_cube_grid(N), split_complex=True)
    u, f = solver.setup_tg(torch.float32)
    t = _on_off(lambda: solver.step(u, f, dt), iters, n_trials)
    return {"metric": f"{N}^3 f32 projection-solver RK4 step (split-complex "
                      f"pressure, pdims (1, 1))",
            "value": t["off_ms"], "unit": "ms", **t,
            "device": torch.cuda.get_device_name(0)}

def _smi(query: str, what: str = "--query-gpu") -> str:
    out = subprocess.run(["nvidia-smi", f"{what}={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip()


def compute_mode() -> str:
    """The card's compute mode (``nvidia-smi``): ``Default`` lets several
    processes hold a context on it; ``Exclusive_Process`` only one (or an
    MPS server)."""
    return _smi("compute_mode").splitlines()[0]


def mps_active() -> bool:
    """Whether an MPS server holds the card (``nvidia-smi`` lists it among
    the compute processes once a client has connected)."""
    return "mps" in _smi("process_name", "--query-compute-apps").lower()


def peer_grids(N: int = 512, device="cuda"):
    """The one-sided path's two grids, pdims (2, 2): the axis-contiguous
    c64 FFT grid with ``PALLAS_A2A`` and the natural-layout halo grid with
    ``HaloMethod.PALLAS``."""
    fft_cfg = GridConfig(gdims=(N, N, N), pdims=(2, 2),
                         transpose_axis_contiguous=(True, True, True),
                         transpose_method=TransposeMethod.PALLAS_A2A)
    halo_cfg = GridConfig(gdims=(N, N, N), pdims=(2, 2),
                          halo_method=HaloMethod.PALLAS)
    return make_grid(fft_cfg, device), make_grid(halo_cfg, device)


def peer_rank_times(N: int = 512, width: int = 1, iters: int = 5,
                    n_trials: int = 3, device="cuda") -> dict:
    """In one rank of four that share the card (a gloo world of 4, every
    rank on its card): ms per K2 exchange of this rank's 512^3 c64 pencil
    over the ``pr`` group, per ``PALLAS_A2A`` c2c round trip (halved: one
    direction), per K3 update of the y dim and per ``HaloMethod.PALLAS``
    update of every dim (512^3 f32, width ``width``, periodic).  Means over
    trials of CUDA-event times; every rank calls."""
    import torch.distributed as dist
    fgrid, hgrid = peer_grids(N, device)
    dev = fgrid.device

    def t(fn):
        dist.barrier()
        times = time_fn(fn, n_warmup=1, n_trials=n_trials, iters=iters)
        return sum(times) / len(times) * 1e3

    plan = DistributedFFT(grid=fgrid)
    x = make_field(fgrid, seed=7)
    pr = fgrid.group(fgrid.axis_names[0])
    blocks = torch.empty(fgrid.buffer_shape(0), dtype=torch.complex64,
                         device=dev).view(2, -1)
    out = {"k2_ms": t(lambda: peer_kernels.a2a(blocks, pr)),
           "fft_ms_per_direction": t(lambda: cycle(plan, x)) / 2}
    del blocks, x, plan
    he = (width,) * 3
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    buf = torch.randn(hgrid.buffer_shape(0, he), generator=gen, device=dev)
    m = buf.shape[1] - 2 * width
    out["k3_ms"] = t(lambda: peer_kernels.halo_exchange(
        buf, hgrid.group(hgrid.axis_names[0]), 1, width, m, (N // 2,) * 2,
        True))
    out["halo_ms"] = t(lambda: update_halos(hgrid, buf, 0, he, (True,) * 3))
    return out


def peer_worker(rank: int, out_dir: str, kw: dict) -> None:
    """One rank of :func:`peer_headline` (a ``card_ranks_worker`` body):
    times :func:`peer_rank_times` and writes ``rank<r>.json`` to
    ``out_dir`` (rank 0 adds whether MPS was on)."""
    res = peer_rank_times(**kw)
    if rank == 0:
        res["mps"] = mps_active()  # while the ranks hold the card
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))


def merge_ranks(per_rank) -> dict:
    """Each time as the slowest rank's, with every rank's beside it."""
    keys = per_rank[0].keys()
    return {**{k: max(r[k] for r in per_rank) for k in keys},
            "ranks_ms": {k: [r[k] for r in per_rank] for k in keys}}


def peer_headline(N: int = 512, width: int = 1, ranks: int = 4,
                  iters: int = 5, n_trials: int = 3,
                  timeout: float = 600) -> dict:
    """The one-sided exchange path on ``ranks`` processes that share this
    card (see the module docstring); prints and returns the slowest rank's
    times, and whether MPS was on."""
    from cudecomp_tpu_torch.utils.testing import run_card_ranks
    _need_cuda()
    peer_kernels.build()  # once here, not in every rank
    with tempfile.TemporaryDirectory() as tmp:
        run_card_ranks(peer_worker, ranks, str(Path(tmp, "pg")),
                       (tmp, dict(N=N, width=width, iters=iters,
                                  n_trials=n_trials)),
                       timeout, "the one-sided exchange headline")
        per_rank = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                    for r in range(ranks)]
    mps = per_rank[0].pop("mps")
    payload = {"metric": f"{N}^3 one-sided exchanges, {ranks} ranks sharing "
                         f"one card, pdims (2, 2)",
               **merge_ranks(per_rank), "unit": "ms", "mps": mps,
               "note": ("MPS on" if mps else "no MPS: the ranks time-slice "
                        "the card, so each time is that of a shared card"),
               "device": torch.cuda.get_device_name(0)}
    print(json.dumps(payload))
    return payload


# -- the exchange synchronisation, weighed: tools/peer_sync.py -----------------

#: ps_exchange's variants (tools/peer_sync_variants.cu); "lib" is K2 or K3
#: as the library runs it
SYNC_VARIANTS = {0: "spinning barrier kernels (the first design)",
                 1: "stream writes and waits, entry barrier",
                 2: "stream writes and waits, double buffered",
                 3: "signal kernel and stream waits, double buffered"}
#: ps_round's kinds, and "events": interprocess CUDA events and a gloo
#: barrier
SYNC_ROUNDS = {0: "a: spinning kernel", 1: "b: stream write and wait",
               2: "b': signal kernel and stream wait",
               "events": "c: interprocess events and a gloo barrier"}
_SYNC_ERRORS = {1001: "a driver entry point is missing",
                1002: "a device attribute query failed",
                1003: "no 64-bit stream memory operations"}


def build_sync_variants(source, out_dir) -> Path:
    """nvcc of ``source`` (``tools/peer_sync_variants.cu``) with K0's file
    and the library flags into ``out_dir``; returns the library's path."""
    from cudecomp_tpu_torch.utils import cuda_build
    lib = Path(out_dir, "libpeer_sync.so")
    cmd = [str(cuda_build.nvcc_path()), *cuda_build.NVCC_FLAGS, "-o",
           str(lib), str(cuda_build.CSRC_DIR / cuda_build.PROBE_SOURCE),
           str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{res.stdout}"
                           f"{res.stderr}")
    return lib


def _sync_lib(path):
    import ctypes
    lib = ctypes.CDLL(str(path))
    p, i, i64, u64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_uint64)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.ps_caps.argtypes = [ip]
    lib.ps_caps.restype = None
    lib.ps_round.argtypes = [i, p, p, i, p, i, u64, p, ip, ip]
    lib.ps_round.restype = i
    lib.ps_exchange.argtypes = [i, p, p, p, p, i, p, i, u64, p, i, p, i,
                                i64, i64, i64, p, ip, ip]
    lib.ps_exchange.restype = i
    return lib


def _sync_check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} failed: "
                           f"{_SYNC_ERRORS.get(err, err)} ({err})")


def _pair_groups(grid, name):
    """A new gloo group with the members of this rank's ``name`` group of
    ``grid`` (so that it has a workspace of its own); every rank calls."""
    import torch.distributed as dist
    mine = dist.get_process_group_ranks(grid.group(name))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    out = None
    for members in sorted({tuple(m) for m in every}):
        g = dist.new_group(list(members))
        if dist.get_rank() in members:
            out = g
    return out


def _profile_keys(fn) -> list:
    """``[name, device type, count]`` of every event ``torch.profiler``
    records around one call of ``fn`` and a synchronize."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [[e.key[:120], str(e.device_type).split(".")[-1], e.count]
            for e in prof.key_averages()]


def _traced_roundtrip(plan, x, reps: int = 2) -> dict:
    """One ``performance.profile_trace`` capture of ``reps`` c2c round
    trips of ``plan`` on ``x`` (after one untraced), in every rank: the
    window on this rank's stream (CUDA events) and this process's device
    time by kernel and its comm/local split, per round trip."""
    import torch.distributed as dist
    from cudecomp_tpu_torch import performance
    cycle(plan, x)
    torch.cuda.synchronize()
    dist.barrier()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with tempfile.TemporaryDirectory() as d:
        with performance.profile_trace(d):
            start.record()
            for _ in range(reps):
                cycle(plan, x)
            end.record()
        end.synchronize()
        a = performance.device_op_attribution(d)
    return {"window_ms": start.elapsed_time(end) / reps,
            "ops": {k: v / reps for k, v in a["ops"].items()},
            "comm_ms": a["comm_ms"] / reps, "local_ms": a["local_ms"] / reps,
            "lost": a["lost_launches"]}


def peer_sync_rank(lib_path, N: int = 512, width: int = 1,
                   rounds: int = 200, iters: int = 5, n_trials: int = 3,
                   device="cuda") -> dict:
    """In one rank of a gloo world whose ranks share the card: the rounds
    of :data:`SYNC_ROUNDS` over the world, then K2 (a rank's N^3 c64
    pencil over ``pr`` at pdims (2, 2)) and K3 (the y dim of the N^3 f32
    x-pencil, width ``width``, periodic) under each variant of
    :data:`SYNC_VARIANTS` and as the library runs them, in turns.  Each
    variant's K2 and K3 are first held bit for bit to the plain executor
    on the card.  Before them, while the process is young enough for the
    profiler to keep every kernel record, the ``PALLAS_A2A`` round trip
    at pdims (2, 2) traced (:func:`_traced_roundtrip`).  Times are
    CUDA-event means; every rank calls."""
    import ctypes
    import time
    import torch.distributed as dist
    from cudecomp_tpu_torch.parallel import symmetric
    lib = _sync_lib(lib_path)
    dev = torch.device(device, torch.cuda.current_device())
    W, me = dist.get_world_size(), dist.get_rank()
    caps = (ctypes.c_int * 4)()
    lib.ps_caps(caps)
    res = {"caps": dict(zip(("mem_ops_64", "wait_nor", "flush_remote",
                             "status"), list(caps)))}
    kernels, memops = ctypes.c_int(0), ctypes.c_int(0)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    fgrid, hgrid = peer_grids(N, device)
    plan = DistributedFFT(grid=fgrid)
    x = make_field(fgrid, seed=7)
    res["roundtrip"] = _traced_roundtrip(plan, x)
    del plan, x

    # the rounds, over the world
    world = dist.new_group(list(range(W)))
    ws = symmetric.workspace(world, dev, 1)
    peers = [p for p in range(W) if p != me]
    cpeers = (ctypes.c_int * len(peers))(*peers)
    epoch = [0]

    def round_of(kind):
        def go():
            epoch[0] += 1
            _sync_check(lib.ps_round(kind, ws.bases_dev.data_ptr(),
                                     ws.bases_host, me, cpeers, len(peers),
                                     epoch[0], stream(),
                                     ctypes.byref(kernels),
                                     ctypes.byref(memops)),
                        f"round kind {kind}")
        return go

    ev = torch.cuda.Event(interprocess=True)
    ev.record()
    handles = [None] * W
    dist.all_gather_object(handles, ev.ipc_handle())
    peer_events = [torch.cuda.Event.from_ipc_handle(dev, handles[p])
                   for p in peers]

    def events_round():
        ev.record()
        dist.barrier()
        for pe in peer_events:
            torch.cuda.current_stream(dev).wait_event(pe)

    def timed_rounds(fn):
        out = []
        for trial in range(n_trials + 1):
            torch.cuda.synchronize()
            dist.barrier()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(rounds):
                fn()
            end.record()
            end.synchronize()
            if trial:
                out.append([start.elapsed_time(end) / rounds,
                            (time.perf_counter() - t0) * 1e3 / rounds])
        return {"ms": sum(o[0] for o in out) / len(out),
                "host_ms": sum(o[1] for o in out) / len(out), "runs": out}

    res["rounds"] = {}
    for kind in SYNC_ROUNDS:
        fn = events_round if kind == "events" else round_of(kind)
        res["rounds"][str(kind)] = timed_rounds(fn)

    # K2 and K3 under each variant, on groups of their own
    vgroup = _pair_groups(fgrid, fgrid.axis_names[0])
    hgroup = _pair_groups(hgrid, hgrid.axis_names[0])
    P, gme = dist.get_world_size(vgroup), dist.get_rank(vgroup)
    members = dist.get_process_group_ranks(vgroup)
    shape = fgrid.buffer_shape(0)
    bb = math.prod(shape) * 8 // P
    he = (width,) * 3
    hshape = hgrid.buffer_shape(0, he)
    m = hshape[1] - 2 * width
    hplans = [peer_kernels.halo_plan(hshape, 4, 1, width, m, (N // 2,) * 2,
                                     r, True) for r in range(P)]
    aplans = [peer_kernels.a2a_plan(P, r, bb) for r in range(P)]
    need = 2 * max(aplans[0].recv_bytes, hplans[0].recv_bytes)
    vws = symmetric.workspace(vgroup, dev, need)
    hws = symmetric.workspace(hgroup, dev, need)
    gpeers = [p for p in range(P) if p != gme]
    cg = (ctypes.c_int * len(gpeers))(*gpeers)

    def prepared(plan, ws_, *tensors):
        tables = peer_kernels.move_tables(plan, gme, dev)
        wb = peer_kernels.word_bytes(plan, *(t.data_ptr() for t in tensors))
        mw = max(mv.rows * mv.row_bytes for mv in plan.puts + plan.unpacks)
        return tables, wb, mw // wb

    def variant_call(v, plan, ws_, src, dst, what):
        tables, wb, mw = prepared(plan, ws_, src, dst)
        half = ws_.recv_bytes // 2

        def go():
            _sync_check(lib.ps_exchange(
                v, src.data_ptr(), dst.data_ptr(), ws_.bases_dev.data_ptr(),
                ws_.bases_host, gme, cg, len(gpeers), ws_.next_exchange(),
                tables[0].data_ptr(), len(plan.puts), tables[1].data_ptr(),
                len(plan.unpacks), mw, wb, half, stream(),
                ctypes.byref(kernels), ctypes.byref(memops)),
                f"{what} variant {v}")
        return go

    def settle():
        torch.cuda.synchronize()
        dist.barrier()

    # bit for bit against the plain executor, every member's data made
    # from its world rank's seed
    def seeded(w, shp, dtype):
        g = torch.Generator(device=dev)
        g.manual_seed(1000 + w)
        return torch.randn(shp, generator=g, device=dev, dtype=dtype)

    hmembers = dist.get_process_group_ranks(hgroup)
    res["launches"], res["err"] = {}, {}
    blocks = seeded(me, shape, torch.complex64).view(P, -1)
    srcs = [seeded(w, shape, torch.complex64).view(P, -1) for w in members]
    want = peer_kernels.apply_plans(aplans, srcs,
                                    [torch.empty_like(s) for s in srcs])[gme]
    del srcs
    hb = [seeded(w, hshape, torch.float32) for w in hmembers]
    hwant = peer_kernels.apply_plans(hplans, hb, hb)[gme]
    for v in SYNC_VARIANTS:
        out = torch.empty_like(blocks)
        settle()
        variant_call(v, aplans[gme], vws, blocks, out, "K2")()
        k = (kernels.value, memops.value)
        buf = seeded(me, hshape, torch.float32)
        settle()
        variant_call(v, hplans[gme], hws, buf, buf, "K3")()
        settle()
        res["launches"][str(v)] = {"K2": k, "K3": (kernels.value,
                                                   memops.value)}
        res["err"][str(v)] = [float((out - want).abs().max()),
                              float((buf - hwant).abs().max()),
                              torch.equal(out, want),
                              torch.equal(buf, hwant)]
    del hb, want, hwant
    torch.cuda.empty_cache()

    # what torch.profiler records of one exchange: the library's, and
    # variant 2's
    pr = fgrid.group(fgrid.axis_names[0])
    peer_kernels.a2a(blocks, pr)  # its workspace, outside the profile
    settle()
    res["profile_lib"] = _profile_keys(lambda: peer_kernels.a2a(blocks, pr))
    out = torch.empty_like(blocks)
    settle()
    res["profile_v2"] = _profile_keys(
        variant_call(2, aplans[gme], vws, blocks, out, "K2"))

    # the times, in turns: each variant, then the library
    buf = seeded(me, hshape, torch.float32)
    k2 = {str(v): variant_call(v, aplans[gme], vws, blocks, out, "K2")
          for v in SYNC_VARIANTS}
    k2["lib"] = lambda: peer_kernels.a2a(blocks, pr)
    hpr = hgrid.group(hgrid.axis_names[0])
    k3 = {str(v): variant_call(v, hplans[gme], hws, buf, buf, "K3")
          for v in SYNC_VARIANTS}
    k3["lib"] = lambda: peer_kernels.halo_exchange(
        buf, hpr, 1, width, m, (N // 2,) * 2, True)

    def t(fn):
        settle()
        times = time_fn(fn, n_warmup=1, n_trials=n_trials, iters=iters,
                        device=dev)
        return sum(times) / len(times) * 1e3

    for what, calls in (("k2", k2), ("k3", k3)):
        names = list(calls)
        runs = {n: [] for n in names}
        for n in names + names[::-1]:
            runs[n].append(t(calls[n]))
        res[what] = runs
    settle()
    return res


def peer_sync_worker(rank: int, out_dir: str, kw: dict) -> None:
    """One rank of :func:`peer_sync` (a ``card_ranks_worker`` body)."""
    res = peer_sync_rank(**kw)
    if rank == 0:
        res["mps"] = mps_active()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))


def peer_sync(source, N: int = 512, ranks: int = 4, rounds: int = 200,
              timeout: float = 600) -> dict:
    """The synchronisation of K2 and K3 weighed on ``ranks`` processes that
    share this card: builds ``source`` (``tools/peer_sync_variants.cu``)
    and runs :func:`peer_sync_rank` in every rank.  Returns each rank's
    results and, per round kind and per K2/K3 variant, the slowest rank's
    mean ms."""
    from cudecomp_tpu_torch.ops import cuda_kernels
    from cudecomp_tpu_torch.utils.testing import run_card_ranks
    _need_cuda()
    peer_kernels.build()  # and K1, for the round trip: once, here
    cuda_kernels.build()
    with tempfile.TemporaryDirectory() as tmp:
        lib = build_sync_variants(source, tmp)
        run_card_ranks(peer_sync_worker, ranks, str(Path(tmp, "pg")),
                       (tmp, dict(lib_path=str(lib), N=N, rounds=rounds)),
                       timeout, "the exchange synchronisation variants")
        per_rank = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                    for r in range(ranks)]
    trips = [r["roundtrip"] for r in per_rank]
    ops = {}
    for t in trips:
        for k, v in t["ops"].items():
            ops[k] = ops.get(k, 0.0) + v
    busy = sum(ops.values())
    window = max(t["window_ms"] for t in trips)
    roundtrip = {"window_ms": window, "busy_ms": busy,
                 "comm_ms": sum(t["comm_ms"] for t in trips),
                 "idle_share": 1 - busy / window,
                 "lost": sum(t["lost"] for t in trips),
                 "ops": dict(sorted(ops.items(), key=lambda kv: -kv[1]))}
    slowest = {
        "roundtrip": roundtrip,
        "rounds_ms": {k: max(r["rounds"][k]["ms"] for r in per_rank)
                      for k in per_rank[0]["rounds"]},
        "rounds_host_ms": {k: max(r["rounds"][k]["host_ms"]
                                  for r in per_rank)
                           for k in per_rank[0]["rounds"]},
        **{f"{w}_ms": {k: max(sum(r[w][k]) / len(r[w][k]) for r in per_rank)
                       for k in per_rank[0][w]} for w in ("k2", "k3")}}
    return {"slowest": slowest, "mps": per_rank[0]["mps"],
            "ranks": per_rank, "device": torch.cuda.get_device_name(0)}

if __name__ == "__main__":
    kw = {}
    if len(sys.argv) > 1:
        kw["N"] = int(sys.argv[1])
    if len(sys.argv) > 2:
        kw["iters"] = int(sys.argv[2])
    main(**kw)
