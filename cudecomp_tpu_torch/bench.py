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


def max_abs_err(a: torch.Tensor, b: torch.Tensor,
                chunk_bytes: int = 1 << 28) -> float:
    """max |a - b|, over slabs of dim 0 of about ``chunk_bytes`` each, so
    that no full-size difference is ever allocated (a 1024^3 c64 field is
    8 GiB)."""
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    if a.dim() == 0:
        a, b = a.reshape(1), b.reshape(1)
    step = max(chunk_bytes // max(a[0:1].numel() * a.element_size(), 1), 1)
    return max((float((a[i:i + step] - b[i:i + step]).abs().max())
                for i in range(0, a.shape[0], step)), default=0.0)


def _gate(err: float, what: str) -> None:
    if not err < GATE:
        raise RuntimeError(f"{what}: max abs err {err} is not < {GATE}")


def c2c_headline(N: int = 512, iters: int = 20, n_trials: int = 3,
                 axis_contiguous: bool = True, device="cuda") -> dict:
    """Time the N^3 c2c round trip on ``device`` (the GPU unless the
    caller asks for the CPU); returns the result."""
    _need_cuda(device)
    plan = make_plan(N, axis_contiguous, device)
    x = make_field(plan.grid, seed=0)
    err = max_abs_err(cycle(plan, x), x)
    _gate(err, "gate round trip")

    last = {}

    def timed():
        last["y"] = cycle(plan, x)

    times = time_fn(timed, n_warmup=2, n_trials=n_trials, iters=iters,
                    device=plan.grid.device)
    timed_err = max_abs_err(last["y"], x)
    _gate(timed_err, "timed round trip")

    # all the work over the whole timed window; the trials show the spread
    t = sum(times) / len(times) / 2.0  # one direction
    return {
        "metric": f"{N}^3 c2c FFT single-direction (complex64, pdims (1, 1), "
                  f"{'axis-contiguous' if axis_contiguous else 'natural'})",
        "value": fft_gflops(N ** 3, t),
        "unit": "GFLOPS",
        "ms_per_direction": t * 1e3,
        "round_trip_ms_trials": [s * 1e3 for s in times],
        "gate_err": err,
        "timed_err": timed_err,
        "device": device_name(plan.grid.device),
    }


def fft_gflops(n_total: int, t: float) -> float:
    """The reference's FFT rate, 5 n log2(n) / t, with ``n`` the points of
    the (real or complex) grid and ``t`` seconds per direction
    (``benchmark.cu:658``)."""
    return 5.0 * n_total * math.log2(n_total) / t / 1e9


def main(N: int = 512, iters: int = 20, n_trials: int = 3,
         axis_contiguous: bool = True) -> dict:
    """Time the N^3 c2c round trip on the current GPU; returns and prints
    the result."""
    payload = c2c_headline(N, iters, n_trials, axis_contiguous)
    print(json.dumps(payload))
    return payload


def _need_cuda(device="cuda") -> None:
    """Raise unless ``device`` is the CPU, which only a caller that asks
    for it gets, or CUDA is available: no headline falls back to the
    CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the benchmark measures the GPU and needs CUDA")


def device_name(device) -> str:
    """The CUDA device's name, or the device type of any other."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


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
                     dt: float = 0.1, device="cuda") -> dict:
    """ms per fused diffusion step ``u + dt * lap(u)`` (periodic, f32) and
    its rate, one read plus one write of the field."""
    _need_cuda(device)
    grid = _cube_grid(N, device)
    x = make_field(grid, seed=2, dtype=torch.float32)
    times = time_fn(lambda: diffusion_step(grid, x, dt, 0, (True,) * 3),
                    n_warmup=2, n_trials=n_trials, iters=iters,
                    device=grid.device)
    t = sum(times) / len(times)
    return {"metric": f"{N}^3 f32 fused diffusion step (ghost-plane "
                      f"stencil, pdims (1, 1))",
            "value": t * 1e3, "unit": "ms",
            "gbps": 2 * x.numel() * x.element_size() / t / 1e9,
            "trials_ms": [s * 1e3 for s in times],
            "device": device_name(grid.device)}


def halo_headline(N: int = 512, width: int = 1, iters: int = 20,
                  n_trials: int = 3, device="cuda") -> dict:
    """ms per halo update of the X-pencil with ``width`` halos on every
    dim, periodic (f32), and its rate over the slabs it moves."""
    _need_cuda(device)
    grid = _cube_grid(N, device)
    he = (width, width, width)
    gen = torch.Generator(device=grid.device)
    gen.manual_seed(4)
    x = torch.randn(grid.buffer_shape(0, he), generator=gen,
                    device=grid.device)
    times = time_fn(lambda: update_halos(grid, x, 0, he, (True,) * 3),
                    n_warmup=2, n_trials=n_trials, iters=iters,
                    device=grid.device)
    t = sum(times) / len(times)
    return {"metric": f"{N}^3 f32 halo update (x-pencil, width {width}, "
                      f"periodic, pdims (1, 1))",
            "value": t * 1e3, "unit": "ms",
            "gbps": halo_bytes(grid, 0, he, x.element_size()) / t / 1e9,
            "trials_ms": [s * 1e3 for s in times],
            "device": device_name(grid.device)}


def cg_headline(N: int = 256, tol: float = 1e-5,
                maxiter: int = 2000, device="cuda") -> dict:
    """The CG Poisson solve of a standard-normal f32 rhs: total ms (after
    one untimed solve), iterations, ms per iteration, and the residual."""
    _need_cuda(device)
    solver = PoissonSolver(grid=_cube_grid(N, device))
    f = make_field(solver.grid, seed=3, dtype=torch.float32)
    last = {}

    def solve():
        last["out"] = solver.solve_cg(f, tol=tol, maxiter=maxiter)

    (t,) = time_fn(solve, n_warmup=1, n_trials=1, device=solver.grid.device)
    _, iters, rel = last["out"]
    return {"metric": f"{N}^3 f32 Poisson CG solve (K4 matvec, tol {tol:g}, "
                      f"pdims (1, 1))",
            "value": t * 1e3, "unit": "ms", "iters": int(iters),
            "rel_residual": float(rel),
            "ms_per_iter": t * 1e3 / max(int(iters), 1),
            "device": device_name(solver.grid.device)}



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
    """One rank of :func:`peer_headline` (a ``run_card_ranks`` body):
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


if __name__ == "__main__":
    kw = {}
    if len(sys.argv) > 1:
        kw["N"] = int(sys.argv[1])
    if len(sys.argv) > 2:
        kw["iters"] = int(sys.argv[2])
    main(**kw)
