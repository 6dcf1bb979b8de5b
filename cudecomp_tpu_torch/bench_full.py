"""The bench table: the JAX package's ``bench_full.py`` headlines on one
NVIDIA GPU.

Prints one JSON object per line as each headline finishes, in the order
of the JAX table (``bench_full.py:345-453``):

  * the c2c FFT at 256^3 and 512^3, axis-contiguous, and at 512^3 in the
    natural layout (:func:`bench.c2c_headline`);
  * the r2c FFT at 512^3 (:func:`fft_r2c`);
  * the 512^3 f32 transpose round trip (:func:`transpose_headline`);
  * the 512^3 width-1 halo update, the 512^3 diffusion step and the 256^3
    CG solve (``bench.halo_headline``, ``stencil_headline``,
    ``cg_headline``);
  * with ``large``: the c2c FFT at 768^3, 1024 x 512 x 512 and 1024^3
    (:func:`fft_headline_large`), the r2c FFT at 768^3 and the f32
    transpose round trip at 768^3 and 1024^3
    (:func:`transpose_headline_large`).

Every FFT round trip is gated at the reference's single-precision
tolerance, max abs error < 5e-4 (``benchmark.cu:23-27``): the first round
trip, and again the output of the timed run.  Every transpose round trip
must give its input back bit for bit.  A headline that fails its gate, runs
out of memory or fails to launch raises: none is skipped, none falls back
to a smaller size, and none runs on the CPU unless the caller asks for it.

Times are CUDA-event times (``performance.time_fn``), ``iters`` calls per
trial, the mean over the trials as in ``bench.main``.  Every record
carries ``device``, the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit`` gives them, and
``max_memory_allocated_gib``, the peak of ``torch.cuda.
max_memory_allocated`` over the headline.  The record keys of the JAX
table are kept, so that one reader reads both; ``BENCH_FULL.json`` keeps
the TPU table and is never written here.

Run: ``python -m cudecomp_tpu_torch.bench_full [--out PATH] [--no-large]``
(``CUDECOMP_TPU_BENCH_LARGE=0`` is the default of ``--no-large``).
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys

import torch

from cudecomp_tpu_torch import bench
from cudecomp_tpu_torch.bench import (_gate, _need_cuda, device_name,
                                      fft_gflops, make_field, max_abs_err)
from cudecomp_tpu_torch.config import GridConfig
from cudecomp_tpu_torch.geometry import squarest_pdims
from cudecomp_tpu_torch.grid import make_grid
from cudecomp_tpu_torch.ops import transpose as tr
from cudecomp_tpu_torch.ops.fft import DistributedFFT
from cudecomp_tpu_torch.performance import segment_roundtrip, time_fn

GIB = float(1 << 30)


def default_pdims(world: int):
    """Squarest factor pair (pr, pc) of the world size."""
    return squarest_pdims(world)


def world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def _world_max(v: float) -> float:
    """The largest ``v`` over the ranks (collective where a world is
    initialized)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return v
    t = torch.tensor([v], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def _planes_err(a, b) -> float:
    return max(max_abs_err(a[0], b[0]), max_abs_err(a[1], b[1]))


def transpose_local_gbps(N: int, itemsize: int, world: int,
                         local_ms: float) -> float:
    """The round trip's local rate per rank: each of the 4 transposes
    reads and writes the rank's N^3 / world share once
    (``bench_full.py:103,111-112``)."""
    return 2 * (4 * N ** 3 * itemsize / world) / (local_ms / 1e3) / 1e9


def _roundtrip(grid, a):
    b = tr.transpose_x_to_y(grid, a)
    b = tr.transpose_y_to_z(grid, b)
    b = tr.transpose_z_to_y(grid, b)
    return tr.transpose_y_to_x(grid, b)


def _check_exact(grid, got, want, what: str) -> None:
    """Raise unless every rank got ``want`` back bit for bit."""
    if _world_max(0.0 if torch.equal(got, want) else 1.0):
        raise RuntimeError(f"{what}: the transpose round trip did not give "
                           f"its input back bit for bit")


def _clone_ms(x: torch.Tensor, iters: int, n_trials: int) -> float:
    """ms per ``clone()`` of ``x``: the copy's rate on the same bytes."""
    times = time_fn(x.clone, n_warmup=2, n_trials=n_trials, iters=iters,
                    device=x.device)
    return sum(times) / len(times) * 1e3


def fft_r2c(N: int = 512, iters: int = 20, n_trials: int = 3,
            device="cuda") -> dict:
    """GFLOPS per direction of the N^3 r2c round trip of a split-complex
    plan (``forward_planes`` then ``inverse_planes``), axis-contiguous, at
    ``default_pdims(world)``; the rate's n is the real grid's N^3
    (``benchmark.cu:658``)."""
    _need_cuda(device)
    pdims = default_pdims(world_size())
    grid = make_grid(GridConfig(gdims=(N, N, N), pdims=pdims,
                                transpose_axis_contiguous=(True,) * 3),
                     device)
    plan = DistributedFFT(grid=grid, real=True, split_complex=True)
    x = make_field(grid, seed=1, dtype=torch.float32)

    def cycle(v):
        return plan.inverse_planes(plan.forward_planes(v))

    err = _world_max(max_abs_err(cycle(x), x))
    _gate(err, f"{N}^3 r2c gate round trip")
    last = {}

    def timed():
        last["y"] = cycle(x)

    times = time_fn(timed, n_warmup=2, n_trials=n_trials, iters=iters,
                    device=grid.device)
    timed_err = _world_max(max_abs_err(last["y"], x))
    _gate(timed_err, f"{N}^3 r2c timed round trip")
    t = _world_max(sum(times) / len(times)) / 2.0
    return {"metric": f"{N}^3 r2c FFT single-direction (split-complex, "
                      f"pdims {pdims}, axis-contiguous, gate-checked err "
                      f"{err:.1e})",
            "value": fft_gflops(N ** 3, t), "unit": "GFLOPS", "err": err,
            "timed_err": timed_err, "ms_per_direction": t * 1e3,
            "round_trip_ms_trials": [s * 1e3 for s in times]}


def _transpose_record(N: int, world: int, total_ms: float, a2a_ms: float,
                      local_ms: float, a2a_gbps, clone_ms: float,
                      how: str) -> dict:
    nbytes = 4 * N ** 3 / world  # one f32 field, this rank's share
    return {"metric": f"{N}^3 f32 transpose round-trip (X2Y;Y2Z;Z2Y;Y2X, "
                      f"{world} rank{'s' if world > 1 else ''}, "
                      f"axis-contiguous{how})",
            "value": total_ms, "unit": "ms", "a2a_ms": a2a_ms,
            "local_ms": local_ms,
            "a2a_gbps_per_chip": a2a_gbps if a2a_ms > 0 else None,
            "local_gbps_per_chip": (transpose_local_gbps(N, 4, world,
                                                         local_ms)
                                    if local_ms > 0 else None),
            "clone_ms": clone_ms,
            "clone_gbps": 2 * nbytes / (clone_ms / 1e3) / 1e9}


def transpose_headline(N: int = 512, n_trials: int = 3, iters: int = 20,
                       device="cuda") -> dict:
    """``segment_roundtrip`` of the N^3 f32 axis-contiguous grid at
    ``default_pdims(world)``: total, exchange and local ms, the exchange's
    and the local GB/s per rank; ``clone()`` of the rank's field beside
    them.  One round trip of a seeded field must give it back."""
    _need_cuda(device)
    world = world_size()
    grid = make_grid(GridConfig(gdims=(N, N, N), pdims=default_pdims(world),
                                transpose_axis_contiguous=(True,) * 3),
                     device)
    x = make_field(grid, seed=6, dtype=torch.float32)
    _check_exact(grid, _roundtrip(grid, x), x, f"{N}^3 transpose")
    seg = segment_roundtrip(grid, torch.float32, iters=iters, n_warmup=2,
                            n_trials=n_trials, record=False)
    return _transpose_record(N, world, seg["total_ms"], seg["a2a_ms"],
                             seg["local_ms"], seg["a2a_gbps"],
                             _clone_ms(x, iters, n_trials), "")


def make_planes(grid, seed: int = 1):
    """Standard-normal real and imaginary planes in the grid's X-pencil
    layout, from a seeded generator on the grid's device."""
    gen = torch.Generator(device=grid.device)
    gen.manual_seed(seed)
    shape = grid.buffer_shape(0)
    return tuple(torch.randn(shape, generator=gen, device=grid.device)
                 for _ in range(2))


def planes_cycle(plan: DistributedFFT, planes):
    """One plane-carried c2c round trip."""
    return plan.inverse_planes(plan.forward_planes(planes))


def large_plan(gdims, axis_contiguous: bool = True,
               device="cuda") -> DistributedFFT:
    """The split-complex c2c plan of a ``gdims`` grid on one rank."""
    ac = bool(axis_contiguous)
    grid = make_grid(GridConfig(gdims=tuple(gdims), pdims=(1, 1),
                                transpose_axis_contiguous=(ac, ac, ac)),
                     device)
    return DistributedFFT(grid=grid, split_complex=True)


def fft_headline_large(gdims, iters: int = 20, n_trials: int = 3,
                       axis_contiguous: bool = True, device="cuda") -> dict:
    """GFLOPS per direction of the plane-carried c2c round trip of a
    ``gdims`` grid at pdims (1, 1), the planes made on the device.  The
    first round trip is gated; then each timed call is a chain of
    ``iters`` round trips from the field, each taking the last one's
    output (the JAX headline's scan), and the last chain's end is gated
    against the field."""
    _need_cuda(device)
    plan = large_plan(gdims, axis_contiguous, device)
    planes = make_planes(plan.grid, seed=1)
    name = "x".join(map(str, gdims))
    err = _planes_err(planes_cycle(plan, planes), planes)
    _gate(err, f"{name} c2c gate round trip")
    last = {}

    def chain():
        p = planes
        for _ in range(iters):
            p = planes_cycle(plan, p)
        last["p"] = p

    times = time_fn(chain, n_warmup=1, n_trials=n_trials,
                    device=plan.grid.device)
    timed_err = _planes_err(last.pop("p"), planes)
    _gate(timed_err, f"{name} c2c timed chain of {iters} round trips")
    t = sum(times) / len(times) / iters / 2.0
    layout = "axis-contiguous" if axis_contiguous else "natural"
    return {"metric": f"{name} c2c FFT single-direction (split-complex, "
                      f"plane-carried, pdims (1, 1), {layout}, gate-checked "
                      f"err {err:.1e})",
            "value": fft_gflops(math.prod(gdims), t), "unit": "GFLOPS",
            "err": err, "timed_err": timed_err, "ms_per_direction": t * 1e3,
            "round_trip_ms_trials": [s * 1e3 / iters for s in times]}


def transpose_headline_large(N: int, n_trials: int = 3, iters: int = 20,
                             device="cuda") -> dict:
    """ms of the chained 4-transpose round trip of an N^3 f32
    axis-contiguous field made on the device, at pdims (1, 1); the
    chain's end must be the field, bit for bit."""
    _need_cuda(device)
    grid = make_grid(GridConfig(gdims=(N, N, N), pdims=(1, 1),
                                transpose_axis_contiguous=(True,) * 3),
                     device)
    x = make_field(grid, seed=0, dtype=torch.float32)
    state = {"v": x}

    def chained():
        state["v"] = _roundtrip(grid, state["v"])

    times = time_fn(chained, n_warmup=2, n_trials=n_trials, iters=iters,
                    device=grid.device)
    _check_exact(grid, state["v"], x, f"{N}^3 transpose chain")
    del state
    t_ms = sum(times) / len(times) * 1e3
    return _transpose_record(N, 1, t_ms, 0.0, t_ms, None,
                             _clone_ms(x, iters, n_trials),
                             ", field made on the device")


def table(large: bool):
    """The headlines in the JAX table's order: ``[(function, kwargs)]``."""
    cells = [(bench.c2c_headline, {"N": 256}),
             (bench.c2c_headline, {"N": 512}),
             (bench.c2c_headline, {"N": 512, "axis_contiguous": False}),
             (fft_r2c, {"N": 512}),
             (transpose_headline, {"N": 512}),
             (bench.halo_headline, {"N": 512, "width": 1}),
             (bench.stencil_headline, {"N": 512}),
             (bench.cg_headline, {"N": 256})]
    if large:
        cells += [(fft_headline_large, {"gdims": (768, 768, 768)}),
                  (fft_headline_large, {"gdims": (1024, 512, 512)}),
                  (fft_headline_large, {"gdims": (1024, 1024, 1024)}),
                  (fft_r2c, {"N": 768}),
                  (transpose_headline_large, {"N": 768}),
                  (transpose_headline_large, {"N": 1024})]
    return cells


def main(out=None, large=None, device="cuda") -> list:
    """Run :func:`table` on ``device``, printing each record as one JSON
    line as it finishes; write the list to ``out`` when a path is given.
    ``large`` defaults to ``CUDECOMP_TPU_BENCH_LARGE`` (on unless "0")."""
    _need_cuda(device)
    if large is None:
        large = os.environ.get("CUDECOMP_TPU_BENCH_LARGE", "1") != "0"
    cuda = torch.device(device).type == "cuda"
    card = bench._smi("name,power.limit").splitlines()[0] if cuda else (
        device_name(device))
    results = []
    for fn, kw in table(large):
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        r = fn(**kw, device=device)
        r["device"] = card
        r["max_memory_allocated_gib"] = (
            torch.cuda.max_memory_allocated() / GIB if cuda else None)
        print(json.dumps(r), flush=True)
        results.append(r)
    if out is not None:
        with open(out, "w") as fh:
            json.dump(results, fh, indent=2)
    return results


def _args(argv):
    ap = argparse.ArgumentParser(
        prog="python -m cudecomp_tpu_torch.bench_full",
        description="The bench table on one GPU: one JSON line per "
                    "headline.")
    ap.add_argument("--out", help="also write the records to this file")
    ap.add_argument("--no-large", dest="large", action="store_false",
                    default=None, help="skip the 768^3 and 1024-class cells")
    return ap.parse_args(argv)


if __name__ == "__main__":
    a = _args(sys.argv[1:])
    main(out=a.out, large=a.large)
