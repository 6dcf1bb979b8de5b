#!/usr/bin/env python3
"""Smoke run of cudecomp_tpu_torch on one NVIDIA GPU: the quickest proof
that the port builds, is right and starts on the card.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the K1 local-permute kernel from the checkout's sources;
  3. K1 against its plain twin, bit for bit: bf16/f32/f64/c64/c128, both
     cyclic perms, ragged and degenerate shapes, and the 512^3 c64 shapes
     of the main path;
  4. the main path: the 512^3 complex64 distributed FFT on a pdims (1, 1)
     axis-contiguous grid through the public entry points.  The forward
     spectrum is held to torch.fft.fftn of the same global field (relative
     L2 error <= 1e-5), the round trip to max abs error < 5e-4, and the
     round trip must launch K1 exactly 4 times; an r2c round trip at 512^3
     must pass the same 5e-4 gate;
  5. timing: the benchmark's round trip (ms per direction, GFLOPS), K1's
     bandwidth beside clone() and the plain twin on the same bytes, and a
     torch.profiler breakdown of one round trip by kernel with the card's
     idle share.

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.  Exits nonzero, printing neither,
when CUDA is not available or the package is missing.
"""

import json
import subprocess
import sys
import time
from statistics import mean

RTOL_FFT = 1e-5      # relative L2 error of the c64 forward spectrum
GATE = 5e-4          # round-trip max abs error (benchmark.cu:23-27)
N = 512
DEVICE = "cuda"


def card_line() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernel_checks(torch, K, gen):
    """Phase 3: K1 vs its twin on every dtype and shape class; returns the
    largest absolute difference seen (0.0 when all are bit-equal)."""
    dev = DEVICE

    def field(shape, dtype):
        if dtype.is_complex:
            parts = torch.randn(tuple(shape) + (2,), generator=gen,
                                device=dev, dtype=dtype.to_real())
            return torch.view_as_complex(parts)
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    def compare(got, want, what):
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"K1 differs from its twin: {what}")
        return float((got - want).abs().max()) if got.numel() else 0.0

    worst = 0.0
    dtypes = (torch.bfloat16, torch.float32, torch.float64, torch.complex64,
              torch.complex128)
    for dtype in dtypes:
        for shape in ((7, 33, 65), (1, 17, 9), (16, 1, 3), (5, 4, 1),
                      (64, 32, 96)):
            x = field(shape, dtype)
            for perm in K.CYCLIC_PERMS:
                worst = max(worst, compare(K.cyclic_permute(x, perm),
                                           K.cyclic_permute_ref(x, perm),
                                           f"{dtype} {shape} {perm}"))
        for shape in ((1, 1000), (1000, 1), (33, 65), (64, 4096)):
            x = field(shape, dtype)
            worst = max(worst, compare(K.transpose2d(x), K.transpose2d_ref(x),
                                       f"transpose2d {dtype} {shape}"))
    # trailing component dims travel with the element: 8 and 16 bytes in
    # one word; 6, 12 and 48 bytes (3 components) in several
    for dtype, comp in ((torch.float32, 2), (torch.float64, 2),
                        (torch.bfloat16, 3), (torch.float32, 3),
                        (torch.complex128, 3)):
        x = field((9, 10, 11, comp), dtype)
        for perm in K.CYCLIC_PERMS:
            worst = max(worst, compare(K.cyclic_permute(x, perm),
                                       K.cyclic_permute_ref(x, perm),
                                       f"{comp} x {dtype} {perm}"))
    # 8-byte elements at an address 4 bytes off: two 4-byte words
    x = field((1 + 9 * 10 * 11 * 2,), torch.float32)[1:].view(9, 10, 11, 2)
    for perm in K.CYCLIC_PERMS:
        worst = max(worst, compare(K.cyclic_permute(x, perm),
                                   K.cyclic_permute_ref(x, perm),
                                   f"offset view {perm}"))
    # the main path's shapes: 512^3 c64, and the r2c spectrum's 512x512x257
    for shape in ((N, N, N), (N, N, N // 2 + 1)):
        x = field(shape, torch.complex64)
        for perm in K.CYCLIC_PERMS:
            worst = max(worst, compare(K.cyclic_permute(x, perm),
                                       K.cyclic_permute_ref(x, perm),
                                       f"c64 {shape} {perm}"))
        del x
    torch.cuda.synchronize()
    return worst


def main_path(torch, ct, K, bench):
    """Phase 4: the 512^3 round trips through the public entry points."""
    plan = bench.make_plan(N, axis_contiguous=True, device=DEVICE)
    grid = plan.grid
    x = bench.make_field(grid, seed=1)

    K.reset_launch_count()
    xh = plan.forward(x)
    back = plan.inverse(xh)
    torch.cuda.synchronize()
    launches = K.launch_count

    if launches != 4:
        raise AssertionError(f"c2c round trip launched K1 {launches} times, "
                             f"expected 4")
    if tuple(xh.shape) != grid.buffer_shape(2) or xh.dtype != torch.complex64:
        raise AssertionError(f"spectrum has shape {tuple(xh.shape)} "
                             f"{xh.dtype}")
    if not bool(torch.isfinite(torch.view_as_real(xh)).all()):
        raise AssertionError("spectrum holds non-finite values")
    # plain reference: fftn of the same global field, in Z-pencil layout
    cfg = grid.config
    ref = torch.fft.fftn(x.permute(cfg.inv_mem_order(0)))
    ref = ref.permute(cfg.mem_order(2))
    rel = float(torch.linalg.vector_norm(xh - ref)
                / torch.linalg.vector_norm(ref))
    del ref
    if not rel <= RTOL_FFT:
        raise AssertionError(f"forward spectrum rel L2 err {rel} > {RTOL_FFT}")
    c2c_err = bench.max_abs_err(back, x)
    if not c2c_err < GATE:
        raise AssertionError(f"c2c round trip max abs err {c2c_err}")
    del x, xh, back

    rplan = bench.make_plan(N, axis_contiguous=True, device=DEVICE, real=True)
    xr = bench.make_field(rplan.grid, seed=2, dtype=torch.float32)
    K.reset_launch_count()
    rh = rplan.forward(xr)
    rback = rplan.inverse(rh)
    torch.cuda.synchronize()
    r2c_launches = K.launch_count
    if r2c_launches != 4:
        raise AssertionError(f"r2c round trip launched K1 {r2c_launches} "
                             f"times, expected 4")
    if tuple(rh.shape) != rplan.complex_grid.buffer_shape(2):
        raise AssertionError(f"r2c spectrum has shape {tuple(rh.shape)}")
    r2c_err = bench.max_abs_err(rback, xr)
    if not r2c_err < GATE:
        raise AssertionError(f"r2c round trip max abs err {r2c_err}")
    return dict(launches=launches, rel_l2=rel, c2c_err=c2c_err,
                r2c_err=r2c_err, r2c_launches=r2c_launches)


def kernel_timing(torch, K, perf, gen):
    """Phase 5b: K1, its twin and clone() on the 512^3 c64 shapes; ms per
    call (mean over trials) and GB/s of one read plus one write."""
    parts = torch.randn((N, N, N, 2), generator=gen, device=DEVICE)
    x = torch.view_as_complex(parts)
    nbytes = 2 * x.numel() * x.element_size()
    out = {}
    for perm in K.CYCLIC_PERMS:
        # plain, kernel, kernel, plain: drift shows as disagreeing pairs
        rows = [("plain", lambda: K.cyclic_permute_ref(x, perm)),
                ("kernel", lambda: K.cyclic_permute(x, perm)),
                ("kernel", lambda: K.cyclic_permute(x, perm)),
                ("plain", lambda: K.cyclic_permute_ref(x, perm))]
        got = {"plain": [], "kernel": []}
        for name, fn in rows:
            got[name].append(mean(perf.time_fn(fn, n_warmup=2, n_trials=5,
                                               iters=10)))
        out[perm] = {k: mean(v) * 1e3 for k, v in got.items()}
        out[perm]["runs_ms"] = {k: [t * 1e3 for t in v]
                                for k, v in got.items()}
    clone_ms = mean(perf.time_fn(x.clone, n_warmup=2, n_trials=5,
                                 iters=10)) * 1e3
    return out, clone_ms, nbytes


def profile_round_trips(torch, bench, reps=3):
    """Phase 5c: device time by kernel over ``reps`` c2c round trips, and
    the window those round trips took on the card (CUDA events)."""
    from torch.profiler import ProfilerActivity, profile
    plan = bench.make_plan(N, axis_contiguous=True, device=DEVICE)
    x = bench.make_field(plan.grid, seed=3)
    bench.cycle(plan, x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(reps):
            bench.cycle(plan, x)
        end.record()
        end.synchronize()
    window_ms = start.elapsed_time(end) / reps
    by_name = {}
    for e in prof.key_averages():
        # device events: the kernels, plus the GPU side of the package's
        # own trace ranges, which would count their kernels twice
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.key.startswith("cudecomp_tpu_torch.")):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3 / reps
    return window_ms, by_name


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run",
              file=sys.stderr)
        return 1
    import cudecomp_tpu_torch as ct
    from cudecomp_tpu_torch import bench, performance as perf
    from cudecomp_tpu_torch.ops import cuda_kernels as K

    # phase 1: the card
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")

    # phase 2: build K1
    t0 = time.perf_counter()
    lib = K.build()
    print(f"K1 built in {time.perf_counter() - t0:.1f} s: {lib.name}")

    # phase 3: K1 vs twin
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    worst = kernel_checks(torch, K, gen)
    print(f"K1 bit-equal to its twin on every dtype and shape "
          f"(max abs diff {worst})")

    # phase 4: the main path
    mp = main_path(torch, ct, K, bench)
    print(f"512^3 c64 axis-contiguous pdims (1, 1): forward rel L2 err vs "
          f"torch.fft.fftn {mp['rel_l2']:.3e} (<= {RTOL_FFT}); c2c round "
          f"trip max abs err {mp['c2c_err']:.3e}, r2c {mp['r2c_err']:.3e} "
          f"(< {GATE}); K1 launches per round trip: c2c {mp['launches']}, "
          f"r2c {mp['r2c_launches']}")

    # phase 5: timing
    torch.cuda.empty_cache()
    payload = bench.main(N=N, iters=20, n_trials=3, axis_contiguous=True)
    perm_t, clone_ms, nbytes = kernel_timing(torch, K, perf, gen)

    def gbs(ms):
        return nbytes / (ms * 1e-3) / 1e9

    print(f"[{card}] 512^3 c64 c2c round trip: "
          f"{payload['ms_per_direction']:.3f} ms per direction, "
          f"{payload['value']:.1f} GFLOPS")
    for perm, t in perm_t.items():
        print(f"[{card}] K1 cyclic_permute {perm} 512^3 c64: kernel "
              f"{t['kernel']:.3f} ms = {gbs(t['kernel']):.0f} GB/s; twin "
              f"{t['plain']:.3f} ms = {gbs(t['plain']):.0f} GB/s; clone() "
              f"{clone_ms:.3f} ms = {gbs(clone_ms):.0f} GB/s "
              f"(runs {t['runs_ms']})")

    window_ms, by_name = profile_round_trips(torch, bench)
    busy_ms = sum(by_name.values())
    print(f"[{card}] profile of one 512^3 c2c round trip: {window_ms:.3f} ms "
          f"on the card (CUDA events), kernels busy {busy_ms:.3f} ms, "
          f"idle share {1 - busy_ms / window_ms:.3f}")
    if not by_name:
        print("profiler saw no device time: kernel breakdown not measured")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms:8.3f} ms  {ms / window_ms:6.1%}  {name[:110]}")

    t120 = perm_t[(1, 2, 0)]
    kernels = {"kernels": [{
        "name": "K1 transpose2d (cyclic local permute)",
        "route": "cuda",
        "source": "cudecomp_tpu_torch/csrc/transpose2d.cu",
        "replaces": "cudecomp_tpu/ops/pallas_kernels.py:299",
        "launches": mp["launches"],
        "max_abs_err": worst,
        "ms": t120["kernel"],
        "plain_ms": t120["plain"],
    }]}
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
