#!/usr/bin/env python3
"""Smoke run of cudecomp_tpu_torch on one NVIDIA GPU: the quickest proof
that the port builds, is right and starts on the card.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the K1 local-permute, K4 stencil, K5 fused 2-axis DFT, C2
     spectral curl and projection and C3 CG-pass libraries and the one
     library of the K2
     one-sided all-to-all and the K3 one-sided halo ring from the
     checkout's sources, in parallel; K0, the probe, runs once as each
     library loads;
  3. K1 against its plain twin, bit for bit: bf16/f32/f64/c64/c128, both
     cyclic perms, ragged and degenerate shapes, and the 512^3 c64 shapes
     of the FFT path;
  4. K4 against its plain version (stencil27_ref): f32, f64, bf16 and
     f16, 7-tap and dense 27-tap weights (the face and the dense
     instance), valid mode and ghost-plane mode with periodic,
     non-periodic and mixed (x ghost) edges, on ragged shapes whose
     extents are no multiples of K4's 64 x 16 tile (so wrapped and ghost
     cells land at tile edges in y and z), and the 512^3 f32 path shape,
     each by the loader its plan picks and, where that is TMA, once more
     by cp.async; max abs difference <= 1e-6
     (f32), 1e-14 (f64), 8e-3 (bf16) or 1e-3 (f16) times sum|w| *
     max|input| (the 2-byte types against stencil27_ref's float32 sum
     rounded once: one unit in the last place);
     K5 against its plain version (dft2_ref) and against complex128
     torch.fft.fftn over dims (1, 2), forward and inverse, on shapes that
     take every branch and cluster size: (129, 256, 256), (256, 256, 256),
     (3, 24, 128), (5, 200, 256), (16, 8, 128), (1, 256, 128),
     (3, 16, 256), (4, 32, 128), (2, 64, 256) and (2, 128, 128): max abs
     difference <= 1e-5 * max|reference|;
  5. the FFT path: the 512^3 complex64 distributed FFT on a pdims (1, 1)
     axis-contiguous grid through the public entry points.  The forward
     spectrum is held to torch.fft.fftn of the same global field (relative
     L2 error <= 1e-5), the round trip to max abs error < 5e-4, and the
     round trip must launch K1 exactly 4 times; an r2c round trip at 512^3
     must pass the same 5e-4 gate; C2, Taylor-Green's curl and masked
     projection, on the (257, 512, 512, 3) c64 r2c forward of a random
     field in the forward's layout (a plane per component) and on its
     (re, im) plane pair: the curl, the projection and the projection
     with Taylor-Green's dealias mask field, one launch each, in the
     input's layout, within 4 ulps of the largest term of the formulas
     (SpectralOperators._curl_formula, _project_formula);
  6. the halo and stencil path at 512^3 float32, pdims (1, 1), through the
     public entry points: update_halos (width 1, periodic) bit-equal to a
     plain wrapped-index buffer; diffusion_step, the dense 27-tap
     stencil_apply and its backward, each launching K4 once and held to a
     plain sum of torch.roll terms; solve_cg at 256^3 (tol 1e-5), whose
     residual recomputed plainly must be <= 2e-5, launching K4 once and C3
     three times per iteration; C3's three passes on four random 1024^3
     f32 vectors (the cg1024.iter cell's size): the new u, r and p
     bit-equal to the formulas of models/poisson.py for the same scalars,
     alpha too, and p . Ap and the new r . r within 2^-24 of float64 sums,
     one call of each entry (cg_kernel.calls).  Phases 5 and 6 run with CUDECOMP_TPU_FFT_FUSED2 unset
     and must launch K5 no time;
  7. the spectral path at 256^3 float32, pdims (1, 1), natural layout,
     with CUDECOMP_TPU_FFT_FUSED2=1 for the K5 cases only: the
     split-complex PoissonSolver on u = sin x cos 2y sin 3z (solve within
     1e-5 rel L2 of u; solve(discrete=True) within 1e-5 of the closed-form
     discrete solution, and its plain 7-point Laplacian within 2e-4 of f;
     2 K5 launches per solve; the knob off: 0 launches, within 1e-5); two
     RK4 steps of the ProjectionSolver on the extruded Taylor-Green field
     (within 1e-5 of R(z)^n u0, max|div_h u| <= 1e-4 max|u|, 8 K5 launches
     per step); the Taylor-Green solver at Re 1600, IF-RK4, dt 2e-3, 250
     steps to t = 0.5, energy and dissipation at t = 0.1 ... 0.5 within
     1e-4 of docs/tg_validation_n256.csv (the JAX package's f32 curve),
     8 C2 launches per step and one per dissipation; one IF-RK4 step of
     the solver with a complex (not split) state, 8 C2 launches, within
     1e-5 rel L2 of the split solver's step;
  8. timing: the FFT round trip (ms per direction, GFLOPS), K1's bandwidth
     beside clone() and its plain twin; the diffusion step, K4 for the 7-tap
     and the dense 27-tap set in wrap mode beside its bound, clone(), the
     conv3d yardstick and its plain version, with the instance that ran
     and its registers and spills, the halo update and the CG iteration;
     K5 at (129, 256, 256) beside its bound, dft2_ref, cuFFT and clone()
     of the same bytes (GB/s), with the cluster size it launches; C2's
     curl and masked projection on phase 5's state beside their bounds,
     the formulas and clone(); C3's three passes at 1024^3 f32 beside
     their bounds (2, 6 and 3 vectors of 4 GiB), the formulas and clone();
     K0
     beside clone() and its launch floor (an empty kernel's launch); the
     Poisson solve with K5 on and off, the Taylor-Green step
     and the projection-solver step; torch.profiler breakdowns by kernel, with
     the card's idle share, of one FFT round trip, one diffusion step, one
     CG chunk, one Taylor-Green step and one K5 Poisson solve, captured by
     performance.profile_trace in a fresh process (on the card,
     torch.profiler loses kernel records once a process has run for tens
     of seconds); where a trace lost a launch's kernel, its busy time and
     idle share print as not measured;
  9. the one-sided exchange path: K2s (a2a_smoke, K2's single-rank program
     and K1) bit-equal on a one-rank gloo group in this process, one CUDA
     launch per call, timed, and then torch.profiler sees that one launch,
     a copy_kernel, on the card; then four ranks in four processes sharing the card
     (gloo over file://, every rank on cuda:0): K2 over each mesh dim on a
     rank's 512^3/4 c64 pencil (the path's size) bit-equal to its plain
     executor on the card; the 512^3 c64 axis-contiguous PALLAS_A2A round
     trip at pdims (2, 2), each rank holding its shard to its slice of the
     complex128 torch.fft.fftn of the global field (forward rel L2 <= 1e-5
     over all ranks, round trip max abs < 5e-4, exactly 4 K2 launches per
     rank, each 2 kernels and 2 stream memory operations (the signal to
     the one peer of the group and the wait for its signal), and no
     all_to_all_single), two HaloMethod.PALLAS updates of the 512^3 f32
     x-pencil at width 1, periodic and not, bit-equal to the plain
     wrapped-index buffer with 2 K3 launches each, each 2 kernels and 2
     stream memory operations; K2 and K3 on a 66 x 70 x 74 grid at pdims
     (1, 4) and (4, 1) bit-equal to their plain versions over gloo on CPU
     copies; the ranks' times of K2, the round trip, K3 and the update;
     after them one more K2 exchange and one more K3 update under
     torch.profiler, whose 2 move_kernel runs each on the card must be the
     2 kernels its C entry reports, with no other device record (torch.
     profiler records no stream memory operation: their count is held to
     the signal pad instead, where the peer's slot must hold the
     exchange's epoch + 1), and K2 over the world on blocks that outgrow
     its workspace, bit-equal, the workspace replaced by a new one
     (testing.check_workspace_growth); K2's one PyTorch call timed,
     dist.all_to_all_single of a rank's pencil over the gloo group of pr
     on the card's tensors (never on the path); the autotuner on a 128^3
     c64 grid with pdims (0, 0), by transpose round trips and then with
     grid_mode='halo': the three process grids with pallas_a2a and
     HaloMethod.PALLAS (what a CUDA grid over gloo can run), every rank
     choosing alike, the winner's c2c round trip < 5e-4, K2 and K3
     launched; then, outside the counted run, K2 over each sharded dim
     and one HaloMethod.PALLAS update of every candidate grid, on random
     c64 pencils of the sweeps' shapes, bit-equal to their plain versions;
     in this process, the plain executor's times on the card for the same
     data;
 10. the autotuner path on one card, in a fresh process (on the card,
     torch.profiler loses kernel records once a process has run for tens
     of seconds): make_grid of 512^3 c64 with pdims (0, 0),
     layouts and halo methods swept: a trial of every default method
     (all_to_all, ring, ring_xor, ring_pipelined, pallas_a2a) in each
     layout, the natural layout winning (at P = 1 it moves no data) and
     frozen into the grid, K1 launched 4 times in each axis-contiguous
     round trip; one profiled axis-contiguous round trip, whose device
     times name K1's kernel, with no launch missing its kernel, and whose
     attributed total is within 10% of the round trip's CUDA-event time
     (segment_roundtrip's); the performance report of 3 such round trips
     (each transpose counted 3 times); segment_roundtrip (no exchange
     time, the total within 10% of the four K1 launches timed alone on
     the round trip's pencils);
 11. the rest of the library on the card: the basic-usage flow through
     ``compat`` at 512^3 c64, pdims (1, 1), axis-contiguous (its four
     transposes 4 K1 launches, bit-equal to the native ops;
     cudecompUpdateHalosX width 1 periodic on 512^3 f32 bit-equal to
     update_halos; the workspace sizes equal geometry's; a 128^3 grid with
     pdims (0, 0) and mapped options copies its winner back into the
     struct); autotune_fft at 256^3 c2c split-complex (both candidates gate
     under 5e-4 and are timed, K5 launching in the K5 trials only; the
     winner's forward launches K5 if and only if K5 won and lies within
     1e-5 rel L2 of complex128 fftn) and at 512^3 (the K5 candidate refused
     by the shape gate, cuFFT winning); the gradients: the backward of the
     512^3 c64 axis-contiguous transpose_x_to_y is one K1 launch, bit-equal
     to permute().contiguous()'s autograd, and the backward of K5 forward
     and inverse at (129, 256, 256) one K5 launch each, within 1e-5 rel L2
     of torch.fft's complex128 autograd, each timed beside its forward (and
     in phase 9's ranks: the backward of a PALLAS_A2A transpose on the
     66 x 70 x 74 grid at pdims (2, 2) is one counted K2 launch, bit-equal
     to the reverse transpose of the cotangent, and HaloMethod.PALLAS with
     grad raises ValueError); the dryrun: one step of entry("cuda") and
     dryrun_multichip(4, "cuda") on the shared card, every rank running
     pallas_a2a and HaloMethod.PALLAS and refusing exactly the stages that
     move CUDA tensors over gloo; the six examples at their default sizes
     on the card, P = 1, each timed;
 12. the bench table (cudecomp_tpu_torch.bench_full.main) in a fresh
     process, so that the 1024^3 c64 cell has the card's memory free of
     this process's cache, written to OUT_DIR/bench_full_h100.json:
     c2c at 256^3, 512^3 and 512^3 in the natural layout, r2c at 512^3,
     the 512^3 f32 transpose round trip, the 512^3 halo update and
     diffusion step, CG at 256^3, then c2c at 768^3, 1024 x 512 x 512 and
     1024^3, r2c at 768^3 and the f32 transpose round trip at 768^3 and
     1024^3; every FFT round trip within 5e-4 max abs error, first and on
     the timed run, every transpose round trip bit-equal to its input,
     every headline a positive finite value, K1 launched and K5 not
     (CUDECOMP_TPU_FFT_FUSED2 unset); then one profile_trace of the
     natural-layout 512^3 and of the 1024^3 round trip, each in a fresh
     process;
 13. the sweep runner (cudecomp_tpu_torch.sweep) on the card:
     benchmarks/sweep_config_chip.yaml (256^3 and 512^3 f32, pdims
     (1, 1), both layouts, one rank) and a four-rank matrix on ranks that
     share the card (66 x 70 x 74 and 256^3, pdims (2, 2), (1, 4) and
     (4, 1), pallas_a2a and all_to_all, f32, both layouts, checked
     against the global-index field), each world one spawn, the rows
     written to OUT_DIR/sweep_*.csv: every one-rank and every
     pallas_a2a row ok, no FAIL, any ERROR a CannotRun (all_to_all moves
     CUDA tensors over gloo), K1 and K2 launched.

Before each path (5, 6, 7, the four ranks of 9 and their autotuner, 10,
each part of 11, 12 and each world of 13) every launch count is set to 0 (in 5, 6 and 7 the loaded libraries
are dropped too, so the path loads them as a fresh process does, and K0
runs inside it; the ranks of 9 and 13 and the processes of 10 and 12 are
fresh processes); the counts are read just after.  The line
before the last is a JSON object describing each kernel; the last line is
{"ok": true, "device": {...}}.  Exits nonzero, printing neither, when CUDA
is not available or the package is missing.
"""

import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from statistics import mean

RTOL_FFT = 1e-5      # relative L2 error of the c64 forward spectrum
GATE = 5e-4          # round-trip max abs error (benchmark.cu:23-27)
# x sum|w| x max|input|; 2-byte types: one unit in the last place
K4_EPS = {"float32": 1e-6, "float64": 1e-14, "bfloat16": 8e-3,
          "float16": 1e-3}
RTOL_DIFFUSION = 1e-6  # rel L2 of the diffusion step against plain rolls
CG_N, CG_TOL, CG_GATE = 256, 1e-5, 2e-5
N = 512
DEVICE = "cuda"
NS = 256             # the spectral path's grid
K5_EPS = 1e-5        # x max|reference| (tests/test_mxu_fft.py:94)
RTOL_SPECTRAL = 1e-5
LAP_GATE = 2e-4      # the 7-point operator amplifies u's f32 rounding
TG_STEPS, TG_DT, TG_RTOL = 250, 2e-3, 1e-4
C2_ULPS = 4          # x 2^-24 x the largest term of the formulas (f32)
C3_N = 1024          # C3's vectors: the cg1024.iter cell's, 4 GiB each
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM data sheet, outside the tensor cores


def card_line() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_field(torch, gen, shape, dtype):
    """Standard-normal values of ``shape`` and ``dtype`` on the card (real
    and imaginary parts each standard-normal), drawn from ``gen``."""
    if dtype.is_complex:
        parts = torch.randn(tuple(shape) + (2,), generator=gen,
                            device=DEVICE, dtype=dtype.to_real())
        return torch.view_as_complex(parts)
    return torch.randn(shape, generator=gen, device=DEVICE,
                       dtype=torch.float32).to(dtype)


def k1_compare(torch, got, want, what):
    """0.0 when K1's ``got`` is bit-equal to its twin's ``want``; raises
    otherwise."""
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"K1 differs from its twin: {what}")
    return 0.0


def kernel_checks(torch, K, gen):
    """Phase 3: K1 vs its twin on every dtype and shape class; returns the
    largest absolute difference seen (0.0 when all are bit-equal)."""
    def field(shape, dtype):
        return card_field(torch, gen, shape, dtype)

    def compare(got, want, what):
        return k1_compare(torch, got, want, what)

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


def main_path(torch, ct, K, S, D, cb, bench):
    """Phase 5: the 512^3 round trips through the public entry points."""
    plan = bench.make_plan(N, axis_contiguous=True, device=DEVICE)
    grid = plan.grid
    x = bench.make_field(grid, seed=1)

    reset_counts(K, S, D, cb)
    xh = plan.forward(x)
    back = plan.inverse(xh)
    torch.cuda.synchronize()
    path_counts = counts(K, S, D, cb)
    launches = path_counts["K1"]

    if launches != 4 or path_counts["K0"] != 1:
        raise AssertionError(f"c2c round trip launched K1 {launches} times "
                             f"and K0 {path_counts['K0']} times, expected "
                             f"4 and 1")
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
                r2c_err=r2c_err, r2c_launches=r2c_launches,
                counts=path_counts)


def kernel_timing(torch, K, perf, gen):
    """Phase 7b: K1, its twin and clone() on the 512^3 c64 shapes; ms per
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


def profile_window(torch, perf, fn, reps=3):
    """One ``performance.profile_trace`` capture of ``reps`` calls of
    ``fn`` (after one untraced call): the window those calls took on the
    card (CUDA events), the device time by kernel, both per call, and the
    launches whose kernel the trace lost."""
    import tempfile
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with tempfile.TemporaryDirectory() as d:
        with perf.profile_trace(d):
            start.record()
            for _ in range(reps):
                fn()
            end.record()
        end.synchronize()
        a = perf.device_op_attribution(d)
    return {"window_ms": start.elapsed_time(end) / reps,
            "by_name": {k: v / reps for k, v in a["ops"].items()},
            "lost": a["lost_launches"]}


def print_profile(card, what, prof):
    window_ms, by_name = prof["window_ms"], prof["by_name"]
    busy_ms = sum(by_name.values())
    if prof["lost"] or not by_name:
        # a trace that lost kernel records undercounts the busy time
        print(f"[{card}] profile of {what}: {window_ms:.3f} ms on the card "
              f"(CUDA events); kernels busy and idle share not measured: "
              f"the trace lost the kernels of {prof['lost']} launches"
              + ("" if by_name else " and holds no device time"))
    else:
        print(f"[{card}] profile of {what}: {window_ms:.3f} ms on the card "
              f"(CUDA events), kernels busy {busy_ms:.3f} ms, idle share "
              f"{1 - busy_ms / window_ms:.3f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms:8.3f} ms  {ms / window_ms:6.1%}  {name[:110]}")


def profiles_phase(torch, ct, bench, perf):
    """Phase 8's profiles, each a ``profile_trace`` capture: one K5
    Poisson solve, one 512^3 c2c round trip, one 512^3 f32 diffusion step,
    one CG chunk and one Taylor-Green step; ``[(what, profile)]``.

    They run in a process of its own (:func:`profiles_worker`): on the
    card, torch.profiler sessions lose some or all kernel records once a
    process has launched kernels for tens of seconds
    (tools/profiler_loss.py)."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(41)
    out = []
    # the fewest launches first: a session late in the process may lose
    # records even here
    sgrid = ct.make_grid(ct.GridConfig(gdims=(NS,) * 3, pdims=(1, 1)), DEVICE)
    psolver = ct.models.PoissonSolver(grid=sgrid, split_complex=True)
    f = torch.randn((NS,) * 3, generator=gen, device=DEVICE)
    with bench.fused2(True):
        out.append((f"one {NS}^3 f32 Poisson solve with K5", profile_window(
            torch, perf, lambda: psolver.solve(f))))
    del psolver, f
    fft_plan = bench.make_plan(N, axis_contiguous=True, device=DEVICE)
    fft_x = bench.make_field(fft_plan.grid, seed=3)
    out.append(("one 512^3 c2c round trip", profile_window(
        torch, perf, lambda: bench.cycle(fft_plan, fft_x))))
    del fft_plan, fft_x
    torch.cuda.empty_cache()
    grid = ct.make_grid(ct.GridConfig(gdims=(N, N, N), pdims=(1, 1)), DEVICE)
    u = torch.randn((N, N, N), generator=gen, device=DEVICE)
    out.append(("one 512^3 f32 diffusion step", profile_window(
        torch, perf, lambda: ct.diffusion_step(grid, u, 0.1))))
    del u, grid
    solver = ct.models.PoissonSolver(
        grid=ct.make_grid(ct.GridConfig(gdims=(CG_N,) * 3, pdims=(1, 1)),
                          DEVICE))
    f = torch.randn((CG_N,) * 3, generator=gen, device=DEVICE)
    out.append((f"one {CG_N}^3 f32 CG chunk (64 iterations)", profile_window(
        torch, perf, lambda: solver.solve_cg(f, tol=0.0, maxiter=64,
                                             check_every=64), reps=2)))
    del solver, f
    torch.cuda.empty_cache()
    tg = ct.models.TaylorGreenSolver(grid=sgrid, nu=1.0 / 1600.0,
                                     split_complex=True)
    uh, ftg = tg.setup(torch.float32)
    out.append((f"one {NS}^3 f32 Taylor-Green IF-RK4 step", profile_window(
        torch, perf, lambda: tg.step(uh, ftg, TG_DT))))
    return out


def profiles_worker(rank, out_path):
    """Phase 8's profile process (spawned, on cuda:0):
    :func:`profiles_phase`, written to ``out_path`` as JSON."""
    import torch
    import cudecomp_tpu_torch as ct
    from cudecomp_tpu_torch import bench, performance as perf
    torch.cuda.set_device(0)
    with open(out_path, "w") as fh:
        json.dump(profiles_phase(torch, ct, bench, perf), fh)


def reset_counts(K, S, D, cb):
    """Every launch count to 0, and the loaded libraries dropped, so the
    next path loads them (and runs K0) as a fresh process does."""
    from cudecomp_tpu_torch.ops import cg_kernel as C3
    from cudecomp_tpu_torch.ops import spectral_kernel as C2
    K.reset_launch_count()
    S.reset_launch_count()
    D.reset_launch_count()
    C2.reset_launch_count()
    C3.reset_launch_count()
    cb.reset_probe_count()
    cb.load.cache_clear()


def counts(K, S, D, cb):
    from cudecomp_tpu_torch.ops import cg_kernel as C3
    from cudecomp_tpu_torch.ops import spectral_kernel as C2
    return {"K0": cb.probe_launch_count, "K1": K.launch_count,
            "K4": S.launch_count, "K5": D.launch_count,
            "C2": C2.launch_count, "C3": C3.launch_count,
            **{f"C3.{k}": v for k, v in C3.calls.items()}}


# -- C2: Taylor-Green's curl and masked projection --------------------------------

def c2_state(torch, ct, gen):
    """The r2c forward of a random N^3 f32 vector field, (N/2+1, N, N, 3)
    complex64 in the forward's layout (a plane per component); its
    spectral operators; and Taylor-Green's (N/2+1, N, N) f32 mask field
    (dealiasing and the mean mode), which the solver's projection
    reads."""
    from cudecomp_tpu_torch.ops.fft import DistributedFFT
    from cudecomp_tpu_torch.ops.spectral import SpectralOperators
    grid = ct.make_grid(ct.GridConfig(gdims=(N, N, N), pdims=(1, 1)), DEVICE)
    plan = DistributedFFT(grid=grid, real=True)
    x = torch.randn((N, N, N, 3), generator=gen, device=DEVICE)
    vh = plan.forward(x)
    del x
    sops = SpectralOperators(plan=plan, dtype=torch.float32)
    mask = ((sops.k_squared() > 0) & (sops.mask() > 0)).to(torch.float32)
    return vh, sops, mask


def c2_ops(sops, mask):
    """``[(name, C2 call, formula, mask)]`` of the three calls checked and
    timed: the curl, the projection, the masked projection."""
    return [("curl", sops.curl, sops._curl_formula, None),
            ("project", sops.project_solenoidal, sops._project_formula, None),
            ("project_masked",
             lambda v: sops.project_solenoidal(v, mask=mask),
             lambda v: sops._project_formula(v, mask), mask)]


def c2_path(torch, ct, K, S, D, cb, gen):
    """Phase 5, C2 on :func:`c2_state` and on its (re, im) plane pair:
    each call one launch, in the input's layout, within ``C2_ULPS`` of the
    formulas' largest term (the kernel runs their operations in their
    order, each rounded alone, so bit-equality is expected and
    reported)."""
    import types
    from cudecomp_tpu_torch.ops import spectral_kernel as C2
    from cudecomp_tpu_torch.ops.spectral import SpectralOperators
    vh, sops, mask = c2_state(torch, ct, gen)
    pair = tuple(torch.empty_like(vh, dtype=torch.float32) for _ in "ri")
    pair[0].copy_(vh.real)
    pair[1].copy_(vh.imag)
    # the same operators on a split-complex plan's plane pairs
    psops = SpectralOperators(plan=types.SimpleNamespace(split_complex=True))
    psops._cache["k"] = sops.wavenumbers()
    kmax = max(float(k.abs().max()) for k in sops.wavenumbers())
    reset_counts(K, S, D, cb)
    res = {"in_strides": vh.stride(), "max_abs_err": 0.0, "bit_equal": []}
    for form, state, ops in (("complex", vh, sops), ("planes", pair, psops)):
        ins = state if form == "planes" else (state,)
        vmax = max(float(p.abs().max()) for p in ins)
        for name, call, formula, m in c2_ops(ops, mask):
            n0 = C2.launch_count
            got = call(state)
            torch.cuda.synchronize()
            launched = C2.launch_count - n0
            want = formula(state)
            gots, wants = ((got, want) if form == "planes"
                           else ((got,), (want,)))
            err = max(float((g - w).abs().max()) for g, w in zip(gots, wants))
            scale = (kmax if name == "curl" else 1.0) * vmax
            strides = [g.stride() for g in gots]
            if (launched != 1 or strides != [p.stride() for p in ins]
                    or not err <= C2_ULPS * 2.0 ** -24 * scale):
                raise AssertionError(
                    f"C2 {name} on the {form} {tuple(vh.shape)} state: "
                    f"{launched} launches (expected 1), strides {strides} "
                    f"against {[p.stride() for p in ins]}, max abs diff "
                    f"{err} (limit {C2_ULPS * 2.0 ** -24 * scale:.3e})")
            res["max_abs_err"] = max(res["max_abs_err"], err)
            if all(torch.equal(g, w) for g, w in zip(gots, wants)):
                res["bit_equal"].append(f"{name}.{form}")
            del got, want, gots, wants
    torch.cuda.synchronize()
    res["counts"] = counts(K, S, D, cb)
    if res["counts"]["C2"] != 6 or res["counts"]["K0"] != 1:
        raise AssertionError(f"the C2 checks launched {res['counts']}, "
                             f"expected 6 C2 launches and 1 K0")
    return res


def c2_timing(torch, ct, perf, gen):
    """Phase 8, C2 on :func:`c2_state`: ms per call (means over trials)
    of the curl and the masked projection by the kernel and by the
    formulas, and of ``clone()`` of the state; each call's bound is its
    bytes (the state read and written, the mask field read) over the
    card's bandwidth."""
    from cudecomp_tpu_torch.ops import spectral_kernel as C2
    vh, sops, mask = c2_state(torch, ct, gen)

    def t(fn):
        return mean(perf.time_fn(fn, n_warmup=2, n_trials=5,
                                 iters=10)) * 1e3

    out = {}
    for name, call, formula, m in c2_ops(sops, mask):
        if name == "project":
            continue
        # plain, kernel, kernel, plain: drift shows as disagreeing pairs
        runs = {"plain": [], "kernel": []}
        for side in ("plain", "kernel", "kernel", "plain"):
            fn = formula if side == "plain" else call
            runs[side].append(t(lambda: fn(vh)))
        nbytes = C2.counts(vh, m)["bytes"]
        out[name] = {"kernel": mean(runs["kernel"]),
                     "plain": mean(runs["plain"]), "runs_ms": runs,
                     "nbytes": nbytes,
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    out["clone_ms"] = t(vh.clone)
    return out


# -- C3: the CG iteration's passes ----------------------------------------------

def c3_vectors(torch, gen, n=C3_N):
    """``u, p, r, ap``: four random n^3 float32 vectors on the card; ``rs``
    (``r . r``) and ``pap`` (``|p . Ap|``, positive as the operator
    makes it) by the plain sums."""
    u, p, r, ap = (torch.randn((n, n, n), generator=gen, device=DEVICE)
                   for _ in range(4))
    return u, p, r, ap, torch.sum(r * r), torch.sum(p * ap).abs()


def c3_float64_sum(a, b, slab=64):
    """``sum(a * b)`` in float64, by x-slabs (no 8 GiB temporary)."""
    return sum(float((a[i:i + slab].double() * b[i:i + slab].double()).sum())
               for i in range(0, a.shape[0], slab))


def c3_checks(torch, gen):
    """Phase 6, C3 on :func:`c3_vectors`: the update's u, r and alpha and
    the direction's p bit-equal to the formulas (``models/poisson.py``)
    for the same scalars, p . Ap and the update's r . r within 2^-24
    (one float32 rounding) of float64 sums; one call each."""
    from cudecomp_tpu_torch.models import poisson as PS
    from cudecomp_tpu_torch.ops import cg_kernel as C3
    u, p, r, ap, rs, _ = c3_vectors(torch, gen)
    c0 = dict(C3.calls)
    res = {"bit_equal": [], "sum_rel": {}}
    pap = C3.dot(p, ap)
    want = c3_float64_sum(p, ap)
    res["sum_rel"]["dot"] = abs(float(pap) - want) / abs(want)
    pap = pap.abs()
    u2, r2, alpha, rr = C3.update(u, p, r, ap, rs, pap)
    pu, pr, palpha, _ = PS._cg_update(u, p, r, ap, rs, pap)
    for name, got, plain in (("u", u2, pu), ("r", r2, pr),
                             ("alpha", alpha, palpha)):
        if torch.equal(got, plain):
            res["bit_equal"].append(name)
    del pu, pr
    want = c3_float64_sum(r2, r2)
    res["sum_rel"]["update_rr"] = abs(float(rr) - want) / want
    p2 = C3.direction(r2, p, rr, rs)
    if torch.equal(p2, PS._cg_direction(r2, p, rr, rs)):
        res["bit_equal"].append("p")
    res["calls"] = {k: C3.calls[k] - c0[k] for k in c0}
    if (res["bit_equal"] != ["u", "r", "alpha", "p"]
            or res["calls"] != dict.fromkeys(C3.KERNELS, 1)
            or not max(res["sum_rel"].values()) <= 2.0 ** -24):
        raise AssertionError(f"C3 at {C3_N}^3 f32: {res}")
    return res


def c3_timing(torch, perf, gen):
    """Phase 8, C3 on :func:`c3_vectors`: ms per call (means over trials)
    of each entry by the kernel and by its formulas, in turns, and of
    ``clone()`` of one vector; each entry's bound is its vectors (2, 6,
    3) over the card's bandwidth."""
    from cudecomp_tpu_torch.models import poisson as PS
    from cudecomp_tpu_torch.ops import cg_kernel as C3
    u, p, r, ap, rs, pap = c3_vectors(torch, gen)
    vbytes = u.numel() * u.element_size()

    def t(fn):
        return mean(perf.time_fn(fn, n_warmup=2, n_trials=5,
                                 iters=10)) * 1e3

    entries = (("dot", 2, lambda: C3.dot(p, ap), lambda: PS._cg_dot(p, ap)),
               ("update", 6, lambda: C3.update(u, p, r, ap, rs, pap),
                lambda: PS._cg_update(u, p, r, ap, rs, pap)),
               ("direction", 3, lambda: C3.direction(r, p, rs, pap),
                lambda: PS._cg_direction(r, p, rs, pap)))
    out = {}
    for name, vectors, kernel, plain in entries:
        runs = {"plain": [], "kernel": []}
        for side in ("plain", "kernel", "kernel", "plain"):
            runs[side].append(t(kernel if side == "kernel" else plain))
        out[name] = {"kernel": mean(runs["kernel"]),
                     "plain": mean(runs["plain"]), "runs_ms": runs,
                     "nbytes": vectors * vbytes,
                     "bound_ms": vectors * vbytes / HBM_BYTES_PER_S * 1e3}
    out["clone_ms"] = t(u.clone)
    return out


# -- K4 --------------------------------------------------------------------------

def k4_weights(kind, seed=0):
    import numpy as np
    if kind == "face7":
        w = np.zeros((3, 3, 3))
        w[1, 1, 1] = -6.0
        for o in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                  (1, 1, 2)):
            w[o] = 1.0
        return w
    return np.random.default_rng(seed).standard_normal((3, 3, 3))


def stencil_kernel_checks(torch, S, gen):
    """Phase 4: K4 vs stencil27_ref; returns the largest absolute
    difference per dtype, the largest difference over its tolerance, and
    the (dtype, instance, loader) layouts that ran."""
    import numpy as np
    dev = DEVICE

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float64).to(dtype)

    def ghosts_for(u, wrap):
        out = []
        for d in range(3):
            shape = list(u.shape)
            shape[d] = 1
            out.append(None if wrap[d] else (rand(shape, u.dtype),
                                             rand(shape, u.dtype)))
        return out

    worst, worst_ratio, layouts = {}, 0.0, set()
    periods = {"periodic": (True, True, True),
               "non-periodic": (False, False, False),
               "mixed": (False, True, True)}  # x ghost, y and z wrap
    # ragged against the 64 (z) x 16 (y) tile; rows of 16-byte multiples
    # take TMA (z extents 200, 128 and 96 in ghost-plane mode, 2 and 62 in
    # valid mode, whose rows are two cells longer), the others cp.async
    shapes = ((7, 33, 65), (1, 5, 3), (2, 2, 2), (64, 32, 96), (5, 40, 200),
              (3, 17, 128), (4, 20, 62))
    cases = [(dt, shape) for dt in (torch.float32, torch.float64,
                                    torch.bfloat16, torch.float16)
             for shape in shapes]
    cases.append((torch.float32, (N, N, N)))
    for dtype, shape in cases:
        for wkind in ("face7", "dense"):
            w = k4_weights(wkind)
            u = rand(shape, dtype)
            runs = [("valid", rand(tuple(n + 2 for n in shape), dtype), None)]
            runs += [(name, u, ghosts_for(u, wrap))
                     for name, wrap in periods.items()]
            for mode, x, ghosts in runs:
                want = S.stencil27_ref(x, w, ghosts)
                plan = S.stencil_plan(w, ghosts is None, 0, dtype,
                                      want.shape)
                inputs = [x] + [p for g in (ghosts or ()) if g for p in g]
                scale = float(np.abs(w).sum()) * max(
                    float(t.abs().max()) for t in inputs)
                name = str(dtype).split(".")[1]
                tol = K4_EPS[name] * scale
                # the plan's layout, and a TMA case again by cp.async
                plans = [plan] + ([plan._replace(loader="cp.async")]
                                  if plan.loader == "tma" else [])
                for p in plans:
                    got = S.stencil27(x, w, ghosts, plan=p)
                    layouts.add((name, p.instance, p.loader))
                    err = float((got.double() - want.double()).abs().max())
                    if got.shape != want.shape or not err <= tol:
                        raise AssertionError(
                            f"K4 differs from stencil27_ref: {dtype} {shape} "
                            f"{wkind} {mode} {p.loader}: {err} > {tol}")
                    worst[name] = max(worst.get(name, 0.0), err)
                    worst_ratio = max(worst_ratio, err / tol)
                    del got
                del want
    torch.cuda.synchronize()
    want = {(str(dt).split(".")[1], i, ld) for dt in S.KERNEL_DTYPES
            for i in ("face", "dense") for ld in ("tma", "cp.async")}
    if layouts != want:
        raise AssertionError(f"phase 4 skipped K4 layouts: {want - layouts}")
    return worst, worst_ratio, layouts


def plain_stencil(torch, u, w):
    """sum w[1+dx,1+dy,1+dz] * u[i+dx, j+dy, k+dz], periodic: torch.roll
    terms, the plain reference of the path (independent of stencil27_ref)."""
    out = torch.zeros_like(u)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                wv = float(w[1 + dx, 1 + dy, 1 + dz])
                if wv:
                    out += wv * torch.roll(u, (-dx, -dy, -dz), (0, 1, 2))
    return out


def plain_laplacian(torch, u):
    out = -6.0 * u
    for d in range(3):
        for s in (-1, 1):
            out += torch.roll(u, s, d)
    return out


def stencil_path(torch, ct, S, K, D, cb):
    """Phase 6: the halo and stencil path through the public entry points;
    returns the checks' numbers and the launch counts of the path."""
    import numpy as np
    periods = (True, True, True)
    grid = ct.make_grid(ct.GridConfig(gdims=(N, N, N), pdims=(1, 1)), DEVICE)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(11)
    u = torch.randn(grid.buffer_shape(0), generator=gen, device=DEVICE)
    g = torch.randn(grid.buffer_shape(0), generator=gen, device=DEVICE)
    w = k4_weights("dense", seed=5)
    res = {}

    reset_counts(K, S, D, cb)
    # halo update, width 1 everywhere, periodic
    he = (1, 1, 1)
    buf = ct.scatter_global(grid, u, 0, halo_extents=he)
    out = ct.update_halos(grid, buf, 0, he, periods)
    idx = torch.arange(-1, N + 1, device=DEVICE) % N
    want = u.index_select(0, idx).index_select(1, idx).index_select(2, idx)
    if out is not buf or not torch.equal(out, want):
        raise AssertionError("update_halos at 512^3 differs from the plain "
                             "wrapped-index buffer")
    del buf, out, want
    res["halo_launches"] = counts(K, S, D, cb)

    # diffusion step: one K4 launch, no K1
    before = counts(K, S, D, cb)
    out = ct.diffusion_step(grid, u, 0.1)
    after = counts(K, S, D, cb)
    want = u + 0.1 * plain_laplacian(torch, u)
    res["diffusion_rel_l2"] = float(torch.linalg.vector_norm(out - want)
                                    / torch.linalg.vector_norm(want))
    if after["K4"] - before["K4"] != 1 or after["K1"] != before["K1"]:
        raise AssertionError(f"diffusion_step launched K4 "
                             f"{after['K4'] - before['K4']} and K1 "
                             f"{after['K1'] - before['K1']} times")
    if not res["diffusion_rel_l2"] <= RTOL_DIFFUSION:
        raise AssertionError(f"diffusion step rel L2 err "
                             f"{res['diffusion_rel_l2']}")
    del out, want

    # dense 27-tap stencil_apply and its backward: one launch each
    tol = K4_EPS["float32"] * float(np.abs(w).sum()) * float(u.abs().max())
    x = u.clone().requires_grad_(True)
    n0 = S.launch_count
    out = ct.stencil_apply(grid, x, w)
    n1 = S.launch_count
    (grad,) = torch.autograd.grad((out * g).sum(), x)
    n2 = S.launch_count
    if (n1 - n0, n2 - n1) != (1, 1):
        raise AssertionError(f"stencil_apply launched K4 {n1 - n0} times, "
                             f"its backward {n2 - n1} times")
    res["stencil_err"] = float((out.detach() - plain_stencil(torch, u, w))
                               .abs().max())
    tol_g = K4_EPS["float32"] * float(np.abs(w).sum()) * float(g.abs().max())
    res["adjoint_err"] = float((grad - plain_stencil(
        torch, g, w[::-1, ::-1, ::-1])).abs().max())
    if not (res["stencil_err"] <= tol and res["adjoint_err"] <= tol_g):
        raise AssertionError(f"27-tap stencil err {res['stencil_err']} "
                             f"(tol {tol}), adjoint err {res['adjoint_err']}"
                             f" (tol {tol_g})")
    del x, out, grad

    # CG at 256^3: converges, K4 once per iteration, plain residual
    solver = ct.models.PoissonSolver(
        grid=ct.make_grid(ct.GridConfig(gdims=(CG_N,) * 3, pdims=(1, 1)),
                          DEVICE))
    f = torch.randn(solver.grid.buffer_shape(0), generator=gen,
                    device=DEVICE)
    n0, c0 = S.launch_count, counts(K, S, D, cb)["C3"]
    sol, iters, rel = solver.solve_cg(f, tol=CG_TOL, maxiter=2000)
    cg_launches = S.launch_count - n0
    cg_c3 = counts(K, S, D, cb)["C3"] - c0
    h = 2 * math.pi / CG_N
    u64, f64 = sol.double(), f.double()
    b = -(f64 - f64.mean())
    resid = -plain_laplacian(torch, u64) / (h * h) - b
    res.update(cg_iters=iters, cg_rel=rel, cg_launches=cg_launches,
               cg_c3=cg_c3,
               cg_plain_rel=float(torch.linalg.vector_norm(resid)
                                  / torch.linalg.vector_norm(b)))
    if not (rel <= CG_TOL and res["cg_plain_rel"] <= CG_GATE
            and cg_launches == iters and cg_c3 == 3 * iters):
        raise AssertionError(f"solve_cg: {iters} iterations, rel "
                             f"{rel}, plain residual {res['cg_plain_rel']} "
                             f"(<= {CG_GATE}), {cg_launches} K4 launches, "
                             f"{cg_c3} C3 calls")
    torch.cuda.synchronize()
    res["launches"] = counts(K, S, D, cb)
    return res


def k4_instance(ptxas, plan, dtype="f", valid=False):
    """ptxas's registers and spills of the K4 kernel instance ``plan``
    launches (``cuda_build.ptxas_report`` lines of csrc/stencil27.cu)."""
    tag = (f"stencil27_kernelI{dtype}Lb{int(valid)}"
           f"ELb{int(plan.instance == 'face')}E")
    return next((info for name, info in ptxas if tag in name), "not found")


def stencil_timing(torch, ct, S, perf, gen):
    """Phase 8: K4 at 512^3 f32 in wrap mode for the 7-tap and the dense
    27-tap set (the dense one also through the public entry point), its
    plain version, the conv3d yardstick; clone() of the same bytes.  ms
    per call, means over trials; the dense set's numbers at the top level,
    the 7-tap set's under "face7"."""
    import numpy as np
    import torch.nn.functional as F
    grid = ct.make_grid(ct.GridConfig(gdims=(N, N, N), pdims=(1, 1)), DEVICE)
    u = torch.randn((N, N, N), generator=gen, device=DEVICE)
    ghosts = (None, None, None)

    def t(fn, iters=10):
        return mean(perf.time_fn(fn, n_warmup=2, n_trials=5,
                                 iters=iters)) * 1e3

    # the yardstick: cuDNN conv3d of the circularly padded field, in full
    # float32 (TF32 off); the pad is a separate pass, not timed
    torch.backends.cudnn.allow_tf32 = False
    padded = F.pad(u[None, None], (1, 1, 1, 1, 1, 1), mode="circular")
    out = {}
    for kind in ("face7", "dense"):
        w = k4_weights(kind, seed=5)
        # plain, kernel, kernel, plain: drift shows as disagreeing pairs
        runs = {"plain": [], "kernel": []}
        for name in ("plain", "kernel", "kernel", "plain"):
            fn = (S.stencil27_ref if name == "plain" else S.stencil27)
            runs[name].append(t(lambda: fn(u, w, ghosts),
                                3 if name == "plain" else 10))
        res = {k: mean(v) for k, v in runs.items()}
        res["runs_ms"] = runs
        res["plan"] = S.stencil_plan(w, False, 7, u.dtype, u.shape)
        kern = torch.tensor(w, dtype=torch.float32, device=DEVICE)[None, None]
        conv = F.conv3d(padded, kern)[0, 0]
        res["conv_err"] = float((conv - S.stencil27(u, w, ghosts)).abs()
                                .max())
        del conv
        res["conv_ms"] = t(lambda: F.conv3d(padded, kern))
        res["tol"] = K4_EPS["float32"] * float(np.abs(w).sum()) * float(
            u.abs().max())
        out[kind] = res
    del padded
    out.update(out["dense"])
    out["apply_ms"] = t(lambda: ct.stencil_apply(grid, u, k4_weights(
        "dense", seed=5)))
    out["clone_ms"] = t(u.clone)
    out["nbytes"] = 2 * u.numel() * u.element_size()
    return out


# -- K5 and the spectral path ----------------------------------------------------

def complex_field(torch, shape, gen):
    return torch.view_as_complex(torch.randn(tuple(shape) + (2,),
                                             generator=gen, device=DEVICE))


K5_SHAPES = ((NS // 2 + 1, NS, NS), (NS, NS, NS), (3, 24, 128), (5, 200, 256),
             (16, 8, 128), (1, 256, 128), (3, 16, 256), (4, 32, 128),
             (2, 64, 256), (2, 128, 128))


def dft2_kernel_checks(torch, D, gen):
    """Phase 4: K5 vs dft2_ref and vs complex128 cuFFT over dims (1, 2),
    forward and inverse; returns the largest absolute difference to
    dft2_ref and the largest relative (over max|reference|) to each."""
    worst = {"abs": 0.0, "ref": 0.0, "c128": 0.0}
    for shape in K5_SHAPES:
        x = complex_field(torch, shape, gen)
        for inverse in (False, True):
            got = D.dft2(x, inverse)
            ref = D.dft2_ref(x, inverse)
            fft = torch.fft.ifftn if inverse else torch.fft.fftn
            c128 = fft(x.to(torch.complex128), dim=(1, 2))
            err = float((got - ref).abs().max())
            e_ref = err / float(ref.abs().max())
            e_c = float((got.to(torch.complex128) - c128).abs().max()
                        / c128.abs().max())
            if got.shape != x.shape or not (e_ref <= K5_EPS
                                            and e_c <= K5_EPS):
                raise AssertionError(
                    f"K5 {shape} inverse={inverse}: {e_ref:.3e} of "
                    f"max|dft2_ref|, {e_c:.3e} of max|complex128 cuFFT| "
                    f"(<= {K5_EPS})")
            worst = {"abs": max(worst["abs"], err),
                     "ref": max(worst["ref"], e_ref),
                     "c128": max(worst["c128"], e_c)}
            del got, ref, c128
    torch.cuda.synchronize()
    worst["clusters"] = sorted({D.dft2_plan(*s[1:]).cluster
                                for s in K5_SHAPES})
    return worst


def rel_l2(torch, a, b):
    a, b = (torch.view_as_real(t.to(torch.complex128)) if t.is_complex()
            else t.double() for t in (a, b))
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def tg_reference():
    """docs/tg_validation_n256.csv: {t index (t = 0.1 k): (energy,
    dissipation)}, the JAX package's f32 curve at 256^3."""
    import csv
    from pathlib import Path
    path = Path(__file__).resolve().parent / "docs" / "tg_validation_n256.csv"
    out = {}
    with open(path) as fh:
        for row in csv.DictReader(fh):
            k = round(float(row["t"]) / 0.1)
            out[k] = (float(row["kinetic_energy"]), float(row["dissipation"]))
    return out


def spectral_path(torch, ct, bench, K, S, D, cb):
    """Phase 7: the spectral path at 256^3 f32 through the public entry
    points; returns the checks' numbers and the path's launch counts."""
    from cudecomp_tpu_torch.models.incompressible import rk_stability
    from cudecomp_tpu_torch.ops import spectral_kernel as C2
    grid = ct.make_grid(ct.GridConfig(gdims=(NS,) * 3, pdims=(1, 1)), DEVICE)
    h = 2 * math.pi / NS
    xs = torch.arange(NS, device=DEVICE, dtype=torch.float64) * h
    x, y, z = torch.meshgrid(xs, xs, xs, indexing="ij")
    u_exact = torch.sin(x) * torch.cos(2 * y) * torch.sin(3 * z)
    del x, y, z
    f = (-14.0 * u_exact).float()
    # the discrete solution of a single Fourier mode: f over its 7-point
    # eigenvalue
    lam = -sum(4 / h ** 2 * math.sin(k * h / 2) ** 2 for k in (1, 2, 3))
    res = {}

    reset_counts(K, S, D, cb)
    solver = ct.models.PoissonSolver(grid=grid, split_complex=True)
    with bench.fused2(True):
        n0 = D.launch_count
        u = solver.solve(f)
        n1 = D.launch_count
        ud = solver.solve(f, discrete=True)
        n2 = D.launch_count
    with bench.fused2(False):
        u_off = solver.solve(f)
        n3 = D.launch_count
    res["poisson_launches"] = (n1 - n0, n2 - n1, n3 - n2)
    res["poisson_rel"] = rel_l2(torch, u, u_exact)
    res["discrete_rel"] = rel_l2(torch, ud, f.double() / lam)
    res["lap_rel"] = rel_l2(torch, plain_laplacian(torch, ud.double())
                            / (h * h), f)
    res["off_rel"] = rel_l2(torch, u_off, u)
    if res["poisson_launches"] != (2, 2, 0) or u.dtype != torch.float32:
        raise AssertionError(f"Poisson solves launched K5 "
                             f"{res['poisson_launches']} times (knob on, "
                             f"on, off), expected (2, 2, 0); u is {u.dtype}")
    if not (max(res["poisson_rel"], res["discrete_rel"], res["off_rel"])
            <= RTOL_SPECTRAL and res["lap_rel"] <= LAP_GATE):
        raise AssertionError(f"Poisson {NS}^3: {res}")
    del u, ud, u_off, u_exact

    ns = ct.models.ProjectionSolver(grid=grid, nu=0.01, split_complex=True)
    u0, fns = ns.setup_tg(torch.float32)
    dt, un, per_step = 1e-2, u0, []
    with bench.fused2(True):
        for _ in range(2):
            n0 = D.launch_count
            un = ns.step(un, fns, dt)
            per_step.append(D.launch_count - n0)
    amp = rk_stability("rk4", ns.viscous_eigenvalue((1, 1, 0)) * dt) ** 2
    res["ns_launches"] = per_step
    res["ns_rel"] = rel_l2(torch, un, amp * u0.double())
    res["ns_div"] = float(ns.max_divergence(un)) / float(un.abs().max())
    if per_step != [8, 8] or un.dtype != torch.float32:
        raise AssertionError(f"projection steps launched K5 {per_step} "
                             f"times, expected [8, 8]; u is {un.dtype}")
    if not (res["ns_rel"] <= RTOL_SPECTRAL and res["ns_div"] <= 1e-4):
        raise AssertionError(f"projection solver {NS}^3: rel err "
                             f"{res['ns_rel']}, max|div| / max|u| "
                             f"{res['ns_div']}")
    del u0, un, fns

    tg = ct.models.TaylorGreenSolver(grid=grid, nu=1.0 / 1600.0,
                                     split_complex=True)
    uh, ftg = tg.setup(torch.float32)
    ref = tg_reference()
    devs = {}
    c0 = C2.launch_count
    t0 = time.perf_counter()
    for i in range(TG_STEPS + 1):
        if i % 50 == 0:
            k = i // 50
            e, d = float(tg.energy(uh, ftg)), float(tg.dissipation(uh, ftg))
            devs[round(0.1 * k, 1)] = (abs(e - ref[k][0]) / ref[k][0],
                                       abs(d - ref[k][1]) / ref[k][1])
        if i < TG_STEPS:
            uh = tg.step(uh, ftg, TG_DT)
    torch.cuda.synchronize()
    res["tg_s"] = time.perf_counter() - t0
    res["tg_c2"] = C2.launch_count - c0
    res["tg_devs"] = devs
    res["tg_worst"] = max(max(v) for v in devs.values())
    if not all(uh_p.dtype == torch.float32 for uh_p in uh):
        raise AssertionError("the Taylor-Green state left float32")
    if not res["tg_worst"] <= TG_RTOL:
        raise AssertionError(f"Taylor-Green {NS}^3 Re 1600: relative "
                             f"deviation from the committed curve {devs}")
    # 4 curls and 4 projections a step, one curl a dissipation
    want = 8 * TG_STEPS + len(devs)
    if res["tg_c2"] != want:
        raise AssertionError(f"{TG_STEPS} Taylor-Green steps and "
                             f"{len(devs)} dissipations launched C2 "
                             f"{res['tg_c2']} times, expected {want}")
    del uh
    # one step with a complex state against one of the split solver
    tgc = ct.models.TaylorGreenSolver(grid=grid, nu=1.0 / 1600.0)
    uc, fc = tgc.setup(torch.float32)
    us, fs = tg.setup(torch.float32)
    c0 = C2.launch_count
    uc = tgc.step(uc, fc, TG_DT)
    torch.cuda.synchronize()
    res["tg_c2_complex"] = C2.launch_count - c0
    us = tg.step(us, fs, TG_DT)
    res["tg_forms_rel"] = rel_l2(torch, uc, torch.complex(*us))
    if res["tg_c2_complex"] != 8 or uc.dtype != torch.complex64:
        raise AssertionError(f"a complex-state Taylor-Green step launched "
                             f"C2 {res['tg_c2_complex']} times, expected 8; "
                             f"the state is {uc.dtype}")
    if not res["tg_forms_rel"] <= RTOL_SPECTRAL:
        raise AssertionError(f"the complex-state Taylor-Green step is "
                             f"{res['tg_forms_rel']} rel L2 from the split "
                             f"solver's")
    torch.cuda.synchronize()
    res["launches"] = counts(K, S, D, cb)
    return res


def dft2_timing(torch, D, perf, gen):
    """Phase 8: K5, dft2_ref, cuFFT's fftn over dims (1, 2) and clone() of
    the same tensor at the r2c spectrum of a 256^3 field, (129, 256, 256)
    c64; ms per call (means over trials), and the bound of the transform:
    its bytes, or its 5 N log2 N flops as an FFT, whichever takes longer."""
    shape = (NS // 2 + 1, NS, NS)
    x = complex_field(torch, shape, gen)

    def t(fn, iters=10):
        return mean(perf.time_fn(fn, n_warmup=2, n_trials=5,
                                 iters=iters)) * 1e3

    # plain, kernel, kernel, plain: drift shows as disagreeing pairs
    runs = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        fn = D.dft2_ref if name == "plain" else D.dft2
        runs[name].append(t(lambda: fn(x)))
    out = {k: mean(v) for k, v in runs.items()}
    out["runs_ms"] = runs
    out["cufft_ms"] = t(lambda: torch.fft.fftn(x, dim=(1, 2)))
    out["clone_ms"] = t(x.clone)
    X, n1, n2 = shape
    fft_flops = 5 * X * n1 * n2 * math.log2(n1 * n2)
    nbytes = 2 * x.numel() * x.element_size()
    out["flop_ms"] = fft_flops / FP32_FLOP_PER_S * 1e3
    out["byte_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    out["bound_ms"] = max(out["flop_ms"], out["byte_ms"])
    out["bound_by"] = ("operations" if out["flop_ms"] >= out["byte_ms"]
                       else "bytes")
    out["gbs"] = {k: nbytes / (out[k] * 1e-3) / 1e9
                  for k in ("kernel", "cufft_ms", "clone_ms")}
    out["plan"] = D.dft2_plan(n1, n2)
    out["shape"] = shape
    return out


def probe_timing(torch, K, cb, perf):
    """K0 alone on its (8, 128) float32 tensor, beside clone() and the
    launch floor: an empty kernel's launch, over 1000 launches a trial."""
    lib = K._lib()
    x = torch.arange(8 * 128, dtype=torch.float32,
                     device=DEVICE).reshape(cb.PROBE_SHAPE)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        if lib.cudecomp_probe_copy(x.data_ptr(), y.data_ptr(), x.numel(),
                                   stream):
            raise RuntimeError("K0 launch failed")

    def empty():
        if lib.cudecomp_probe_empty(stream):
            raise RuntimeError("the empty kernel failed to launch")

    ms = mean(perf.time_fn(launch, n_warmup=3, n_trials=5, iters=100)) * 1e3
    plain = mean(perf.time_fn(x.clone, n_warmup=3, n_trials=5,
                              iters=100)) * 1e3
    floor = mean(perf.time_fn(empty, n_warmup=10, n_trials=5,
                              iters=1000)) * 1e3
    launch()
    torch.cuda.synchronize()
    return ms, plain, float((y - x).abs().max()), floor


# -- K2, K2s, K3: the one-sided exchange path on four ranks sharing the card -----

PEER_RANKS = 4
PEER_SMALL = (66, 70, 74)   # uneven at P = 4 along every dim
# the kernels of csrc/peer.cu, as the profiler names them (demangled or not)
PEER_KERNEL = re.compile(r"(?:::|\d)(move_kernel|copy_kernel)(?![a-z_])")


def peer_counts(PK):
    return (PK.a2a_cuda_launch_count + PK.halo_cuda_launch_count,
            PK.a2a_memop_count + PK.halo_memop_count)


def traced_exchange(torch, PK, fn):
    """One call of ``fn`` (a K2 or K3 exchange) under torch.profiler: the
    kernels of csrc/peer.cu that the profiler saw run on the card, by
    name; every other device record it saw; and the kernels and stream
    memory operations that the C entries reported for the call."""
    from torch.profiler import ProfilerActivity, profile
    k0, m0 = peer_counts(PK)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    seen, other = {}, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        m = PEER_KERNEL.search(e.key)
        into, key = (seen, m.group(1)) if m else (other, e.key[:80])
        into[key] = into.get(key, 0) + e.count
    k1, m1 = peer_counts(PK)
    return {"kernels": seen, "other": other, "reported": k1 - k0,
            "memops": m1 - m0}


def check_traced(rank, what, traced, ws, P):
    """A traced exchange over ``P`` ranks on workspace ``ws``: its two
    move kernels seen and reported, no other device record, 2 (P - 1)
    stream memory operations reported, and the signal of every other rank
    for its epoch in this rank's pad."""
    pad = ws.signals()
    traced["pad"] = pad
    ok = (traced["kernels"] == {"move_kernel": 2} and traced["reported"] == 2
          and not traced["other"] and traced["memops"] == 2 * (P - 1)
          and all(v >= ws.exchanges for r, v in enumerate(pad)
                  if r != ws.rank))
    if not ok:
        raise AssertionError(f"rank {rank}: one {what} exchange ran "
                             f"{traced} on the card (epoch "
                             f"{ws.exchanges - 1}); expected 2 move "
                             f"kernels, nothing else, {2 * (P - 1)} stream "
                             f"memory operations and every other rank's "
                             f"signal in the pad")


def peer_worker(rank, out_dir):
    """Phase 9, one of the four ranks (a ``run_card_ranks`` body: gloo
    over ``file://``, every rank on cuda:0).  K2 at the main path's shapes
    against its plain version; the main path (the c64 PALLAS_A2A round trip
    and two HaloMethod.PALLAS updates at pdims (2, 2)) between a reset and a
    read of the counts; then the small uneven checks at P = 4 and the
    timing.  Writes ``rank<r>.json`` to ``out_dir``; raises on any failed
    check."""
    import torch
    import torch.distributed as dist
    import cudecomp_tpu_torch as ct
    from cudecomp_tpu_torch import bench
    from cudecomp_tpu_torch.ops import cuda_kernels as K
    from cudecomp_tpu_torch.ops import peer_kernels as PK
    from cudecomp_tpu_torch.parallel import symmetric
    from cudecomp_tpu_torch.utils import cuda_build as cb
    from cudecomp_tpu_torch.utils import testing

    fgrid, hgrid = bench.peer_grids(N, DEVICE)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1)
    xg = torch.view_as_complex(torch.randn((N, N, N, 2), generator=gen,
                                           device=DEVICE))
    x = ct.scatter_global(fgrid, xg, 0)
    # the reference in complex128, so that the error is the port's own
    ref = ct.scatter_global(fgrid, torch.fft.fftn(xg.to(torch.complex128)),
                            2)
    # K2 over each mesh dim at the path's size (a rank's 512^3/4 c64
    # pencil in P blocks) against the plain executor on the card
    k2_err = k2_against_plain(torch, dist, PK, fgrid, xg, x.shape)
    del xg
    hg = torch.randn((N, N, N), generator=gen, device=DEVICE)
    he = (1, 1, 1)
    bufs = {p: ct.scatter_global(hgrid, hg, 0, halo_extents=he)
            for p in ((True, True, True), (False, False, False))}
    torch.cuda.empty_cache()
    plan = ct.DistributedFFT(grid=fgrid)
    a2a_single = []
    real_a2a = dist.all_to_all_single

    def spy(*a, **k):
        a2a_single.append(1)
        return real_a2a(*a, **k)

    dist.all_to_all_single = spy
    PK.reset_launch_counts()
    K.reset_launch_count()
    cb.reset_probe_count()
    xh = plan.forward(x)
    back = plan.inverse(xh)
    torch.cuda.synchronize()
    fft_k2 = PK.a2a_launch_count
    fft_k2_cuda = PK.a2a_cuda_launch_count
    fft_k2_memops = PK.a2a_memop_count
    halo_k3 = []
    for periods, buf in bufs.items():
        n0 = PK.halo_launch_count
        if ct.update_halos(hgrid, buf, 0, he, periods) is not buf:
            raise AssertionError("update_halos returned a new tensor")
        halo_k3.append(PK.halo_launch_count - n0)
    halo_k3_cuda = (PK.halo_cuda_launch_count, PK.halo_memop_count)
    torch.cuda.synchronize()
    counts = {"K0": cb.probe_launch_count, "K1": K.launch_count,
              "K2": PK.a2a_launch_count, "K3": PK.halo_launch_count,
              "all_to_all_single": len(a2a_single)}
    dist.all_to_all_single = real_a2a

    # checks, on CPU scalars summed over the ranks
    sums = torch.tensor([
        float(torch.linalg.vector_norm(xh.to(ref.dtype) - ref) ** 2),
        float(torch.linalg.vector_norm(ref) ** 2)], dtype=torch.float64)
    dist.all_reduce(sums)
    err = torch.tensor([float((back - x).abs().max())])
    dist.all_reduce(err, op=dist.ReduceOp.MAX)
    res = {"rel_l2": math.sqrt(float(sums[0]) / float(sums[1])),
           "roundtrip_err": float(err[0]), "counts": counts,
           "fft_k2": fft_k2, "fft_k2_cuda": fft_k2_cuda,
           "fft_k2_memops": fft_k2_memops, "halo_k3": halo_k3,
           "halo_k3_cuda": halo_k3_cuda,
           "halo_err": 0.0,
           "k2_err": k2_err}
    del x, ref, xh, back, plan
    if ((fft_k2, fft_k2_cuda, fft_k2_memops) != (4, 8, 8)
            or counts["all_to_all_single"]):
        raise AssertionError(f"rank {rank}: the round trip launched K2 "
                             f"{fft_k2} times in {fft_k2_cuda} kernels and "
                             f"{fft_k2_memops} stream memory operations "
                             f"(expected 4 in 8 and 8) and called "
                             f"all_to_all_single {len(a2a_single)} times")
    if not (res["rel_l2"] <= RTOL_FFT and res["roundtrip_err"] < GATE):
        raise AssertionError(f"PALLAS_A2A FFT: forward rel L2 "
                             f"{res['rel_l2']}, round trip max abs err "
                             f"{res['roundtrip_err']}")
    if halo_k3 != [2, 2] or halo_k3_cuda != (8, 8):
        raise AssertionError(f"rank {rank}: halo updates launched K3 "
                             f"{halo_k3} times in (kernels, stream memory "
                             f"operations) {halo_k3_cuda}, expected [2, 2] "
                             f"in (8, 8)")
    for periods, buf in bufs.items():
        want = testing.expected_halo_buffer(hgrid, hg, 0, he, periods)
        res["halo_err"] = max(res["halo_err"],
                              float((buf - want).abs().max()))
        if not torch.equal(buf, want):
            raise AssertionError(f"rank {rank}: HaloMethod.PALLAS update "
                                 f"{periods} differs from the plain "
                                 f"wrapped-index buffer")
    del bufs, hg, want
    torch.cuda.empty_cache()

    res["small"] = testing.check_peer_kernels(torch.device(DEVICE),
                                              PEER_SMALL, seed=3)
    res["times"] = bench.peer_rank_times(N, 1, device=DEVICE)
    # after the timing: one K2 exchange over pr and one K3 update of the
    # y dim under the profiler, whose kernels on the card must be the
    # kernels the C entries report; then K2 over the world on blocks that
    # outgrow its workspace
    blocks = torch.randn((2, 1 << 16), generator=gen, device=DEVICE)
    group = fgrid.group(fgrid.axis_names[0])
    PK.a2a(blocks, group)
    ws = symmetric.workspace(group, blocks.device, 0)
    res["k2_traced"] = traced_exchange(torch, PK,
                                       lambda: PK.a2a(blocks, group))
    check_traced(rank, "K2", res["k2_traced"], ws, ws.size)
    hgroup = hgrid.group(hgrid.axis_names[0])
    hb = torch.randn(hgrid.buffer_shape(0, he), generator=gen, device=DEVICE)
    m = hb.shape[1] - 2

    def k3():
        PK.halo_exchange(hb, hgroup, 1, 1, m, (N // 2,) * 2, True)

    k3()
    hws = symmetric.workspace(hgroup, hb.device, 0)
    res["k3_traced"] = traced_exchange(torch, PK, k3)
    check_traced(rank, "K3", res["k3_traced"], hws, hws.size)
    del hb
    testing.check_workspace_growth(torch.device(DEVICE), seed=3)
    res["grad"] = grad_ranks(torch, ct, PK, rank, gen)
    res["k2_library"] = gloo_a2a_time(torch, dist, fgrid, gen)
    res["tune"] = tune_ranks(torch, dist, ct, rank)
    if rank == 0:
        res["mps"] = bench.mps_active()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)


def grad_ranks(torch, ct, PK, rank, gen):
    """Phase 9's gradients, in one of the four ranks: the backward of a
    PALLAS_A2A x->y transpose on the PEER_SMALL grid at pdims (2, 2) is K2
    launches (counted between a reset and a read) and bit-equal to the
    reverse transpose of the cotangent; HaloMethod.PALLAS on a tensor that
    requires grad raises ValueError naming HaloMethod.PPERMUTE."""
    cfg = ct.GridConfig(gdims=PEER_SMALL, pdims=(2, 2),
                        transpose_method=ct.TransposeMethod.PALLAS_A2A,
                        halo_method=ct.HaloMethod.PALLAS)
    grid = ct.make_grid(cfg, DEVICE)
    x = torch.view_as_complex(torch.randn(grid.buffer_shape(0) + (2,),
                                          generator=gen, device=DEVICE))
    c = torch.view_as_complex(torch.randn(grid.buffer_shape(1) + (2,),
                                          generator=gen, device=DEVICE))
    xr = x.clone().requires_grad_(True)
    y = ct.transpose_x_to_y(grid, xr)
    PK.reset_launch_counts()
    (g,) = torch.autograd.grad(y, xr, c)
    torch.cuda.synchronize()
    bwd = PK.a2a_launch_count
    want = ct.transpose_y_to_x(grid, c)
    if bwd != 1 or not torch.equal(g, want):
        raise AssertionError(f"rank {rank}: the PALLAS_A2A transpose's "
                             f"backward launched K2 {bwd} times (expected "
                             f"1), bit-equal to the reverse transpose: "
                             f"{torch.equal(g, want)}")
    he = (1, 1, 1)
    h = torch.randn(grid.buffer_shape(0, he), generator=gen, device=DEVICE,
                    requires_grad=True)
    try:
        ct.update_halos(grid, h.clone(), 0, he, (True, True, True))
    except ValueError as e:
        if "HaloMethod.PPERMUTE" not in str(e):
            raise
        refusal = str(e)
    else:
        raise AssertionError(f"rank {rank}: HaloMethod.PALLAS with grad "
                             f"did not raise")
    return {"k2_backward": bwd, "refusal": refusal}


def k2_against_plain(torch, dist, PK, grid, xg, shape):
    """K2 over each mesh dim of ``grid`` with more than one rank, on blocks
    of ``shape`` (a rank's pencil, P blocks along dim 0), against the plain
    executor on the card; every member's blocks are its world rank's share
    of the global field ``xg``.  Raises unless bit-equal; returns the max
    abs difference."""
    err = 0.0
    flat = xg.reshape(-1)
    local = flat.numel() // dist.get_world_size()
    for name in grid.axis_names:
        group = grid.group(name)
        members = dist.get_process_group_ranks(group)
        if len(members) == 1:
            continue  # a dim of one rank exchanges nothing
        me = dist.get_rank(group)
        srcs = [flat[w * local:(w + 1) * local].view(shape)
                for w in members]
        plans = [PK.a2a_plan(len(members), r,
                             local * xg.element_size() // len(members))
                 for r in range(len(members))]
        want = PK.apply_plans(plans, srcs,
                              [torch.empty_like(b) for b in srcs])[me]
        got = PK.a2a(srcs[me], group)
        err = max(err, float((got - want).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"rank {dist.get_rank()}: K2 over {name} "
                                 f"at {tuple(shape)} {xg.dtype} of pdims "
                                 f"{grid.pdims} differs from its plain "
                                 f"version by {err}")
    return err


def k3_against_plain(torch, ct, PK, testing, grid, hg, he, periods):
    """One HaloMethod.PALLAS update of ``grid``'s x-pencil of the global
    field ``hg`` (halo extents ``he``): it must launch K3 and be bit-equal
    to the plain wrapped-index buffer; returns the max abs difference."""
    buf = ct.scatter_global(grid, hg, 0, halo_extents=he)
    n0 = PK.halo_launch_count
    if ct.update_halos(grid, buf, 0, he, periods) is not buf:
        raise AssertionError("update_halos returned a new tensor")
    want = testing.expected_halo_buffer(grid, hg, 0, he, periods)
    err = float((buf - want).abs().max())
    if PK.halo_launch_count == n0 or not torch.equal(buf, want):
        raise AssertionError(f"HaloMethod.PALLAS update of {hg.dtype} at "
                             f"pdims {grid.pdims} ({PK.halo_launch_count - n0}"
                             f" K3 launches) differs from the plain "
                             f"wrapped-index buffer by {err}")
    return err


def gloo_a2a_time(torch, dist, fgrid, gen):
    """K2's one PyTorch call: ms of ``dist.all_to_all_single`` of this
    rank's 512^3/4 c64 pencil (as float32 pairs) over the gloo group of
    ``pr``, on the card's tensors (gloo may stage them through the host);
    host clock around each call and a synchronize, mean of 3 after one
    warm-up call.  Timing only: the port never calls it on CUDA tensors.
    ``{"ms": None, "refused": words}`` where torch refuses."""
    group = fgrid.group(fgrid.axis_names[0])
    pencil = torch.randn((2 * N ** 3 // dist.get_world_size(),),
                         generator=gen, device=DEVICE)
    out = torch.empty_like(pencil)
    times = []
    try:
        for i in range(4):
            dist.barrier()
            t0 = time.perf_counter()
            dist.all_to_all_single(out, pencil, group=group)
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
    except RuntimeError as e:  # torch's words go into the kernels line
        return {"ms": None, "refused": str(e).splitlines()[0][:300]}
    finally:
        del pencil, out
        torch.cuda.empty_cache()
    return {"ms": mean(times), "runs_ms": times, "refused": None}


TUNE_N = 128   # phase 9's autotuned grid
TUNE_GRIDS = ([1, 4], [2, 2], [4, 1])   # its candidates on four ranks
TUNE_HALO = (1, 1, 1)


def tune_ranks(torch, dist, ct, rank):
    """Phase 9's autotuner, in each of the four ranks: a 128^3 c64 grid
    with pdims (0, 0), the default candidates (on a CUDA grid over gloo,
    pallas_a2a and HaloMethod.PALLAS), by transpose round trips and then
    by halo updates (grid_mode='halo'); the winner's c2c round trip held
    to the 5e-4 gate over all ranks.  After the counts are read, K2 and
    K3 on every candidate grid at the sweeps' shapes and type (c64),
    against their plain versions on random data."""
    import importlib
    at = importlib.import_module("cudecomp_tpu_torch.autotune")
    from cudecomp_tpu_torch.ops import peer_kernels as PK
    from cudecomp_tpu_torch.utils import testing
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(21)
    xg = torch.view_as_complex(torch.randn((TUNE_N,) * 3 + (2,),
                                           generator=gen, device=DEVICE))
    out = {}
    PK.reset_launch_counts()
    for mode in ("transpose", "halo"):
        opts = ct.AutotuneOptions(dtype=torch.complex64, n_warmup=1,
                                  n_trials=2, autotune_halo_method=True,
                                  halo_extents=TUNE_HALO, grid_mode=mode)
        t0 = time.perf_counter()
        res = at.autotune(ct.GridConfig(gdims=(TUNE_N,) * 3), DEVICE, opts)
        tune_s = time.perf_counter() - t0
        plan = ct.DistributedFFT(grid=res.grid)
        x = ct.scatter_global(res.grid, xg, 0)
        back = plan.inverse(plan.forward(x))
        torch.cuda.synchronize()
        err = torch.tensor([float((back - x).abs().max())])
        dist.all_reduce(err, op=dist.ReduceOp.MAX)
        out[mode] = {
            "best": [list(res.best_pdims), res.best_method.value,
                     res.best_halo_method.value],
            "frozen": [list(res.grid.pdims),
                       res.grid.config.transpose_method.value,
                       res.grid.config.halo_method.value],
            "trials": [[list(t.pdims), t.method, t.skipped]
                       for t in res.trials],
            "halo_trials": [[list(t.pdims), t.method, t.skipped]
                            for t in res.halo_trials],
            "report": res.report() if rank == 0 else None,
            "err": float(err[0]), "s": tune_s}
        del plan, x, back
    out["counts"] = {"K2": PK.a2a_launch_count, "K3": PK.halo_launch_count}

    # the kernels against their plain versions at the sweeps' shapes: the
    # candidates' pencils of c64 (the trials time zeros)
    hg = torch.view_as_complex(torch.randn((TUNE_N,) * 3 + (2,),
                                           generator=gen, device=DEVICE))
    out["k2_err"] = out["k3_err"] = 0.0
    for pdims in TUNE_GRIDS:
        grid = ct.make_grid(ct.GridConfig(
            gdims=(TUNE_N,) * 3, pdims=pdims,
            transpose_method=ct.TransposeMethod.PALLAS_A2A,
            halo_method=ct.HaloMethod.PALLAS), DEVICE)
        out["k2_err"] = max(out["k2_err"], k2_against_plain(
            torch, dist, PK, grid, xg, grid.buffer_shape(0)))
        out["k3_err"] = max(out["k3_err"], k3_against_plain(
            torch, ct, PK, testing, grid, hg, TUNE_HALO,
            opts.halo_periods))
    del xg, hg
    torch.cuda.empty_cache()
    return out


def check_tune_ranks(ranks):
    """Phase 9's autotuner: every rank chose alike, the candidates were
    the three process grids with pallas_a2a and HaloMethod.PALLAS, none
    skipped, and the winner's round trip passed the gate."""
    grids = [list(g) for g in TUNE_GRIDS]
    if any(min(r["tune"]["counts"].values()) < 1 for r in ranks):
        raise AssertionError(f"phase 9 autotune launched no K2 or no K3: "
                             f"{[r['tune']['counts'] for r in ranks]}")
    for mode in ("transpose", "halo"):
        tunes = [r["tune"][mode] for r in ranks]
        if any(t["best"] != tunes[0]["best"] for t in tunes):
            raise AssertionError(f"phase 9 autotune ({mode}): the ranks "
                                 f"chose {[t['best'] for t in tunes]}")
        t = tunes[0]
        if t["frozen"] != t["best"] or t["best"][1:] != ["pallas_a2a",
                                                         "pallas"]:
            raise AssertionError(f"phase 9 autotune ({mode}): chose "
                                 f"{t['best']}, the grid holds "
                                 f"{t['frozen']}")
        want_t = ([[g, "pallas_a2a", False] for g in grids]
                  if mode == "transpose"
                  else [[t["best"][0], "pallas_a2a", False]])
        want_h = ([[t["best"][0], "pallas", False]] if mode == "transpose"
                  else [[g, "pallas", False] for g in grids])
        if t["trials"] != want_t or t["halo_trials"] != want_h:
            raise AssertionError(f"phase 9 autotune ({mode}): trials "
                                 f"{t['trials']}, halo trials "
                                 f"{t['halo_trials']}")
        if not max(x["err"] for x in tunes) < GATE:
            raise AssertionError(f"phase 9 autotune ({mode}): the winner's "
                                 f"round trip max abs err "
                                 f"{max(x['err'] for x in tunes)}")


def peer_phase(torch, perf):
    """Phase 9: K2s in this process on a one-rank gloo group, then the four
    ranks, then the plain versions' times on the card in this process."""
    import tempfile
    import torch.distributed as dist
    from cudecomp_tpu_torch import bench
    from cudecomp_tpu_torch.ops import cuda_kernels as K
    from cudecomp_tpu_torch.ops import peer_kernels as PK
    from cudecomp_tpu_torch.parallel import symmetric
    from cudecomp_tpu_torch.utils.testing import run_card_ranks

    def t(fn, iters=10):
        return mean(perf.time_fn(fn, n_warmup=2, n_trials=3,
                                 iters=iters)) * 1e3

    res = {"compute_mode": bench.compute_mode()}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/pg1",
                                rank=0, world_size=1)
        PK.reset_launch_counts()
        K.reset_launch_count()
        ok = PK.a2a_smoke(1024, device=DEVICE)
        torch.cuda.synchronize()
        k2s = {"launches": PK.a2a_launch_count,
               "cuda_launches": PK.a2a_cuda_launch_count,
               "k1": K.launch_count}
        if not ok or (k2s["launches"], k2s["cuda_launches"],
                      k2s["k1"]) != (1, 1, 1):
            raise AssertionError(f"K2s: bit-equal {ok}, K2 exchanges, K2 "
                                 f"CUDA launches and K1 launches {k2s}, "
                                 f"expected 1, 1 and 1")
        x = torch.arange(1024 * 256, dtype=torch.float32,
                         device=DEVICE).reshape(1024, 256)
        k2s["err"] = float((PK.a2a(x, None) - x).abs().max())
        k2s["ms"] = t(lambda: PK.a2a(x, None), 100)
        out = torch.empty_like(x)
        plan1 = [PK.a2a_plan(1, 0, x.numel() * 4)]
        k2s["plain_ms"] = t(lambda: PK.apply_plans(plan1, [x], [out]), 100)
        k2s["clone_ms"] = t(x.clone, 100)
        # after the timings, so that no profiler session precedes them
        traced = traced_exchange(torch, PK, lambda: PK.a2a(x, None))
        k2s["traced"] = traced["kernels"]
        if not (traced["kernels"] == {"copy_kernel": 1} and not
                traced["other"] and (traced["reported"],
                                     traced["memops"]) == (1, 0)):
            raise AssertionError(f"K2s: one call ran {traced} on the card; "
                                 f"expected one copy_kernel, reported, and "
                                 f"no stream memory operation")
        k2s["bytes"] = 2 * x.numel() * 4
        res["k2s"] = k2s
        symmetric.release_workspaces()
        dist.destroy_process_group()
        del x, out
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        run_card_ranks(peer_worker, PEER_RANKS, f"{tmp}/pg4", (tmp,), 300,
                       "phase 9's four ranks")
        res["ranks_s"] = time.perf_counter() - t0
        ranks = []
        for r in range(PEER_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
    res["ranks"] = ranks
    res["mps"] = ranks[0]["mps"]
    res["times"] = bench.merge_ranks([r["times"] for r in ranks])

    # the plain versions on the card, all four ranks' data in this process:
    # two groups of two along pr, as the timed K2 and K3 calls run
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(9)
    local = N ** 3 // PEER_RANKS
    blocks = [torch.view_as_complex(torch.randn(
        (local, 2), generator=gen, device=DEVICE)).view(2, -1)
        for _ in range(PEER_RANKS)]
    outs = [torch.empty_like(b) for b in blocks]
    bb = local * 8 // 2
    plans = [PK.a2a_plan(2, r, bb) for r in range(2)]
    res["k2_plain_ms"] = t(lambda: [PK.apply_plans(plans, blocks[g::2],
                                                   outs[g::2])
                                    for g in range(2)], 3)
    res["k2_bytes"] = 2 * PEER_RANKS * local * 8
    del blocks, outs
    shape = (N + 2, N // 2 + 2, N // 2 + 2)
    bufs = [torch.randn(shape, generator=gen, device=DEVICE)
            for _ in range(PEER_RANKS)]
    hplans = [PK.halo_plan(shape, 4, 1, 1, N // 2, (N // 2,) * 2, r, True)
              for r in range(2)]
    res["k3_plain_ms"] = t(lambda: [PK.apply_plans(hplans, bufs[g::2],
                                                   bufs[g::2])
                                    for g in range(2)])
    slab = shape[0] * shape[2] * 4
    res["k3_bytes"] = PEER_RANKS * 4 * slab
    del bufs
    torch.cuda.empty_cache()
    return res


# -- phase 10: the autotuner, the performance report and the profiler trace -----

def with_card(card, text):
    return "\n".join(f"[{card}] {line}" for line in text.splitlines())


def autotune_phase(torch, ct, K, perf):
    """Phase 10 on one card: ``make_grid`` with pdims (0, 0) at 512^3 c64
    (the autotuner's result caught on its way out), then a profiled round
    trip, the performance report, ``segment_roundtrip`` and K1 alone on
    the axis-contiguous grid; raises on any failed check.

    It runs in a process of its own (:func:`autotune_worker`): on the
    card, torch.profiler sessions lose some or all kernel records once a
    process has launched kernels for tens of seconds
    (tools/profiler_loss.py)."""
    import importlib
    at = importlib.import_module("cudecomp_tpu_torch.autotune")
    from cudecomp_tpu_torch.ops.transpose import _net_perm

    opts = ct.AutotuneOptions(autotune_layouts=True,
                              autotune_halo_method=True,
                              halo_extents=(1, 1, 1), dtype=torch.complex64,
                              n_warmup=2, n_trials=3)
    caught = []
    real = at.autotune

    def spy(*a, **k):
        caught.append(real(*a, **k))
        return caught[-1]

    at.autotune = spy
    K.reset_launch_count()
    t0 = time.perf_counter()
    try:
        grid = ct.make_grid(ct.GridConfig(gdims=(N, N, N), pdims=(0, 0)),
                            DEVICE, autotune_options=opts)
    finally:
        at.autotune = real
    torch.cuda.synchronize()
    res = {"tune_s": time.perf_counter() - t0, "k1": K.launch_count}
    (result,) = caught
    methods = ["all_to_all", "ring", "ring_xor", "ring_pipelined",
               "pallas_a2a"]
    tags = [f"{m}/ac={a}" for m in methods for a in (0, 1)]
    if ([(t.pdims, t.method, t.skipped) for t in result.trials]
            != [((1, 1), tag, False) for tag in tags]):
        raise AssertionError(f"phase 10 trials {result.trials}")
    if [t.method for t in result.halo_trials] != ["ppermute", "pallas"]:
        raise AssertionError(f"phase 10 halo trials {result.halo_trials}")
    cfg = grid.config
    if (cfg.pdims, cfg.transpose_method, cfg.halo_method) != (
            result.best_pdims, result.best_method,
            result.best_halo_method) or grid is not result.grid:
        raise AssertionError(f"phase 10: the grid holds {cfg}, the "
                             f"autotuner chose {result.best_pdims} "
                             f"{result.best_method} "
                             f"{result.best_halo_method}")
    if cfg.transpose_axis_contiguous != (False,) * 3:
        raise AssertionError("phase 10: an axis-contiguous layout beat the "
                             "natural one, which moves no data at P = 1")
    round_trips = len(methods) * (opts.n_warmup
                                  + opts.n_trials * at.TRIAL_ITERS)
    if res["k1"] != 4 * round_trips:
        raise AssertionError(f"phase 10: the autotuner launched K1 "
                             f"{res['k1']} times, expected 4 in each of the "
                             f"{round_trips} axis-contiguous round trips")
    res["report"] = result.report()

    acgrid = ct.make_grid(ct.GridConfig(
        gdims=(N, N, N), pdims=(1, 1), transpose_axis_contiguous=(True,) * 3,
        transpose_method=result.best_method), DEVICE)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(31)
    x = torch.view_as_complex(torch.randn((N, N, N, 2), generator=gen,
                                          device=DEVICE))

    def roundtrip():
        b = ct.transpose_x_to_y(acgrid, x)
        b = ct.transpose_y_to_z(acgrid, b)
        b = ct.transpose_z_to_y(acgrid, b)
        return ct.transpose_y_to_x(acgrid, b)

    K.reset_launch_count()
    if not torch.equal(roundtrip(), x) or K.launch_count != 4:
        raise AssertionError(f"phase 10: the axis-contiguous round trip "
                             f"launched K1 {K.launch_count} times or "
                             f"changed its input")

    import tempfile
    with tempfile.TemporaryDirectory() as d:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with ct.profile_trace(d):
            start.record()
            roundtrip()
            end.record()
        end.synchronize()
        res["event_ms"] = start.elapsed_time(end)
        res["op_times"] = perf.device_op_times(d)
        res["attribution"] = perf.device_op_attribution(d)

    perf.REGISTRY.clear()
    ct.perf_report_enable(True)
    try:
        for _ in range(3):
            roundtrip()
    finally:
        ct.perf_report_enable(False)
    rows = perf.REGISTRY.rows()
    names = sorted(r["config"].split("/")[0] for r in rows)
    if names != sorted(f"transpose_{op}" for op in (
            "x_to_y", "y_to_z", "z_to_y", "y_to_x")) or any(
            r["count"] != 3 for r in rows):
        raise AssertionError(f"phase 10 report rows {rows}")
    res["perf_report"] = perf.REGISTRY.report()
    res["report_ms"] = sum(r["avg_ms"] for r in rows)
    perf.REGISTRY.clear()

    seg = ct.segment_roundtrip(acgrid, torch.complex64, iters=5,
                               n_warmup=2, n_trials=5, record=False)
    # the four K1 launches alone, on the round trip's own pencils
    pencils = [x]
    for op in ("x_to_y", "y_to_z", "z_to_y"):
        pencils.append(getattr(ct, f"transpose_{op}")(acgrid, pencils[-1]))
    k1_ms = [mean(perf.time_fn(K.cyclic_permute, t,
                               _net_perm(acgrid.config, ax, d), n_warmup=2,
                               n_trials=5, iters=5)) * 1e3
             for t, (ax, d) in zip(pencils, ((0, 1), (1, 1), (2, -1),
                                             (1, -1)))]
    del pencils
    res.update(seg=seg, k1_ms=k1_ms)
    if seg["a2a_ms"] != 0 or not abs(seg["total_ms"] - sum(k1_ms)) <= (
            0.1 * sum(k1_ms)):
        raise AssertionError(f"phase 10 segment_roundtrip {seg}, the four "
                             f"K1 times {k1_ms} ms")
    # the traced kernels' sum against the round trip's CUDA-event time in
    # steady state (segment_roundtrip's total; the traced window also
    # holds the host's time to its first launch)
    k1_names = [k for k in res["op_times"] if "transpose2d_kernel" in k]
    a = res["attribution"]
    if (not k1_names or a["lost_launches"]
            or not abs(a["total_ms"] - seg["total_ms"]) <= (
                0.1 * seg["total_ms"])):
        raise AssertionError(f"phase 10 profile: device ops "
                             f"{sorted(res['op_times'])}, attributed "
                             f"{a['total_ms']} ms against "
                             f"{seg['total_ms']} ms, "
                             f"{a['lost_launches']} launches without their "
                             f"kernel in the trace")
    res["k1_names"] = k1_names
    del x, acgrid, grid, result
    torch.cuda.empty_cache()
    return res


def autotune_worker(rank, out_path):
    """Phase 10's process (spawned, on cuda:0): :func:`autotune_phase`,
    its results written to ``out_path`` as JSON; raises on any failed
    check.  Its report discards no sample, so that it counts every one of
    its three round trips."""
    os.environ["CUDECOMP_TPU_PERF_N_WARMUP"] = "0"
    import torch
    import cudecomp_tpu_torch as ct
    from cudecomp_tpu_torch import performance as perf
    from cudecomp_tpu_torch.ops import cuda_kernels as K
    torch.cuda.set_device(0)
    with open(out_path, "w") as fh:
        json.dump(autotune_phase(torch, ct, K, perf), fh)


# -- phase 11: compat, autotune_fft, gradients, the dryrun and the examples -----

COMPAT_N, HALO_N = 512, 512   # the compat flow's c64 and f32 fields
FFT_TUNE_N = (256, 512)       # autotune_fft's grids: K5 takes 256 only
K5_GRAD_SHAPE = (129, 256, 256)
EXAMPLES = ("basic_usage", "fft_autotune", "checkpoint_restart",
            "heat3d_stencil", "spectral_ops", "ns_projection")
# the stages a CUDA grid over gloo refuses: they move CUDA tensors over gloo
GLOO_ON_CUDA = {"all_to_all", "ring", "ring_xor", "ring_pipelined",
                "ring_hier", "halo_ppermute", "diffusion_step_halo_map",
                "uneven_ring", "projection_step"}


def compat_phase(torch, ct, K, gen):
    """The basic-usage flow through ``compat`` at 512^3 c64, pdims (1, 1),
    axis-contiguous: its four transposes are 4 K1 launches, bit-equal to
    the native ops; cudecompUpdateHalosX on 512^3 f32 bit-equal to
    update_halos; the workspace sizes equal geometry's; and a pdims (0, 0)
    grid of 128^3 with mapped options copies its winner back."""
    from cudecomp_tpu_torch import compat as cc, geometry
    handle = cc.cudecompInit(device=DEVICE)
    config = cc.cudecompGridDescConfigSetDefaults()
    config.gdims, config.pdims = (COMPAT_N,) * 3, (1, 1)
    config.transpose_axis_contiguous = (True, True, True)
    config.transpose_comm_backend = cc.CUDECOMP_TRANSPOSE_COMM_MPI_A2A
    grid = cc.cudecompGridDescCreate(handle, config)
    x = complex_field(torch, grid.buffer_shape(0), gen)
    native = x
    for name in ("x_to_y", "y_to_z", "z_to_y", "y_to_x"):
        native = getattr(ct, f"transpose_{name}")(grid, native)
    torch.cuda.synchronize()
    K.reset_launch_count()
    out, steps = x, []
    for name in ("XToY", "YToZ", "ZToY", "YToX"):
        out = getattr(cc, f"cudecompTranspose{name}")(handle, grid, out)
        steps.append(out)
    torch.cuda.synchronize()
    k1 = K.launch_count
    if k1 != 4 or not (torch.equal(out, native) and torch.equal(out, x)):
        raise AssertionError(f"compat transposes: {k1} K1 launches "
                             f"(expected 4), bit-equal to the native ops "
                             f"{torch.equal(out, native)}")
    del steps, native, out, x
    torch.cuda.empty_cache()
    he = (1, 1, 1)
    h = torch.randn(grid.buffer_shape(0, he), generator=gen, device=DEVICE)
    want = ct.update_halos(grid, h.clone(), 0, he, (True, True, True))
    got = cc.cudecompUpdateHalosX(handle, grid, h, halo_extents=he,
                                  halo_periods=(True, True, True))
    if got is not h or not torch.equal(got, want):
        raise AssertionError("cudecompUpdateHalosX differs from update_halos")
    del h, want, got
    ws = {"transpose": [cc.cudecompGetTransposeWorkspaceSize(handle, grid, eb)
                        for eb in (4, 8)],
          "halo": cc.cudecompGetHaloWorkspaceSize(handle, grid, 0, he, 4)}
    if ws != {"transpose": [geometry.transpose_workspace_size(grid.config, eb)
                            for eb in (4, 8)],
              "halo": geometry.halo_workspace_size(grid.config, 0, he,
                                                   elem_bytes=4)}:
        raise AssertionError(f"compat workspace sizes {ws}")
    tuned = cc.cudecompGridDescConfigSetDefaults()
    tuned.gdims, tuned.pdims = (128, 128, 128), (0, 0)
    opts = cc.cudecompGridDescAutotuneOptionsSetDefaults()
    opts.n_warmup_trials, opts.n_trials = 1, 2
    opts.autotune_transpose_backend = True
    opts.disable_nvshmem_backends = True
    tgrid = cc.cudecompGridDescCreate(handle, tuned, opts)
    if (tuple(tuned.pdims) != tuple(tgrid.pdims)
            or tuned.transpose_comm_backend != cc._REVERSE_TRANSPOSE_MAP[
                tgrid.config.transpose_method]):
        raise AssertionError(f"compat autotune copied back {tuned}")
    cc.cudecompFinalize(handle)
    torch.cuda.empty_cache()
    return {"k1": k1, "ws": ws, "tuned": (tuple(tuned.pdims),
                                          tgrid.config.transpose_method.value)}


def autotune_fft_phase(torch, ct, D):
    """autotune_fft at 256^3 c2c split-complex, pdims (1, 1): both
    candidates gate and are timed, K5 launching in the K5 trials only, the
    returned plan's forward launching K5 if and only if K5 won and within
    1e-5 rel L2 of complex128 fftn; at 512^3 the K5 candidate is refused
    by the shape gate and cuFFT wins."""
    from cudecomp_tpu_torch.ops import fft as F
    by_policy = {False: 0, True: 0}
    orig = {n: getattr(F.DistributedFFT, n)
            for n in ("forward_planes", "inverse_planes")}

    def attributed(name):
        def call(self, v):
            n0 = D.launch_count
            out = orig[name](self, v)
            by_policy[bool(self.fused2)] += D.launch_count - n0
            return out
        return call

    res = {}
    for n in FFT_TUNE_N:
        grid = ct.make_grid(ct.GridConfig(gdims=(n, n, n), pdims=(1, 1)),
                            DEVICE)
        D.reset_launch_count()
        by_policy.update({False: 0, True: 0})
        for name in orig:
            setattr(F.DistributedFFT, name, attributed(name))
        try:
            t0 = time.perf_counter()
            r = ct.autotune_fft(grid)
            secs = time.perf_counter() - t0
        finally:
            for name, fn in orig.items():
                setattr(F.DistributedFFT, name, fn)
        torch.cuda.empty_cache()
        entry = {"s": secs, "report": r.report(), "fused2": r.plan.fused2,
                 "k5_by_policy": dict(by_policy),
                 "trials": [(t.fused2, t.err, t.avg_s, t.reason)
                            for t in r.trials]}
        if n == FFT_TUNE_N[0]:
            if not (all(t.gate_passed and t.err < GATE and t.times_s
                        for t in r.trials)
                    and by_policy[False] == 0 and by_policy[True] > 0):
                raise AssertionError(f"autotune_fft {n}^3: trials "
                                     f"{entry['trials']}, K5 launches by "
                                     f"policy {by_policy}")
            gen = torch.Generator(device=DEVICE).manual_seed(5)
            xr = torch.randn((n, n, n), generator=gen, device=DEVICE)
            xi = torch.randn((n, n, n), generator=gen, device=DEVICE)
            D.reset_launch_count()
            yr, yi = r.plan.forward_planes((xr, xi))
            torch.cuda.synchronize()
            k5 = D.launch_count
            ref = torch.fft.fftn(torch.complex(xr, xi).to(torch.complex128))
            rel = rel_l2(torch, torch.complex(yr, yi).to(ref.dtype), ref)
            if k5 != int(r.plan.fused2) or rel > RTOL_FFT:
                raise AssertionError(f"autotune_fft {n}^3 winner fused2="
                                     f"{r.plan.fused2}: {k5} K5 launches in "
                                     f"its forward, rel L2 {rel}")
            entry.update(forward_k5=k5, rel_l2=rel,
                         k5_launches=by_policy[True] + k5)
            del xr, xi, yr, yi, ref
        else:
            k5t = r.trials[1]
            if not (r.trials[0].gate_passed and k5t.reason
                    and "K5's gate" in k5t.reason and not r.plan.fused2
                    and by_policy[True] == 0):
                raise AssertionError(f"autotune_fft {n}^3: trials "
                                     f"{entry['trials']}")
        torch.cuda.empty_cache()
        res[n] = entry
    return res


def grad_phase(torch, ct, K, D, perf, gen):
    """The backward of an axis-contiguous 512^3 c64 transpose_x_to_y is one
    K1 launch, bit-equal to the plain version's autograd; the backward of
    K5 forward and inverse at (129, 256, 256) is one K5 launch each,
    within 1e-5 rel L2 of torch.fft's autograd in complex128; forward and
    backward timed."""
    from cudecomp_tpu_torch.ops.transpose import _net_perm

    def t(fn):
        return mean(perf.time_fn(fn, n_warmup=2, n_trials=3, iters=10,
                                 device=DEVICE)) * 1e3

    grid = ct.make_grid(ct.GridConfig(gdims=(N, N, N), pdims=(1, 1),
                                      transpose_axis_contiguous=(True,) * 3),
                        DEVICE)
    x = complex_field(torch, grid.buffer_shape(0), gen)
    xr = x.clone().requires_grad_(True)
    y = ct.transpose_x_to_y(grid, xr)
    c = complex_field(torch, tuple(y.shape), gen)
    K.reset_launch_count()
    (g,) = torch.autograd.grad(y, xr, c, retain_graph=True)
    torch.cuda.synchronize()
    k1 = K.launch_count
    perm = _net_perm(grid.config, 0, +1)  # the x->y permute it launched
    xp = x.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(xp.permute(perm).contiguous(), xp, c)
    if k1 != 1 or not torch.equal(g, want):
        raise AssertionError(f"K1 backward: {k1} launches (expected 1), "
                             f"bit-equal to permute().contiguous()'s "
                             f"autograd {torch.equal(g, want)}")
    res = {"k1_backward": k1,
           "k1_fwd_ms": t(lambda: ct.transpose_x_to_y(grid, x)),
           "k1_bwd_ms": t(lambda: torch.autograd.grad(y, xr, c,
                                                      retain_graph=True))}
    del x, xr, y, c, g, want, xp
    torch.cuda.empty_cache()

    x = complex_field(torch, K5_GRAD_SHAPE, gen)
    c = complex_field(torch, K5_GRAD_SHAPE, gen)
    res["k5_backward"], res["k5_rel"] = 0, 0.0
    for inverse in (False, True):
        xr = x.clone().requires_grad_(True)
        y = D.dft2(xr, inverse)
        D.reset_launch_count()
        (g,) = torch.autograd.grad(y, xr, c, retain_graph=True)
        torch.cuda.synchronize()
        launches = D.launch_count
        x128 = x.to(torch.complex128).requires_grad_(True)
        fn = torch.fft.ifftn if inverse else torch.fft.fftn
        (want,) = torch.autograd.grad(fn(x128, dim=(1, 2)), x128,
                                      c.to(torch.complex128))
        rel = rel_l2(torch, g.to(want.dtype), want)
        if launches != 1 or rel > 1e-5:
            raise AssertionError(f"K5 backward (inverse={inverse}): "
                                 f"{launches} launches (expected 1), rel L2 "
                                 f"{rel} against torch.fft's autograd")
        tag = "inv" if inverse else "fwd"
        res["k5_backward"] += launches
        res["k5_rel"] = max(res["k5_rel"], rel)
        res[f"k5_{tag}_ms"] = t(lambda: D.dft2(x, inverse))
        res[f"k5_{tag}_bwd_ms"] = t(lambda: torch.autograd.grad(
            y, xr, c, retain_graph=True))
        del xr, y, g, x128, want
    del x, c
    torch.cuda.empty_cache()
    return res


def dryrun_phase(torch, K):
    """entry("cuda"): one step, finite, K1 launched; dryrun_multichip(4,
    "cuda") on the shared card: pallas_a2a and HaloMethod.PALLAS ran on
    every rank, and exactly the stages that move CUDA tensors over gloo
    were refused, each saying so."""
    from cudecomp_tpu_torch import dryrun
    step, args = dryrun.entry(DEVICE, seed=0)
    K.reset_launch_count()
    outs = step(*args)
    torch.cuda.synchronize()
    k1 = K.launch_count
    if k1 < 4 or not all(bool(torch.isfinite(o).all()) for o in outs):
        raise AssertionError(f"dryrun entry: {k1} K1 launches, finite "
                             f"{[bool(torch.isfinite(o).all()) for o in outs]}")
    del outs, args
    t0 = time.perf_counter()
    reports = dryrun.dryrun_multichip(PEER_RANKS, DEVICE)
    secs = time.perf_counter() - t0
    for r in reports:
        refused = set(r["refused"])
        if not ({"pallas_a2a", "halo_pallas"} <= set(r["ran"])
                and refused == GLOO_ON_CUDA
                and all("gloo" in m for m in r["refused"].values())):
            raise AssertionError(f"dryrun rank {r['rank']}: ran {r['ran']}, "
                                 f"refused {r['refused']}")
    return {"entry_k1": k1, "multichip_s": secs, "ran": reports[0]["ran"],
            "refused": sorted(reports[0]["refused"])}


def examples_phase(torch, K, S, D, cb):
    """Each of the six examples on the card at its default size, P = 1,
    between a reset and a read of the counts; its seconds."""
    import importlib
    from cudecomp_tpu_torch.ops import cg_kernel as C3
    from cudecomp_tpu_torch.ops import spectral_kernel as C2
    out = {}
    for name in EXAMPLES:
        mod = importlib.import_module(f"cudecomp_tpu_torch.examples.{name}")
        K.reset_launch_count()
        S.reset_launch_count()
        D.reset_launch_count()
        C2.reset_launch_count()
        C3.reset_launch_count()
        cb.reset_probe_count()
        secs = mod.main(["--device", DEVICE])
        torch.cuda.synchronize()
        out[name] = {"s": secs, "launches": counts(K, S, D, cb)}
        torch.cuda.empty_cache()
    if out["heat3d_stencil"]["launches"]["K4"] < 1:
        raise AssertionError(f"heat3d_stencil launched no K4: {out}")
    return out


def phase11(torch, ct, K, S, D, cb, perf, gen):
    """Phase 11: compat, autotune_fft, the gradients, the dryrun and the
    examples; returns each part's results."""
    t0 = time.perf_counter()
    res = {"compat": compat_phase(torch, ct, K, gen),
           "fft_tune": autotune_fft_phase(torch, ct, D),
           "grad": grad_phase(torch, ct, K, D, perf, gen),
           "dryrun": dryrun_phase(torch, K),
           "examples": examples_phase(torch, K, S, D, cb)}
    res["s"] = time.perf_counter() - t0
    return res


# -- phase 12: the bench table; phase 13: the sweep --------------------------------

OUT_DIR = "chiprun_out"   # phases 12 and 13 write here; gitignored
BENCH_FULL_OUT = os.path.join(OUT_DIR, "bench_full_h100.json")
PROFILE_CELLS = ("natural 512^3", "1024^3")   # phase 12's fresh-process traces
SWEEP_CHIP_CONFIG = "benchmarks/sweep_config_chip.yaml"
SWEEP_LAUNCHES = os.path.join(OUT_DIR, "phase13_launches.jsonl")
# phase 13's four-rank matrix: ranks that share the card, both layouts
SWEEP_FOUR_RANKS = {
    "gdims": [list(PEER_SMALL), [256, 256, 256]],
    "pdims": [[2, 2], [1, 4], [4, 1]],
    "method": ["pallas_a2a", "all_to_all"],
    "dtype": ["float32"],
    "axis_contiguous": [False, True],
    "halo_extents": [[0, 0, 0]],
    "padding": [[0, 0, 0]],
    "check_correctness": True,
    "n_warmup": 1, "n_trials": 3, "iters": 5}


# the shapes phase 12 gives K1 that phase 3 does not hold: the cubes, every
# rotation of the non-cubic grid and of the r2c 768^3 spectrum
BENCH_K1_SHAPES = (
    [("c64", (n,) * 3) for n in (768, 1024)]
    + [("c64", s) for s in ((1024, 512, 512), (512, 512, 1024),
                            (512, 1024, 512), (385, 768, 768),
                            (768, 768, 385), (768, 385, 768))]
    + [("f32", (n,) * 3) for n in (768, 1024)])


def bench_k1_checks(torch, K):
    """K1 vs its twin at :data:`BENCH_K1_SHAPES`, every cyclic perm, one
    shape on the card at a time (1024^3 c64: input, K1's and the twin's
    outputs, 24 GiB); the largest absolute difference (0.0: bit-equal)."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(12)
    dtypes = {"c64": torch.complex64, "f32": torch.float32}
    worst = 0.0
    for name, shape in BENCH_K1_SHAPES:
        x = card_field(torch, gen, shape, dtypes[name])
        for perm in K.CYCLIC_PERMS:
            got = K.cyclic_permute(x, perm)
            want = K.cyclic_permute_ref(x, perm)
            worst = max(worst, k1_compare(torch, got, want,
                                          f"{name} {shape} {perm}"))
            del got, want
        del x
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return worst


def bench_worker(rank, out_path):
    """Phase 12's process (spawned, on cuda:0): ``bench_full.main``, which
    also writes :data:`BENCH_FULL_OUT`, between a reset and a read of the
    launch counts; then :func:`bench_k1_checks`, whose launches are not
    counted; ``{"records", "counts", "k1_err"}`` written to ``out_path``."""
    import torch
    from cudecomp_tpu_torch import bench_full
    from cudecomp_tpu_torch.ops import cuda_kernels as K
    from cudecomp_tpu_torch.ops import dft2 as D
    from cudecomp_tpu_torch.ops import stencil_kernel as S
    from cudecomp_tpu_torch.utils import cuda_build as cb
    torch.cuda.set_device(0)
    reset_counts(K, S, D, cb)
    records = bench_full.main(out=BENCH_FULL_OUT)
    launched = counts(K, S, D, cb)
    torch.cuda.empty_cache()
    k1_err = bench_k1_checks(torch, K)
    with open(out_path, "w") as fh:
        json.dump({"records": records, "counts": launched,
                   "k1_err": k1_err}, fh)


def fft_profile_worker(rank, out_path, cell):
    """One ``profile_trace`` of a bench-table cell's round trip in a fresh
    process (spawned, on cuda:0): the natural-layout 512^3 c2c round trip
    (3 traced), or the 1024^3 axis-contiguous plane-carried one (1)."""
    import torch
    from cudecomp_tpu_torch import bench, bench_full, performance as perf
    torch.cuda.set_device(0)
    if cell == PROFILE_CELLS[0]:
        plan = bench.make_plan(N, axis_contiguous=False, device=DEVICE)
        x = bench.make_field(plan.grid, seed=3)
        prof = profile_window(torch, perf, lambda: bench.cycle(plan, x))
    else:
        plan = bench_full.large_plan((1024,) * 3, True, DEVICE)
        p = bench_full.make_planes(plan.grid)
        prof = profile_window(torch, perf,
                              lambda: bench_full.planes_cycle(plan, p),
                              reps=1)
    with open(out_path, "w") as fh:
        json.dump(prof, fh)


def bench_phase(torch, card):
    """Phase 12: the bench table in a fresh process (1024^3 c64 needs the
    card's memory free of this process's cache), every record checked;
    then one trace of the natural-layout 512^3 and of the 1024^3 round
    trip, each in a fresh process."""
    from cudecomp_tpu_torch import bench_full
    torch.cuda.empty_cache()
    os.makedirs(OUT_DIR, exist_ok=True)
    t0 = time.perf_counter()
    res = fresh_process(bench_worker, "phase 12's bench table", timeout=900)
    res["s"] = time.perf_counter() - t0
    want = [(fn.__name__, kw) for fn, kw in bench_full.table(True)]
    if len(res["records"]) != len(want):
        raise AssertionError(f"phase 12: {len(res['records'])} records for "
                             f"{len(want)} headlines")
    for r in res["records"]:
        v = r["value"]
        if v is None or not math.isfinite(v) or v <= 0:
            raise AssertionError(f"phase 12: no value in {r}")
        for k in ("err", "gate_err", "timed_err"):
            if k in r and not r[k] < GATE:
                raise AssertionError(f"phase 12: {k} {r[k]} in {r}")
        if r["device"] != card:
            raise AssertionError(f"phase 12: device {r['device']!r}")
    if (res["counts"]["K5"] or res["counts"]["K1"] < 1
            or res["counts"]["K4"] < 1):
        raise AssertionError(f"phase 12 launches {res['counts']}: K1 and "
                             f"K4 must run and K5 must not")
    res["profiles"] = {}
    for cell in PROFILE_CELLS:
        res["profiles"][cell] = fresh_process(
            fft_profile_worker, f"phase 12's {cell} trace", cell)
    return res


def sweep_counted_body(rank, cases, opts, device, out_path):
    """A rank of a phase-13 sweep world: ``sweep.world_body`` between a
    reset and a read of the K1 and K2 launch counts, which rank 0 appends,
    summed over the world, to :data:`SWEEP_LAUNCHES`."""
    import torch
    import torch.distributed as dist
    from cudecomp_tpu_torch import sweep
    from cudecomp_tpu_torch.ops import cuda_kernels as K
    from cudecomp_tpu_torch.ops import peer_kernels as PK
    K.reset_launch_count()
    PK.reset_launch_counts()
    sweep.world_body(rank, cases, opts, device, out_path)
    n = torch.tensor([K.launch_count, PK.a2a_launch_count])
    dist.all_reduce(n)
    if rank == 0:
        with open(SWEEP_LAUNCHES, "a") as fh:
            fh.write(json.dumps({"world": dist.get_world_size(),
                                 "K1": int(n[0]), "K2": int(n[1])}) + "\n")


def sweep_phase(torch):
    """Phase 13: ``benchmarks/sweep_config_chip.yaml`` (one rank) and
    :data:`SWEEP_FOUR_RANKS` (four ranks sharing the card) through the
    sweep runner, each world one spawn; the rows written as CSV under
    :data:`OUT_DIR`.  Fails on a ``FAIL`` row, on an ``ERROR`` row that is
    no ``CannotRun``, on a row of one rank or of ``pallas_a2a`` that is not
    ``ok``, and where K1 or K2 never ran."""
    from cudecomp_tpu_torch import sweep
    torch.cuda.empty_cache()
    os.makedirs(OUT_DIR, exist_ok=True)
    if os.path.exists(SWEEP_LAUNCHES):
        os.remove(SWEEP_LAUNCHES)
    out = {}
    t0 = time.perf_counter()
    for name, cfg in (("chip", sweep.read_config(SWEEP_CHIP_CONFIG)),
                      ("four_ranks", SWEEP_FOUR_RANKS)):
        rows = sweep.run_sweep(cfg, DEVICE, PEER_RANKS,
                               body=sweep_counted_body)
        sweep.write_csv(rows, os.path.join(OUT_DIR, f"sweep_{name}.csv"))
        for r in rows:
            one_rank = r["pdims"] in ("(1, 1)", "[1, 1]")
            if (r["status"] == "FAIL"
                    or (r["status"] == "ERROR"
                        and not r["error"].startswith("CannotRun"))
                    or ((one_rank or r["method"] == "pallas_a2a")
                        and r["status"] != "ok")):
                raise AssertionError(f"phase 13 {name}: {r}")
        out[name] = rows
    out["s"] = time.perf_counter() - t0
    with open(SWEEP_LAUNCHES) as fh:
        out["launches"] = [json.loads(line) for line in fh]
    k = {key: sum(w[key] for w in out["launches"]) for key in ("K1", "K2")}
    if min(k.values()) < 1:
        raise AssertionError(f"phase 13 launches {out['launches']}")
    out["counts"] = k
    return out


def fresh_process(worker, what, *args, timeout=300):
    """``worker(0, out_path, *args)`` in a fresh spawned process on the
    card; the JSON it wrote to ``out_path``."""
    import tempfile
    from cudecomp_tpu_torch.utils.testing import run_ranks
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.json")
        run_ranks(worker, 1, (out,) + args, timeout, what)
        with open(out) as fh:
            return json.load(fh)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run",
              file=sys.stderr)
        return 1
    import cudecomp_tpu_torch as ct
    from cudecomp_tpu_torch import bench, performance as perf
    from cudecomp_tpu_torch.ops import cuda_kernels as K
    from cudecomp_tpu_torch.ops import dft2 as D
    from cudecomp_tpu_torch.ops import peer_kernels as PK
    from cudecomp_tpu_torch.ops import cg_kernel as C3
    from cudecomp_tpu_torch.ops import spectral_kernel as C2
    from cudecomp_tpu_torch.ops import stencil_kernel as S
    from cudecomp_tpu_torch.utils import cuda_build as cb
    # phases 5 and 6 must run with the K5 knob unset; phase 7 sets it
    # around its K5 cases only
    os.environ.pop("CUDECOMP_TPU_FFT_FUSED2", None)

    # phase 1: the card
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")

    # phase 2: build K1, K4, K5, C2, C3 and the library of K2 and K3 side
    # by side; K0 probes each at load
    torch.cuda.init()
    t0 = time.perf_counter()
    builds = (K.build, S.build, D.build, C2.build, C3.build, PK.build)
    with ThreadPoolExecutor(len(builds) + 3) as pool:
        ptxas = pool.submit(cb.ptxas_report, S.SOURCES)
        c2_ptxas = pool.submit(cb.ptxas_report, C2.SOURCES)
        c3_ptxas = pool.submit(cb.ptxas_report, C3.SOURCES)
        libs = list(pool.map(lambda build: build(), builds))
        k4_ptxas = ptxas.result()
        c2_ptxas = c2_ptxas.result()
        c3_ptxas = c3_ptxas.result()
    print(f"C2 ptxas: {c2_ptxas}")
    print(f"C3 ptxas: {c3_ptxas}")
    print(f"K1, K4, K5, C2, C3 and K2 with K3 built and loaded in "
          f"{time.perf_counter() - t0:.1f} s "
          f"({', '.join(p.name for p in libs)}); K0 probed them "
          f"({cb.probe_launch_count} launches)")

    # phase 3: K1 vs twin
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    worst = kernel_checks(torch, K, gen)
    print(f"K1 bit-equal to its twin on every dtype and shape "
          f"(max abs diff {worst})")

    # phase 4: K4 vs its plain version
    k4_worst, k4_ratio, k4_layouts = stencil_kernel_checks(torch, S, gen)
    print(f"K4 within tolerance of stencil27_ref on every case, layouts "
          f"(dtype, instance, loader) {sorted(k4_layouts)}: max abs diff "
          f"{ {k: f'{v:.3e}' for k, v in k4_worst.items()} }, at most "
          f"{k4_ratio:.3f} of its tolerance")
    k5 = dft2_kernel_checks(torch, D, gen)
    print(f"K5 within {K5_EPS} x max|reference| on every case, forward and "
          f"inverse, clusters of {k5['clusters']} blocks: max abs diff to "
          f"dft2_ref {k5['abs']:.3e} ({k5['ref']:.3e} of max|dft2_ref|), "
          f"{k5['c128']:.3e} of max|complex128 cuFFT|")

    # phase 5: the FFT path
    mp = main_path(torch, ct, K, S, D, cb, bench)
    print(f"512^3 c64 axis-contiguous pdims (1, 1): forward rel L2 err vs "
          f"torch.fft.fftn {mp['rel_l2']:.3e} (<= {RTOL_FFT}); c2c round "
          f"trip max abs err {mp['c2c_err']:.3e}, r2c {mp['r2c_err']:.3e} "
          f"(< {GATE}); launches per c2c round trip {mp['counts']}, K1 per "
          f"r2c round trip {mp['r2c_launches']}")
    torch.cuda.empty_cache()
    c2 = c2_path(torch, ct, K, S, D, cb, gen)
    print(f"C2 spectral3 on the {N}^3 r2c forward's c64 state (strides "
          f"{c2['in_strides']}) and its plane pair: curl, projection and "
          f"masked projection each one launch, in the input's layout, max "
          f"abs diff to the formulas {c2['max_abs_err']:.3e} (within "
          f"{C2_ULPS} ulps of the largest term); bit-equal: "
          f"{c2['bit_equal']}; launches {c2['counts']}")
    torch.cuda.empty_cache()

    # phase 6: the halo and stencil path
    torch.cuda.empty_cache()
    sp = stencil_path(torch, ct, S, K, D, cb)
    print(f"512^3 f32 pdims (1, 1): update_halos bit-equal to the plain "
          f"buffer (launches {sp['halo_launches']}); diffusion_step rel L2 "
          f"err {sp['diffusion_rel_l2']:.3e} (<= {RTOL_DIFFUSION}), 1 K4 "
          f"launch; 27-tap stencil_apply max abs err {sp['stencil_err']:.3e}"
          f", backward {sp['adjoint_err']:.3e}, 1 K4 launch each; solve_cg "
          f"{CG_N}^3: {sp['cg_iters']} iterations, rel residual "
          f"{sp['cg_rel']:.3e}, plain residual {sp['cg_plain_rel']:.3e} "
          f"(<= {CG_GATE}), {sp['cg_launches']} K4 launches, {sp['cg_c3']} "
          f"C3 calls; path launches {sp['launches']}")
    if min(sp["launches"][k] for k in ("K0", "K4")) < 1:
        raise AssertionError(f"the stencil path skipped a kernel: "
                             f"{sp['launches']}")
    if mp["counts"]["K5"] or sp["launches"]["K5"]:
        raise AssertionError("K5 ran with CUDECOMP_TPU_FFT_FUSED2 unset")
    torch.cuda.empty_cache()
    c3 = c3_checks(torch, gen)
    print(f"C3 cg3 on four random {C3_N}^3 f32 vectors: dot, update and "
          f"direction one call each ({c3['calls']}); bit-equal to the "
          f"formulas: {c3['bit_equal']}; sums against float64, relative: "
          f"{ {k: f'{v:.3e}' for k, v in c3['sum_rel'].items()} } (<= 2^-24)")
    torch.cuda.empty_cache()

    # phase 7: the spectral path
    torch.cuda.empty_cache()
    spec = spectral_path(torch, ct, bench, K, S, D, cb)
    by_t = ", ".join(f"{t}: E {e:.2e} eps {d:.2e}"
                     for t, (e, d) in spec["tg_devs"].items())
    print(f"{NS}^3 f32 pdims (1, 1) spectral path: Poisson solve rel L2 err "
          f"{spec['poisson_rel']:.3e}, discrete {spec['discrete_rel']:.3e} "
          f"(<= {RTOL_SPECTRAL}), its plain 7-point Laplacian vs f "
          f"{spec['lap_rel']:.3e} (<= {LAP_GATE}), knob off vs on "
          f"{spec['off_rel']:.3e}; K5 launches per solve (on, on, off) "
          f"{spec['poisson_launches']}; projection solver 2 RK4 steps rel "
          f"err vs R(z)^n u0 {spec['ns_rel']:.3e}, max|div_h u| / max|u| "
          f"{spec['ns_div']:.3e}, K5 per step {spec['ns_launches']}; "
          f"Taylor-Green Re 1600 {TG_STEPS} IF-RK4 steps in "
          f"{spec['tg_s']:.2f} s, largest relative deviation of energy and "
          f"dissipation from docs/tg_validation_n256.csv "
          f"{spec['tg_worst']:.3e} (<= {TG_RTOL}), by t: {by_t}, C2 "
          f"launches {spec['tg_c2']}; one complex-state step "
          f"{spec['tg_c2_complex']} C2 launches, rel L2 from the split "
          f"step {spec['tg_forms_rel']:.3e} (<= {RTOL_SPECTRAL})"
          f"; path launches {spec['launches']}")
    if min(spec["launches"][k] for k in ("K0", "K5")) < 1:
        raise AssertionError(f"the spectral path skipped a kernel: "
                             f"{spec['launches']}")

    # phase 8: timing
    torch.cuda.empty_cache()
    payload = bench.main(N=N, iters=20, n_trials=3, axis_contiguous=True)
    perm_t, clone_ms, nbytes = kernel_timing(torch, K, perf, gen)

    def gbs(ms, nb=nbytes):
        return nb / (ms * 1e-3) / 1e9

    print(f"[{card}] 512^3 c64 c2c round trip: "
          f"{payload['ms_per_direction']:.3f} ms per direction, "
          f"{payload['value']:.1f} GFLOPS")
    for perm, t in perm_t.items():
        print(f"[{card}] K1 cyclic_permute {perm} 512^3 c64: kernel "
              f"{t['kernel']:.3f} ms = {gbs(t['kernel']):.0f} GB/s; twin "
              f"{t['plain']:.3f} ms = {gbs(t['plain']):.0f} GB/s; clone() "
              f"{clone_ms:.3f} ms = {gbs(clone_ms):.0f} GB/s "
              f"(runs {t['runs_ms']})")
    torch.cuda.empty_cache()

    diff = bench.stencil_headline(N=N, iters=20, n_trials=3)
    halo = bench.halo_headline(N=N, width=1, iters=20, n_trials=3)
    cg = bench.cg_headline(N=CG_N, tol=CG_TOL)
    st = stencil_timing(torch, ct, S, perf, gen)
    nb4 = st["nbytes"]
    print(f"[{card}] 512^3 f32 diffusion step: {diff['value']:.3f} ms = "
          f"{diff['gbps']:.0f} GB/s (trials {diff['trials_ms']}); clone() of "
          f"the same 512 MiB {st['clone_ms']:.3f} ms = "
          f"{gbs(st['clone_ms'], nb4):.0f} GB/s")
    for kind in ("face7", "dense"):
        r = st[kind]
        print(f"[{card}] 512^3 f32 {kind} stencil, wrap mode: K4 "
              f"{r['kernel']:.4f} ms = {gbs(r['kernel'], nb4):.0f} GB/s, "
              f"bound {nb4 * 1e3 / HBM_BYTES_PER_S:.4f} ms (bytes), clone() "
              f"{st['clone_ms']:.4f} ms; {r['plan'].instance} instance, "
              f"{r['plan'].loader} loads, x-chunks of {r['plan'].xchunk}, "
              f"{r['plan'].stages} stages ({r['plan'].smem} B shared), ptxas "
              f"{k4_instance(k4_ptxas, r['plan'])}; conv3d (cuDNN, TF32 "
              f"off, pad not timed) {r['conv_ms']:.3f} ms, max abs diff to "
              f"K4 {r['conv_err']:.3e}; stencil27_ref {r['plain']:.3f} ms "
              f"(runs {r['runs_ms']})")
    print(f"[{card}] 512^3 f32 dense stencil_apply {st['apply_ms']:.4f} ms")
    print(f"[{card}] 512^3 f32 update_halos width 1 periodic: "
          f"{halo['value']:.3f} ms = {halo['gbps']:.0f} GB/s of halo slabs "
          f"(trials {halo['trials_ms']})")
    print(f"[{card}] {CG_N}^3 f32 solve_cg tol {CG_TOL:g}: {cg['value']:.1f} "
          f"ms, {cg['iters']} iterations, {cg['ms_per_iter']:.4f} ms per "
          f"iteration, rel residual {cg['rel_residual']:.3e}")
    k0_ms, k0_plain, k0_err, k0_floor = probe_timing(torch, K, cb, perf)
    print(f"[{card}] K0 probe copy (8, 128) f32: {k0_ms * 1e3:.2f} us per "
          f"launch; clone() {k0_plain * 1e3:.2f} us; the launch floor (an "
          f"empty kernel) {k0_floor * 1e3:.2f} us, {k0_floor / k0_ms:.3f} of "
          f"K0's time")
    torch.cuda.empty_cache()
    k5t = dft2_timing(torch, D, perf, gen)
    k5g, k5p = k5t["gbs"], k5t["plan"]
    print(f"[{card}] K5 dft2 {k5t['shape']} c64, clusters of {k5p.cluster} "
          f"blocks ({k5p.smem} B shared each, {k5p.chunk}-column chunks): "
          f"kernel {k5t['kernel']:.4f} ms = {k5g['kernel']:.0f} GB/s; "
          f"clone() of the same bytes {k5t['clone_ms']:.4f} ms = "
          f"{k5g['clone_ms']:.0f} GB/s; bound {k5t['bound_ms']:.4f} ms by "
          f"{k5t['bound_by']} (bytes {k5t['byte_ms']:.4f} ms, FFT flops "
          f"{k5t['flop_ms']:.4f} ms); torch.fft.fftn(dim=(1, 2)) "
          f"{k5t['cufft_ms']:.4f} ms = {k5g['cufft_ms']:.0f} GB/s; dft2_ref "
          f"{k5t['plain']:.3f} ms (runs {k5t['runs_ms']})")
    torch.cuda.empty_cache()
    c2t = c2_timing(torch, ct, perf, gen)
    for name in ("curl", "project_masked"):
        e = c2t[name]
        print(f"[{card}] C2 spectral3 {name} on the {N}^3 r2c state (c64, a "
              f"plane per component): kernel {e['kernel']:.4f} ms = "
              f"{e['nbytes'] / e['kernel'] / 1e6:.0f} GB/s, "
              f"{e['bound_ms'] / e['kernel']:.1%} of its bound "
              f"{e['bound_ms']:.4f} ms ({e['nbytes']} bytes); the formulas "
              f"{e['plain']:.3f} ms (runs {e['runs_ms']})")
    print(f"[{card}] C2: clone() of the state {c2t['clone_ms']:.4f} ms; "
          f"ptxas {c2_ptxas}")
    torch.cuda.empty_cache()
    c3t = c3_timing(torch, perf, gen)
    for name in ("dot", "update", "direction"):
        e = c3t[name]
        print(f"[{card}] C3 cg3 {name} at {C3_N}^3 f32: kernel "
              f"{e['kernel']:.4f} ms = {e['nbytes'] / e['kernel'] / 1e6:.0f} "
              f"GB/s, {e['bound_ms'] / e['kernel']:.1%} of its bound "
              f"{e['bound_ms']:.4f} ms ({e['nbytes']} bytes); the formulas "
              f"{e['plain']:.3f} ms (runs {e['runs_ms']})")
    print(f"[{card}] C3: clone() of one vector {c3t['clone_ms']:.4f} ms; "
          f"ptxas {c3_ptxas}")
    torch.cuda.empty_cache()
    pois = bench.poisson_headline(N=NS)
    tgh = bench.tg_headline(N=NS)
    nsh = bench.ns_headline(N=NS)
    print(f"[{card}] {NS}^3 f32 spectral Poisson solve (r2c split): K5 on "
          f"{pois['on_ms']:.3f} ms, off {pois['off_ms']:.3f} ms (runs "
          f"{pois['runs_ms']})")
    print(f"[{card}] {NS}^3 f32 Taylor-Green IF-RK4 step: {tgh['value']:.3f}"
          f" ms (trials {tgh['trials_ms']})")
    print(f"[{card}] {NS}^3 f32 projection-solver RK4 step: K5 on "
          f"{nsh['on_ms']:.3f} ms, off {nsh['off_ms']:.3f} ms (runs "
          f"{nsh['runs_ms']})")

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    profs = fresh_process(profiles_worker, "phase 8's profile process")
    print(f"[{card}] phase 8's profiles, in a fresh process "
          f"({time.perf_counter() - t0:.1f} s):")
    for what, prof in profs:
        print_profile(card, what, prof)

    # phase 9: the one-sided exchange path, four ranks sharing the card
    peer = peer_phase(torch, perf)
    k2s, pt, ranks = peer["k2s"], peer["times"], peer["ranks"]
    path = {k: sum(r["counts"][k] for r in ranks)
            for k in ("K0", "K1", "K2", "K3", "all_to_all_single")}
    small = {k: sum(r["small"][k] for r in ranks) for k in ("K2", "K3")}
    mps = ("MPS on" if peer["mps"] else "no MPS: the four ranks time-slice "
           "the card")
    print(f"K2s: a2a_smoke bit-equal on a one-rank gloo group (K2 "
          f"{k2s['launches']} exchange in {k2s['cuda_launches']} kernel, "
          f"K1 {k2s['k1']} launch); kernels the profiler saw in one "
          f"call: {k2s['traced']}")
    rel = max(r["rel_l2"] for r in ranks)
    per_k2 = [(r["fft_k2_cuda"] / r["fft_k2"],
               r["fft_k2_memops"] / r["fft_k2"]) for r in ranks]
    print(f"{PEER_RANKS} ranks on one card over gloo (compute mode "
          f"{peer['compute_mode']}, {mps}), {peer['ranks_s']:.1f} s: 512^3 "
          f"c64 PALLAS_A2A round trip at pdims (2, 2): forward rel L2 err vs "
          f"complex128 torch.fft.fftn {rel:.3e} (<= {RTOL_FFT}), round trip "
          f"max abs err "
          f"{max(r['roundtrip_err'] for r in ranks):.3e} (< {GATE}), K2 "
          f"launches per rank {[r['fft_k2'] for r in ranks]}, kernels and "
          f"stream memory operations per K2 exchange {per_k2}"
          f" (the profiler saw {ranks[0]['k2_traced']['kernels']} in one K2 "
          f"exchange and {ranks[0]['k3_traced']['kernels']} in one K3 "
          f"update on rank 0, and no other device record: it records no "
          f"stream memory operation; rank 0's pads after them "
          f"{ranks[0]['k2_traced']['pad']}, "
          f"{ranks[0]['k3_traced']['pad']}); 512^3 f32 "
          f"HaloMethod.PALLAS width 1, periodic and not, bit-equal to the "
          f"plain wrapped-index buffer, K3 launches per rank and update "
          f"{[r['halo_k3'] for r in ranks]}, (kernels, stream memory "
          f"operations) per rank {[r['halo_k3_cuda'] for r in ranks]}; "
          f"path launches {path}; "
          f"{PEER_SMALL} at pdims (1, 4) and (4, 1): K2 ({small['K2']} "
          f"launches) and K3 ({small['K3']}) bit-equal to their plain "
          f"versions over gloo; K2 grew the world's workspace past 1 MiB, "
          f"bit-equal")
    if path["K2"] < 1 or path["K3"] < 1 or path["all_to_all_single"]:
        raise AssertionError(f"the one-sided path skipped a kernel: {path}")
    print(f"[{card}, {mps}] K2 one exchange of a rank's 512^3 c64 pencil "
          f"over pr: {pt['k2_ms']:.3f} ms (slowest rank; ranks "
          f"{pt['ranks_ms']['k2_ms']}); the plain executor on the card, all "
          f"four ranks' blocks: {peer['k2_plain_ms']:.3f} ms; bound "
          f"{peer['k2_bytes'] / HBM_BYTES_PER_S * 1e3:.3f} ms")
    print(f"[{card}, {mps}] PALLAS_A2A c2c round trip at pdims (2, 2): "
          f"{pt['fft_ms_per_direction']:.3f} ms per direction (slowest rank)")
    print(f"[{card}, {mps}] K3 one y-dim update, 512^3 f32 width 1: "
          f"{pt['k3_ms']:.3f} ms; the plain executor {peer['k3_plain_ms']:.3f}"
          f" ms; HaloMethod.PALLAS update of every dim {pt['halo_ms']:.3f} ms")
    print(f"[{card}] K2s (1024, 256) f32: {k2s['ms'] * 1e3:.2f} us; the plain "
          f"executor {k2s['plain_ms'] * 1e3:.2f} us; clone() "
          f"{k2s['clone_ms'] * 1e3:.2f} us")
    lib = [r["k2_library"] for r in ranks]
    k2_lib_ms = (None if any(x["ms"] is None for x in lib)
                 else max(x["ms"] for x in lib))
    if k2_lib_ms is None:
        print(f"K2 library_ms null: dist.all_to_all_single of CUDA tensors "
              f"over gloo refused: {[x['refused'] for x in lib]}")
    else:
        print(f"[{card}, {mps}] K2's one PyTorch call, dist.all_to_all_single"
              f" of the same pencil over the gloo group of pr (CUDA tensors, "
              f"gloo may stage them through the host): {k2_lib_ms:.3f} ms "
              f"(slowest rank; ranks {[x['runs_ms'] for x in lib]})")
    print("K3 library_ms null: no single PyTorch call runs its halo puts "
          "here, since NCCL cannot place four ranks on one card")
    check_tune_ranks(ranks)
    tune_counts = {k: sum(r["tune"]["counts"][k] for r in ranks)
                   for k in ("K2", "K3")}
    for mode in ("transpose", "halo"):
        t = ranks[0]["tune"][mode]
        print(f"[{card}, {mps}] {PEER_RANKS} ranks, autotune of {TUNE_N}^3 "
              f"c64 pdims (0, 0) by {mode} timings in "
              f"{max(r['tune'][mode]['s'] for r in ranks):.2f} s (slowest "
              f"rank): every rank chose {t['best']}; the "
              f"winner's c2c round trip max abs err "
              f"{max(r['tune'][mode]['err'] for r in ranks):.3e} (< {GATE}); "
              f"K2 and K3 launches of both sweeps over the ranks "
              f"{tune_counts}, each kernel bit-equal to its plain version "
              f"on every candidate grid's c64 pencils (max abs diff K2 "
              f"{max(r['tune']['k2_err'] for r in ranks)}, K3 "
              f"{max(r['tune']['k3_err'] for r in ranks)}); rank 0's trial "
              f"table:")
        print(with_card(f"{card}, {mps}", t["report"]))

    # phase 10, in a process of its own: the autotuner, a trace, the
    # performance report
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tp = fresh_process(autotune_worker, "phase 10's process")
    tp["process_s"] = time.perf_counter() - t0
    print(f"[{card}] make_grid 512^3 c64 pdims (0, 0), layouts and halo "
          f"methods swept, in a fresh process ({tp['process_s']:.1f} s in "
          f"all): {tp['tune_s']:.2f} s; K1 launched "
          f"{tp['k1']} times (4 per axis-contiguous round trip); the "
          f"natural layout won and is frozen into the grid; the trial "
          f"table:")
    print(with_card(card, tp["report"]))
    print(f"[{card}] performance report of 3 axis-contiguous 512^3 c64 round "
          f"trips (sum of the four avg {tp['report_ms']:.4f} ms):")
    print(with_card(card, tp["perf_report"]))
    seg = tp["seg"]
    print(f"[{card}] segment_roundtrip axis-contiguous 512^3 c64: total "
          f"{seg['total_ms']:.4f} ms, a2a {seg['a2a_ms']:.4f} ms, local "
          f"{seg['local_ms']:.4f} ms; the four K1 launches alone "
          f"{[round(t, 4) for t in tp['k1_ms']]} ms, sum "
          f"{sum(tp['k1_ms']):.4f} ms")
    at_ = tp["attribution"]
    print(f"[{card}] profile_trace of one round trip: {tp['event_ms']:.4f} ms "
          f"(CUDA events around it, the host's first launch included), "
          f"attributed device time {at_['total_ms']:.4f} ms "
          f"(comm {at_['comm_ms']:.4f}, local {at_['local_ms']:.4f}); K1 "
          f"kernels {[k[:60] for k in tp['k1_names']]}; by range "
          f"{ {k: round(v, 4) for k, v in at_['ranges'].items()} }")

    # phase 11: compat, autotune_fft, gradients, the dryrun, the examples
    torch.cuda.empty_cache()
    p11 = phase11(torch, ct, K, S, D, cb, perf, gen)
    cp, gr, dr, ex = (p11["compat"], p11["grad"], p11["dryrun"],
                      p11["examples"])
    print(f"phase 11 in {p11['s']:.1f} s: compat flow at {COMPAT_N}^3 c64 "
          f"axis-contiguous pdims (1, 1): the four cudecompTranspose* "
          f"calls {cp['k1']} K1 launches, bit-equal to the native ops; "
          f"cudecompUpdateHalosX width 1 periodic on {HALO_N}^3 f32 "
          f"bit-equal to update_halos; workspace sizes {cp['ws']} equal "
          f"geometry's; 128^3 pdims (0, 0) with mapped options copied back "
          f"{cp['tuned']}")
    for n, e in p11["fft_tune"].items():
        extra = (f"; the winner's forward {e['forward_k5']} K5 launch(es), "
                 f"rel L2 vs complex128 fftn {e['rel_l2']:.3e}"
                 if n == FFT_TUNE_N[0] else "")
        print(f"[{card}] autotune_fft {n}^3 c2c split-complex pdims (1, 1) "
              f"in {e['s']:.2f} s, K5 launches by policy "
              f"{e['k5_by_policy']}{extra}; the trial table:")
        print(with_card(card, e["report"]))
    print(f"[{card}] gradients: 512^3 c64 axis-contiguous transpose_x_to_y "
          f"backward {gr['k1_backward']} K1 launch, bit-equal to "
          f"permute().contiguous()'s autograd; forward {gr['k1_fwd_ms']:.4f} "
          f"ms, backward {gr['k1_bwd_ms']:.4f} ms; K5 {K5_GRAD_SHAPE} c64 "
          f"backward {gr['k5_backward']} launches over forward and inverse, "
          f"rel L2 vs torch.fft's complex128 autograd {gr['k5_rel']:.3e}; "
          f"K5 forward {gr['k5_fwd_ms']:.4f} ms, its backward "
          f"{gr['k5_fwd_bwd_ms']:.4f} ms; inverse {gr['k5_inv_ms']:.4f} ms, "
          f"its backward {gr['k5_inv_bwd_ms']:.4f} ms")
    k2_bwd = sum(r["grad"]["k2_backward"] for r in ranks)
    print(f"phase 9's ranks: PALLAS_A2A x->y backward on {PEER_SMALL} at "
          f"pdims (2, 2): {k2_bwd} K2 launches over the ranks, bit-equal to "
          f"the reverse transpose of the cotangent; HaloMethod.PALLAS with "
          f"grad raised: {ranks[0]['grad']['refusal']}")
    print(f"dryrun: entry('cuda') one step, {dr['entry_k1']} K1 launches; "
          f"dryrun_multichip({PEER_RANKS}, 'cuda') on the shared card in "
          f"{dr['multichip_s']:.1f} s: every rank ran {dr['ran']} and "
          f"refused {dr['refused']} (gloo moves CPU tensors)")
    print(f"[{card}] examples at their default sizes, P = 1: "
          + "; ".join(f"{k} {v['s']:.2f} s (launches {v['launches']})"
                      for k, v in ex.items()))
    p11_k1 = (cp["k1"] + gr["k1_backward"] + dr["entry_k1"]
              + sum(v["launches"]["K1"] for v in ex.values()))
    p11_k5 = (p11["fft_tune"][FFT_TUNE_N[0]]["k5_launches"] + gr["k5_backward"]
              + sum(v["launches"]["K5"] for v in ex.values()))
    p11_k4 = sum(v["launches"]["K4"] for v in ex.values())
    p11_c2 = sum(v["launches"]["C2"] for v in ex.values())

    # phase 12: the bench table, in a process of its own
    bt = bench_phase(torch, card)
    print(f"phase 12: the bench table in {bt['s']:.1f} s (a fresh process; "
          f"launches {bt['counts']}), every gate passed; K1 bit-equal to "
          f"its twin at {len(BENCH_K1_SHAPES)} of its shapes there "
          f"(max abs err {bt['k1_err']}); {BENCH_FULL_OUT}:")
    for r in bt["records"]:
        extra = {k: r[k] for k in ("ms_per_direction", "err", "gate_err",
                                   "timed_err", "local_gbps_per_chip",
                                   "clone_gbps", "iters", "ms_per_iter",
                                   "gbps") if k in r}
        print(f"[{r['device']}] {r['metric']}: {r['value']:.4f} {r['unit']}"
              f"; peak {r['max_memory_allocated_gib']:.2f} GiB; {extra}")
    for cell, prof in bt["profiles"].items():
        print_profile(card, f"one {cell} c2c round trip (fresh process)",
                      prof)

    # phase 13: the sweep runner, one rank and four ranks sharing the card
    sw = sweep_phase(torch)
    print(f"phase 13: the sweep in {sw['s']:.1f} s, K1 and K2 launches per "
          f"world {sw['launches']}; every one-rank and pallas_a2a row ok, "
          f"the rest CannotRun ({OUT_DIR}/sweep_*.csv):")
    for name in ("chip", "four_ranks"):
        for r in sw[name]:
            print(f"[{card}] sweep {name}: " + ",".join(
                str(r[c]) for c in ("gdims", "pdims", "method", "dtype",
                                    "axis_contiguous", "status",
                                    "roundtrip_ms", "a2a_ms", "local_ms",
                                    "timing", "error")))

    t120 = perm_t[(1, 2, 0)]
    ms_to_bound = 1e3 / HBM_BYTES_PER_S
    k4_flops = 2 * 27 * N ** 3
    c2_launches = (c2["counts"]["C2"] + spec["tg_c2"] + spec["tg_c2_complex"]
                   + p11_c2)

    def c3_calls(entry):
        """One C3 entry's calls over the phases that count them."""
        key = f"C3.{entry}"
        return (sp["launches"][key] + c3["calls"][entry]
                + sum(v["launches"][key] for v in ex.values())
                + bt["counts"][key])
    kernels = {"kernels": [
        {"name": "K0 probe copy",
         "route": "cuda",
         "source": "cudecomp_tpu_torch/csrc/probe.cu",
         "replaces": "cudecomp_tpu/ops/pallas_kernels.py:142",
         "launches": (mp["counts"]["K0"] + c2["counts"]["K0"]
                      + sp["launches"]["K0"] + spec["launches"]["K0"]
                      + path["K0"] + bt["counts"]["K0"]),
         "max_abs_err": k0_err,
         "ms": k0_ms,
         "plain_ms": k0_plain,
         "bound_ms": 2 * 8 * 128 * 4 * ms_to_bound,
         "bound_by": "bytes",
         "launch_floor_ms": k0_floor,
         "library_ms": k0_plain},
        {"name": "K1 transpose2d (cyclic local permute)",
         "route": "cuda",
         "source": "cudecomp_tpu_torch/csrc/transpose2d.cu",
         "replaces": "cudecomp_tpu/ops/pallas_kernels.py:299",
         "launches": (mp["launches"] + tp["k1"] + p11_k1
                      + bt["counts"]["K1"] + sw["counts"]["K1"]),
         "backward_launches": gr["k1_backward"],
         "max_abs_err": max(worst, bt["k1_err"]),
         "ms": t120["kernel"],
         "plain_ms": t120["plain"],
         "bound_ms": nbytes * ms_to_bound,
         "bound_by": "bytes",
         "library_ms": t120["plain"]},
        {"name": "K4 stencil27 (27-point stencil)",
         "route": "cuda",
         "source": "cudecomp_tpu_torch/csrc/stencil27.cu",
         "replaces": "cudecomp_tpu/ops/stencil.py:282",
         "launches": sp["launches"]["K4"] + p11_k4 + bt["counts"]["K4"],
         "max_abs_err": k4_worst["float32"],
         "ms": st["kernel"],
         "plain_ms": st["plain"],
         "bound_ms": max(nb4 * ms_to_bound,
                         k4_flops / FP32_FLOP_PER_S * 1e3),
         "bound_by": ("bytes" if nb4 / HBM_BYTES_PER_S
                      >= k4_flops / FP32_FLOP_PER_S else "operations"),
         "library_ms": st["conv_ms"]},
        {"name": "K5 dft2 (fused 2-axis DFT)",
         "route": "cuda",
         "source": "cudecomp_tpu_torch/csrc/dft2.cu",
         "replaces": "cudecomp_tpu/ops/mxu_fft.py:392",
         "launches": spec["launches"]["K5"] + p11_k5,
         "backward_launches": gr["k5_backward"],
         "max_abs_err": k5["abs"],
         "ms": k5t["kernel"],
         "plain_ms": k5t["plain"],
         "bound_ms": k5t["bound_ms"],
         "bound_by": k5t["bound_by"],
         "library_ms": k5t["cufft_ms"]},
        # both C2 rows count the launches of both entries
        {"name": "C2 spectral3 curl (i k x v)",
         "route": "cuda",
         "source": "cudecomp_tpu_torch/csrc/spectral3.cu",
         "replaces": None,
         "launches": c2_launches,
         "max_abs_err": c2["max_abs_err"],
         "ms": c2t["curl"]["kernel"],
         "plain_ms": c2t["curl"]["plain"],
         "bound_ms": c2t["curl"]["bound_ms"],
         "bound_by": "bytes",
         "library_ms": None},
        {"name": "C2 spectral3 masked projection (m v - k (k . m v)/|k|^2)",
         "route": "cuda",
         "source": "cudecomp_tpu_torch/csrc/spectral3.cu",
         "replaces": None,
         "launches": c2_launches,
         "max_abs_err": c2["max_abs_err"],
         "ms": c2t["project_masked"]["kernel"],
         "plain_ms": c2t["project_masked"]["plain"],
         "bound_ms": c2t["project_masked"]["bound_ms"],
         "bound_by": "bytes",
         "library_ms": None},
        # each C3 row counts its own entry's calls, and the kernels they
        # launched: the pass, and finish_kernel after dot and update
        *({"name": f"C3 cg3 {name}",
           "route": "cuda",
           "source": "cudecomp_tpu_torch/csrc/cg3.cu",
           "replaces": None,
           "calls": c3_calls(name),
           "launches": c3_calls(name) * len(C3.KERNELS[name]),
           "kernels": C3.KERNELS[name],
           "bit_equal": c3["bit_equal"],
           "sum_rel": c3["sum_rel"],
           "ms": c3t[name]["kernel"],
           "plain_ms": c3t[name]["plain"],
           "bound_ms": c3t[name]["bound_ms"],
           "bound_by": "bytes",
           "library_ms": None} for name in ("dot", "update", "direction")),
        {"name": "K2 peer_a2a (one-sided all-to-all, 4 ranks on one card)",
         "route": "cuda",
         "source": "cudecomp_tpu_torch/csrc/peer.cu",
         "replaces": "cudecomp_tpu/ops/pallas_kernels.py:183",
         "launches": (path["K2"] + tune_counts["K2"] + k2_bwd
                      + sw["counts"]["K2"]),
         "backward_launches": k2_bwd,
         "max_abs_err": max(max(r["k2_err"], r["tune"]["k2_err"])
                            for r in ranks),
         "ms": pt["k2_ms"],
         "plain_ms": peer["k2_plain_ms"],
         "bound_ms": peer["k2_bytes"] / HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes",
         "library_ms": k2_lib_ms},
        {"name": "K2s a2a_smoke (K2 at P = 1)",
         "route": "cuda",
         "source": "cudecomp_tpu_torch/csrc/peer.cu",
         "replaces": "cudecomp_tpu/ops/pallas_kernels.py:241",
         "launches": k2s["launches"],
         "max_abs_err": k2s["err"],
         "ms": k2s["ms"],
         "plain_ms": k2s["plain_ms"],
         "bound_ms": k2s["bytes"] / HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes",
         "library_ms": k2s["clone_ms"]},
        {"name": "K3 peer_halo (one-sided halo ring, 4 ranks on one card)",
         "route": "cuda",
         "source": "cudecomp_tpu_torch/csrc/peer.cu",
         "replaces": "cudecomp_tpu/ops/pallas_kernels.py:571",
         "launches": path["K3"] + tune_counts["K3"],
         "max_abs_err": max(max(r["halo_err"], r["tune"]["k3_err"])
                            for r in ranks),
         "ms": pt["k3_ms"],
         "plain_ms": peer["k3_plain_ms"],
         "bound_ms": peer["k3_bytes"] / HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes",
         "library_ms": None},
    ]}
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
