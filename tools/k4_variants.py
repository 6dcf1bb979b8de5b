#!/usr/bin/env python3
"""K4 beside its first design and two simpler shapes of the same 27-point
stencil, on one card, and the first design with parts taken out.

    python3 tools/k4_variants.py [--n 512] [--ablate] [--layouts]
                                 [--out FILE]

Prints what ``nvcc -Xptxas -v`` reports for every kernel instance of
``cudecomp_tpu_torch/csrc/stencil27.cu`` (registers, spills), builds K4
and the three variants of ``tools/k4_variants.cu`` (0: K4's first design,
a ``cp.async`` plane ring with one barrier per plane; 1: one thread per
output; 2: one thread per column of outputs along x), holds K4 and each
variant to ``stencil27_ref`` on ragged shapes in every input mode, then
times, at ``n``^3, the 7-tap face set and a dense 27-tap set in three
input modes:

  * ``wrap``: ghost-plane mode with every dim wrapping, what the one-card
    path launches;
  * ``x-ghost``: ghost-plane mode with x between ghost planes, y and z
    wrapping;
  * ``valid``: valid mode over the ``(n+2)^3`` extended block;

in float32 and float64 (K4 and the three variants) and in bfloat16, wrap
mode (K4 alone: the variants take 4- and 8-byte types).  Each row has its
own bound: one read of the input (with its ghost planes, or the extended
block) and one write of the output at 3.35 TB/s.  Each case is timed in
turns (one pass over the list, one back; CUDA events, mean of 5 trials of
10 calls after 2 warm-up calls), beside ``clone()`` of the field.

With ``--layouts`` it also times K4 at ``n``^3 float32 in wrap mode, for
both tap sets, with other layouts than ``stencil_plan``'s, in turns:
``cp.async`` loads instead of TMA, x-chunks of 16, 64 and 256 planes,
and 4 or 12 stages (12 leave room for three blocks per SM, not four).

With ``--ablate`` it also builds the first design with one part taken out
or changed (the macros of ``tools/k4_variants.cu``) and times those at
``n``^3 float32 in wrap mode, for both tap sets, in turns:

  * ``no_fma``: no tap arithmetic (each output is its centre cell);
  * ``no_sync``: no per-plane ``__syncthreads()`` (wrong results);
  * ``vec16``: 16-byte copies of each ring row's aligned interior, 4-byte
    ones for its two ring columns;
  * ``xchunk64``, ``xchunk128``, ``xchunk_mx``: x-chunks of 64, 128 and
    all ``n`` planes instead of 32.

Prints the card's name and power limit, one line per case, and the results
as one JSON object, which ``--out`` also writes to a file.  The port never
calls the variants.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from statistics import mean

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (HBM_BYTES_PER_S, K4_EPS, card_line,  # noqa: E402
                        k4_weights)

SOURCE = Path(__file__).resolve().with_name("k4_variants.cu")
VARIANTS = {0: "first", 1: "naive", 2: "march"}
MODES = {"wrap": (True, True, True), "x-ghost": (False, True, True),
         "valid": None}
#: k4_variant_stencil27: the variant, then the first design's
#: cudecomp_stencil27 arguments (u, out, six ghost planes, mx, my, mz,
#: wrap, valid, weights, element bytes, stream)
VARIANT_ARGTYPES = ((ctypes.c_int,) + (ctypes.c_void_p,) * 8
                    + (ctypes.c_int64,) * 3
                    + (ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p))
#: nvcc -D flags of the first design per ablation
ABLATIONS = {"base": (), "no_fma": ("-DK4_NO_FMA",),
             "no_sync": ("-DK4_NO_SYNC",), "vec16": ("-DK4_VEC16",),
             "xchunk64": ("-DK4_XCHUNK=64",),
             "xchunk128": ("-DK4_XCHUNK=128",),
             "xchunk_mx": ("-DK4_XCHUNK=0",)}


def build_variants(tmp: Path, name: str, defines=()):
    """``k4_variant_stencil27`` of ``tools/k4_variants.cu`` built with
    ``defines``, with K0's file as ``utils/cuda_build`` builds a library."""
    from cudecomp_tpu_torch.utils import cuda_build
    lib = tmp / f"libk4_{name}.so"
    subprocess.run([str(cuda_build.nvcc_path()), *cuda_build.NVCC_FLAGS,
                    *defines, "-o", str(lib),
                    str(cuda_build.CSRC_DIR / cuda_build.PROBE_SOURCE),
                    str(SOURCE)], check=True, capture_output=True,
                   text=True)
    fn = ctypes.CDLL(str(lib)).k4_variant_stencil27
    fn.argtypes = list(VARIANT_ARGTYPES)
    fn.restype = ctypes.c_int
    return fn


def in_turns(launchers: dict, t) -> dict:
    """``{name: [ms, ms]}``: each launcher timed by ``t`` in one pass over
    the list and one back."""
    names = list(launchers)
    runs = {n: [] for n in names}
    for n in names + names[::-1]:
        runs[n].append(t(launchers[n]))
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--ablate", action="store_true",
                    help="also time the first design with parts taken out")
    ap.add_argument("--layouts", action="store_true",
                    help="also time K4 with other layouts than its plan's")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("CUDA is not available: nothing to time", file=sys.stderr)
        return 1
    from cudecomp_tpu_torch import performance as perf
    from cudecomp_tpu_torch.ops import stencil_kernel as S
    from cudecomp_tpu_torch.utils import cuda_build

    card = card_line()
    print(f"card: {card}")
    torch.cuda.init()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    names = ABLATIONS if args.ablate else {"base": ()}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(
            len(names) + 1) as pool:
        built = {n: pool.submit(build_variants, Path(tmp), n, d)
                 for n, d in names.items()}
        report = pool.submit(cuda_build.ptxas_report, S.SOURCES)
        S.build()
        for kernel, info in report.result():
            print(f"ptxas K4 {kernel}: {info}")
        fns = {n: f.result() for n, f in built.items()}
    lib = fns["base"]

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float64).to(dtype)

    def variant(v, u, w, ghosts, fn=lib):
        """Launch variant ``v`` as ``S.stencil27`` launches K4."""
        valid = ghosts is None
        ext = tuple(n - 2 for n in u.shape) if valid else tuple(u.shape)
        planes, wrap = [None] * 6, 0
        for d, g in enumerate(ghosts or (None,) * 3):
            if g is None:
                wrap |= 1 << d
            else:
                planes[2 * d:2 * d + 2] = g
        out = torch.empty(ext, dtype=u.dtype, device=u.device)
        wbuf = (ctypes.c_double * 27)(*S.as_weights(w).ravel().tolist())
        err = fn(v, u.data_ptr(), out.data_ptr(),
                 *[p.data_ptr() if p is not None else None for p in planes],
                 *ext, wrap, int(valid), ctypes.addressof(wbuf),
                 u.element_size(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"variant {v} failed with CUDA error {err}")
        return out

    def inputs(shape, dtype, mode):
        """(block, ghosts) of one input mode; "all-ghost" (every dim
        between ghost planes) is checked, not timed."""
        if mode == "valid":
            return rand(tuple(n + 2 for n in shape), dtype), None
        periods = MODES.get(mode, (False, False, False))
        u = rand(shape, dtype)
        ghosts = []
        for d in range(3):
            plane = list(shape)
            plane[d] = 1
            ghosts.append(None if periods[d] else
                          (rand(plane, dtype), rand(plane, dtype)))
        return u, ghosts

    def tensors(x, ghosts):
        return [x] + [p for g in (ghosts or ()) if g for p in g]

    def check(got, want, x, ghosts, w, what):
        scale = float(np.abs(w).sum()) * max(
            float(t.abs().max()) for t in tensors(x, ghosts))
        tol = K4_EPS[str(x.dtype).split(".")[1]] * scale
        err = float((got.double() - want.double()).abs().max())
        if got.shape != want.shape or not err <= tol:
            raise AssertionError(f"{what}: max abs diff {err} > {tol}")
        return err

    # every mode (with all-ghost edges too) on ragged shapes
    worst = 0.0
    for dtype in (torch.float32, torch.float64):
        for shape in ((7, 33, 65), (1, 5, 3), (2, 2, 2), (40, 9, 70)):
            for mode in ("wrap", "x-ghost", "valid", "all-ghost"):
                for kind in ("face7", "dense"):
                    w = k4_weights(kind, seed=5)
                    x, ghosts = inputs(shape, dtype, mode)
                    want = S.stencil27_ref(x, w, ghosts)
                    worst = max(worst, check(
                        S.stencil27(x, w, ghosts), want, x, ghosts, w,
                        f"K4 {dtype} {shape} {mode} {kind}"))
                    for v in VARIANTS:
                        worst = max(worst, check(
                            variant(v, x, w, ghosts), want, x, ghosts, w,
                            f"variant {v} {dtype} {shape} {mode} {kind}"))
                    if mode == "wrap":
                        fn = fns.get("vec16")
                        if fn is not None:
                            worst = max(worst, check(
                                variant(0, x, w, ghosts, fn), want, x,
                                ghosts, w, f"vec16 {dtype} {shape} {kind}"))
    print(f"K4 and the variants within tolerance of stencil27_ref on every "
          f"ragged case: max abs diff {worst:.3e}")

    n = args.n
    shape = (n, n, n)

    def t(fn):
        return mean(perf.time_fn(fn, n_warmup=2, n_trials=5, iters=10)) * 1e3

    cases = [(dt, kind, mode) for dt in (torch.float32, torch.float64)
             for kind in ("face7", "dense") for mode in MODES]
    cases += [(torch.bfloat16, kind, "wrap") for kind in ("face7", "dense")]
    rows = []
    for dtype, kind, mode in cases:
        w = k4_weights(kind, seed=5)
        x, ghosts = inputs(shape, dtype, mode)
        want = S.stencil27_ref(x, w, ghosts)
        calls = {"K4": lambda: S.stencil27(x, w, ghosts)}
        if x.element_size() > 2:
            for v, name in VARIANTS.items():
                calls[name] = (lambda v=v: variant(v, x, w, ghosts))
        errs = {k: check(fn(), want, x, ghosts, w, f"{k} {dtype} {mode} "
                         f"{kind}") for k, fn in calls.items()}
        del want
        runs = in_turns(calls, t)
        ms = {k: mean(r) for k, r in runs.items()}
        nbytes = (sum(p.numel() for p in tensors(x, ghosts)) + n ** 3) \
            * x.element_size()
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        dname = str(dtype).split(".")[1]
        row = {"dtype": dname, "taps": kind, "mode": mode, "ms": ms,
               "runs_ms": runs, "bound_ms": bound, "bytes": nbytes,
               "max_abs_err": errs}
        if mode == "wrap" and x.element_size() == 4:
            row["instance"] = S.stencil_plan(w, False, (True,) * 3, dtype,
                                             shape)._asdict()
        rows.append(row)
        print(f"[{card}] {n}^3 {dname} {kind:5s} {mode:7s}: "
              + ", ".join(f"{k} {m:.4f} ms" for k, m in ms.items())
              + f"; bound {bound:.4f} ms (runs {runs})")
        del x, ghosts
    clone = {}
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        u = rand(shape, dtype)
        clone[str(dtype).split(".")[1]] = t(u.clone)
        del u
    print(f"[{card}] clone() of the {n}^3 field: "
          + ", ".join(f"{k} {m:.4f} ms" for k, m in clone.items()))

    ablation = {}
    if args.ablate:
        for kind in ("face7", "dense"):
            w = k4_weights(kind, seed=5)
            x, ghosts = inputs(shape, torch.float32, "wrap")
            runs = in_turns({a: (lambda fn=fn: variant(0, x, w, ghosts, fn))
                             for a, fn in fns.items()}, t)
            ablation[kind] = {a: {"ms": mean(r), "runs_ms": r}
                              for a, r in runs.items()}
            base = ablation[kind]["base"]["ms"]
            for a, r in ablation[kind].items():
                print(f"[{card}] first-design K4 {n}^3 f32 {kind} wrap, {a}: "
                      f"{r['ms']:.4f} ms ({r['ms'] - base:+.4f} ms; runs "
                      f"{r['runs_ms']})")
            del x, ghosts
    layouts = {}
    if args.layouts:
        x, ghosts = inputs(shape, torch.float32, "wrap")
        for kind in ("face7", "dense"):
            w = k4_weights(kind, seed=5)
            plan = S.stencil_plan(w, False, 7, x.dtype, shape)
            other = {"plan": plan,
                     "cp.async": plan._replace(loader="cp.async")}
            for xc in (16, 64, 256):
                other[f"xchunk{xc}"] = plan._replace(
                    xchunk=xc, grid=plan.grid[:2] + (-(-n // xc),))
            for st in (4, 12):
                other[f"stages{st}"] = plan._replace(
                    stages=st, smem=S.smem_bytes(x.dtype, st))
            want = S.stencil27_ref(x, w, ghosts)
            for name, p in other.items():
                check(S.stencil27(x, w, ghosts, plan=p), want, x, ghosts, w,
                      f"K4 {kind} layout {name}")
            del want
            runs = in_turns({name: (lambda p=p: S.stencil27(x, w, ghosts,
                                                            plan=p))
                             for name, p in other.items()}, t)
            layouts[kind] = {name: {"ms": mean(r), "runs_ms": r,
                                    "plan": other[name]._asdict()}
                             for name, r in runs.items()}
            for name, r in layouts[kind].items():
                print(f"[{card}] K4 {n}^3 f32 {kind} wrap, layout {name}: "
                      f"{r['ms']:.4f} ms (runs {r['runs_ms']})")
        del x, ghosts
    result = {"card": card, "n": n, "ptxas": report.result(),
              "clone_ms": clone, "ragged_max_abs_err": worst, "cases": rows,
              "ablation": ablation, "layouts": layouts}
    line = json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
