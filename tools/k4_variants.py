#!/usr/bin/env python3
"""K4 beside two simpler shapes of the same 27-point stencil, on one card.

    python3 tools/k4_variants.py [--n 512] [--out FILE]

Builds K4 (``cudecomp_tpu_torch/csrc/stencil27.cu``) and the two variants
of ``tools/k4_variants.cu`` (one thread per output; one thread per column
of outputs along x with the neighbourhood in registers), holds each variant
to ``stencil27_ref`` on ragged shapes in every input mode and at the full
size, then times K4, variant 1 and variant 2 at ``n``^3 float32 for the
7-tap face set and a dense 27-tap set, in three input modes:

  * ``wrap``: ghost-plane mode with every dim wrapping, what the one-card
    path launches;
  * ``x-ghost``: ghost-plane mode with x between ghost planes, y and z
    wrapping;
  * ``valid``: valid mode over the ``(n+2)^3`` extended block.

Each case is timed K4, 1, 2, 2, 1, K4 in one process (CUDA events, mean of
5 trials of 10 calls after 2 warm-up calls), beside ``clone()`` of the
field.  Prints the card's name and power limit, one line per case, and the
results as one JSON object, which ``--out`` also writes to a file.  The
port never calls the variants.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path
from statistics import mean

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import K4_EPS, card_line, k4_weights  # noqa: E402

SOURCE = str(Path(__file__).resolve().with_name("k4_variants.cu"))
VARIANTS = {1: "naive", 2: "march"}
MODES = {"wrap": (True, True, True), "x-ghost": (False, True, True),
         "valid": None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=512)
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
    S.build()
    lib = cuda_build.load(
        "k4_variants", (SOURCE,),
        (("k4_variant_stencil27", (ctypes.c_int,) + S.SIGNATURES[0][1],
          ctypes.c_int),))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float64).to(dtype)

    def variant(v, u, w, ghosts):
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
        err = lib.k4_variant_stencil27(
            v, u.data_ptr(), out.data_ptr(),
            *[p.data_ptr() if p is not None else None for p in planes],
            *ext, wrap, int(valid), ctypes.addressof(wbuf),
            S.kernel_elem_bytes(u.dtype),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"variant {v} failed: "
                               f"{lib.cudecomp_cuda_error_string(err)}")
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

    def check(got, want, x, ghosts, w, what):
        scale = float(np.abs(w).sum()) * max(
            float(t.abs().max())
            for t in [x] + [p for g in (ghosts or ()) if g for p in g])
        tol = K4_EPS[str(x.dtype).split(".")[1]] * scale
        err = float((got - want).abs().max())
        if got.shape != want.shape or not err <= tol:
            raise AssertionError(f"{what}: max abs diff {err} > {tol}")
        return err

    # every mode (with all-ghost edges too) on ragged shapes, both dtypes
    worst = 0.0
    for dtype in (torch.float32, torch.float64):
        for shape in ((7, 33, 65), (1, 5, 3), (2, 2, 2), (40, 9, 70)):
            for mode in ("wrap", "x-ghost", "valid", "all-ghost"):
                for kind in ("face7", "dense"):
                    w = k4_weights(kind, seed=5)
                    x, ghosts = inputs(shape, dtype, mode)
                    want = S.stencil27_ref(x, w, ghosts)
                    for v in VARIANTS:
                        worst = max(worst, check(
                            variant(v, x, w, ghosts), want, x, ghosts, w,
                            f"variant {v} {dtype} {shape} {mode} {kind}"))
    print(f"variants within tolerance of stencil27_ref on every ragged "
          f"case: max abs diff {worst:.3e}")

    n = args.n
    shape = (n, n, n)
    nbytes = 2 * n ** 3 * 4

    def t(fn):
        return mean(perf.time_fn(fn, n_warmup=2, n_trials=5, iters=10)) * 1e3

    rows = []
    for kind in ("face7", "dense"):
        w = k4_weights(kind, seed=5)
        for mode in MODES:
            x, ghosts = inputs(shape, torch.float32, mode)
            want = S.stencil27_ref(x, w, ghosts)
            errs = {"K4": check(S.stencil27(x, w, ghosts), want, x, ghosts,
                                w, f"K4 {mode} {kind}")}
            for v, name in VARIANTS.items():
                errs[name] = check(variant(v, x, w, ghosts), want, x, ghosts,
                                   w, f"variant {v} {mode} {kind}")
            del want
            calls = {"K4": lambda: S.stencil27(x, w, ghosts)}
            for v, name in VARIANTS.items():
                calls[name] = (lambda v=v: variant(v, x, w, ghosts))
            runs = {k: [] for k in calls}
            for k in ("K4", "naive", "march", "march", "naive", "K4"):
                runs[k].append(t(calls[k]))
            ms = {k: mean(r) for k, r in runs.items()}
            row = {"taps": kind, "mode": mode, "ms": ms, "runs_ms": runs,
                   "gbs": {k: nbytes / (m * 1e-3) / 1e9
                           for k, m in ms.items()},
                   "max_abs_err": errs}
            rows.append(row)
            print(f"[{card}] {n}^3 f32 {kind:5s} {mode:7s}: K4 "
                  f"{ms['K4']:.3f} ms, naive {ms['naive']:.3f} ms, march "
                  f"{ms['march']:.3f} ms (runs {runs})")
            del x, ghosts
    u = torch.randn(shape, generator=gen, device="cuda")
    clone_ms = t(u.clone)
    print(f"[{card}] clone() of the same {nbytes // 2 >> 20} MiB: "
          f"{clone_ms:.3f} ms = {nbytes / (clone_ms * 1e-3) / 1e9:.0f} GB/s")
    result = {"card": card, "n": n, "clone_ms": clone_ms,
              "ragged_max_abs_err": worst, "cases": rows}
    line = json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
