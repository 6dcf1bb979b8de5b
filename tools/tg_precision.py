#!/usr/bin/env python3
"""Taylor-Green at 256^3, Re 1600, IF-RK4, dt 2e-3 to t = 0.5, in float32
(split-complex planes, as chip_smoke.py runs it) and in float64 (complex
state) on one GPU: the relative deviation of each run's kinetic energy and
dissipation from docs/tg_validation_n256.csv (the JAX package's float32
curve) every 0.1 flow-time units, and of the float32 run from the float64
one.  It separates the port's float32 rounding from the committed curve's
own.

    python3 tools/tg_precision.py [--n 256] [--out tg_precision.json]
"""

import argparse
import csv
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def reference(n):
    out = {}
    with open(ROOT / "docs" / f"tg_validation_n{n}.csv") as fh:
        for row in csv.DictReader(fh):
            out[round(float(row["t"]) / 0.1)] = (
                float(row["kinetic_energy"]), float(row["dissipation"]))
    return out


def run(ct, torch, n, split, dtype, steps=250, dt=2e-3):
    grid = ct.make_grid(ct.GridConfig(gdims=(n,) * 3, pdims=(1, 1)), "cuda")
    tg = ct.models.TaylorGreenSolver(grid=grid, nu=1.0 / 1600.0,
                                     split_complex=split)
    uh, f = tg.setup(dtype)
    curve = {}
    t0 = time.perf_counter()
    for i in range(steps + 1):
        if i % 50 == 0:
            curve[i // 50] = (float(tg.energy(uh, f)),
                              float(tg.dissipation(uh, f)))
        if i < steps:
            uh = tg.step(uh, f, dt)
    torch.cuda.synchronize()
    return curve, time.perf_counter() - t0


def rel(a, b):
    return [abs(x - y) / abs(y) for x, y in zip(a, b)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("tg_precision: needs CUDA", file=sys.stderr)
        return 1
    import cudecomp_tpu_torch as ct
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    ref = reference(args.n)
    f32, s32 = run(ct, torch, args.n, True, torch.float32)
    f64, s64 = run(ct, torch, args.n, False, torch.float64)
    rows = []
    for k in sorted(f32):
        rows.append({"t": round(0.1 * k, 1),
                     "f32_vs_csv": rel(f32[k], ref[k]),
                     "f64_vs_csv": rel(f64[k], ref[k]),
                     "f32_vs_f64": rel(f32[k], f64[k]),
                     "f64_energy": f64[k][0], "f64_dissipation": f64[k][1]})
    out = {"card": card, "n": args.n, "f32_s": s32, "f64_s": s64,
           "rows": rows}
    for r in rows:
        print(f"[{card}] t={r['t']}: (energy, dissipation) rel dev f32 vs "
              f"csv {r['f32_vs_csv'][0]:.3e} {r['f32_vs_csv'][1]:.3e}; f64 "
              f"vs csv {r['f64_vs_csv'][0]:.3e} {r['f64_vs_csv'][1]:.3e}; "
              f"f32 vs f64 {r['f32_vs_f64'][0]:.3e} {r['f32_vs_f64'][1]:.3e}")
    print(f"[{card}] 250 steps: f32 {s32:.2f} s, f64 {s64:.2f} s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
