#!/usr/bin/env python3
"""How many kernel records a torch.profiler session keeps, as a process
ages on the card.

    python3 tools/profiler_loss.py [--seconds 150] [--out PATH]

Runs the 512^3 c64 axis-contiguous transpose round trip (four K1 launches)
back to back, and at a few moments traces one round trip in a profiler
session: as the process's first session, then after tens of seconds of
round trips and earlier sessions, with the window held open 0.5 s before
or after the round trip, and through ``performance.profile_trace``.  For
each session it prints the K1 kernels the trace kept out of the four its
launches made (``performance.device_op_attribution``'s
``lost_launches``), with the card's name and power limit.  Exits 1
without CUDA.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=150.0)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profiler_loss: CUDA is not available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    import cudecomp_tpu_torch as ct
    from cudecomp_tpu_torch import performance as perf
    from cudecomp_tpu_torch.ops import cuda_kernels as K

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    K.build()
    n = args.n
    grid = ct.make_grid(ct.GridConfig(gdims=(n,) * 3, pdims=(1, 1),
                                      transpose_axis_contiguous=(True,) * 3),
                        "cuda")
    x = torch.randn((n,) * 3, dtype=torch.complex64, device="cuda")

    def roundtrip():
        b = ct.transpose_x_to_y(grid, x)
        b = ct.transpose_y_to_z(grid, b)
        b = ct.transpose_z_to_y(grid, b)
        return ct.transpose_y_to_x(grid, b)

    def session(head, tail):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(head)
            roundtrip()
            torch.cuda.synchronize()
            time.sleep(tail)
        return sum(1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "transpose2d_kernel" in e.name)

    def traced():
        with tempfile.TemporaryDirectory() as d:
            with perf.profile_trace(d):
                roundtrip()
            a = perf.device_op_attribution(d)
        return 4 - a["lost_launches"]

    t0 = time.time()
    roundtrip()
    torch.cuda.synchronize()
    rows = []
    stops = [0.0] + [args.seconds * f for f in (0.25, 0.5, 0.75, 1.0)]
    for stop in stops:
        while time.time() - t0 < stop:
            for _ in range(10):
                roundtrip()
            torch.cuda.synchronize()
        row = {"s": round(time.time() - t0, 1),
               "kept_of_4": {"plain": session(0.0, 0.0),
                             "head 0.5 s": session(0.5, 0.0),
                             "tail 0.5 s": session(0.0, 0.5),
                             "profile_trace": traced()}}
        rows.append(row)
        print(f"[{card}] after {row['s']} s: K1 records kept of 4 per "
              f"session {row['kept_of_4']}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": card, "n": n, "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
