"""The readings a cell's limits are set from: the check's numbers over
many seeds, for the program (the lower readings) and for its control, the
bfloat16 reference in the program's place (the upper readings).

    python3 -m bench_torch.readings --workload c2c1024.ac --seeds 1-12 \\
        --control-seeds 1-3 --seconds 3 --out chiprun_out/readings.json

One process: each seed builds its run anew (set-up, a short window at the
cell's own sizes, the check) and frees it before the next.  The
benchmark's own runs never run this.  Prints one JSON line per seed and
writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent


def _seeds(text: str):
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def reading(cell, seed: int, impl: str, seconds: float, device) -> dict:
    """One seed's check, after a window of ``seconds``."""
    import importlib

    import torch

    from bench_torch import harness

    ctx = harness.Context(device=device, rank=0, world=1, seed=seed,
                          impl=impl)
    mod = importlib.import_module(
        f"bench_torch.drivers.{cell.traffic['driver']}")
    driver = mod.Driver(ctx, cell.config, cell.traffic)
    driver.setup()
    win = harness.measure(driver, seconds, device, time.time())
    driver.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    try:
        checks, failed = driver.check()
        out = {"seed": seed, "impl": impl, "iterations": win.iterations,
               "failed": failed,
               "checks": {k: v for k, (v, _lim) in checks.items()}}
    except Exception as e:  # noqa: BLE001  (a control that crashes fails)
        out = {"seed": seed, "impl": impl, "error": repr(e)}
    del driver
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--gdims", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from bench_torch import harness

    cell = harness.load_cell(CHECKOUT / "BENCHMARK.json", args.workload)
    if args.gdims:
        cell.config["gdims"] = [int(v) for v in args.gdims.split(",")]
    if cell.chips != 1:
        raise SystemExit("readings run one-card cells")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available")
    device = torch.device(args.device)
    rows = []
    for impl, seeds in (("program", _seeds(args.seeds)),
                        ("control", _seeds(args.control_seeds))):
        for seed in seeds:
            rows.append(reading(cell, seed, impl, args.seconds, device))
            print(json.dumps(rows[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload,
                       "device": harness.device_name(device),
                       "limits": cell.config["limits"], "rows": rows}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
