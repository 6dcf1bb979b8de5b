#!/usr/bin/env python3
"""The one-sided exchange path's times on four ranks that share one card,
without MPS and then under MPS, in one run on one card.

    python3 tools/peer_mps.py [--n 512] [--out chiprun_out/peer_mps.json]

Runs ``cudecomp_tpu_torch.bench.peer_headline`` (K2 per exchange of a
rank's 512^3 c64 pencil at pdims (2, 2), the PALLAS_A2A c2c round trip,
K3 per dim and the HaloMethod.PALLAS update of a 512^3 f32 x-pencil at
width 1) twice: first under an MPS control daemon started by this script
(its pipe and log directories in a temporary directory; stopped with
``quit``), then as the card comes, the four processes time-slicing it.
Every time is the slowest rank's, from CUDA events.  Prints the card's
name and power limit and one JSON line; writes it to ``--out`` too.
Exits nonzero, printing the daemon's logs, when the card is missing or
the ranks cannot run under MPS.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    # no CUDA call in this process before the MPS daemon is up: the card is
    # found with nvidia-smi, and peer_headline raises without CUDA
    from cudecomp_tpu_torch import bench
    card = card_line()
    print(f"card: {card}")
    res = {"card": card, "compute_mode": bench.compute_mode()}
    control = shutil.which("nvidia-cuda-mps-control")
    if control is None:
        print("peer_mps: nvidia-cuda-mps-control not found", file=sys.stderr)
        return 1
    # under MPS first, while no process of this run holds the card
    with tempfile.TemporaryDirectory() as tmp:
        env = {"CUDA_MPS_PIPE_DIRECTORY": str(Path(tmp, "pipe")),
               "CUDA_MPS_LOG_DIRECTORY": str(Path(tmp, "log"))}
        for d in env.values():
            os.makedirs(d)
        os.environ.update(env)  # the ranks inherit it and connect
        start = subprocess.run([control, "-d"], capture_output=True,
                               text=True, timeout=60)
        try:
            if start.returncode != 0:
                raise RuntimeError(f"MPS did not start: {start.stderr}")
            time.sleep(1)
            res["with_mps"] = bench.peer_headline(N=args.n)
        except Exception as e:  # report the daemon's logs, then fail
            for log in sorted(Path(tmp, "log").glob("*")):
                print(f"--- {log.name}\n{log.read_text()[-3000:]}",
                      file=sys.stderr)
            print(f"peer_mps: under MPS: {type(e).__name__}: "
                  f"{str(e)[-2000:]}", file=sys.stderr)
            return 1
        finally:
            subprocess.run([control], input="quit\n", text=True,
                           capture_output=True, timeout=60)
            for k in env:
                os.environ.pop(k)
    time.sleep(2)
    res["without_mps"] = bench.peer_headline(N=args.n)
    line = json.dumps(res)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
