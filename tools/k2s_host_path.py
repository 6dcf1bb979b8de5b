#!/usr/bin/env python3
"""Where K2s's time goes on the host: K2 at P = 1 in a fresh process.

    python3 tools/k2s_host_path.py [--rounds 3] [--out FILE]

On a one-rank gloo group and a (1024, 256) float32 tensor on cuda:0 it
times, in turns, each of

  * ``a2a``: ``peer_kernels.a2a``, the whole call (K2s's program);
  * ``entry``: the C entry ``cudecomp_peer_copy`` called directly into a
    preallocated output, with its launch-count out-argument;
  * ``empty_like``: the output allocation ``a2a`` makes;
  * ``clone``: one PyTorch call that computes the same function;

as CUDA events over 200 back-to-back calls (mean of 3 trials after 2
warm-up calls), ``--rounds`` times.  The card's time for these bytes is a
few microseconds, so what separates ``a2a`` from ``entry`` is host code.
Prints the card's name and power limit, one line per call, and the
results as one JSON object, which ``--out`` also writes to a file.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import tempfile
from pathlib import Path
from statistics import mean

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import card_line  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("CUDA is not available: nothing to time", file=sys.stderr)
        return 1
    from cudecomp_tpu_torch import performance as perf
    from cudecomp_tpu_torch.ops import peer_kernels as PK

    card = card_line()
    print(f"card: {card}")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                                rank=0, world_size=1)
        try:
            x = torch.arange(1024 * 256, dtype=torch.float32,
                             device="cuda:0").reshape(1024, 256)
            out = torch.empty_like(x)
            lib = PK._lib()
            stream = torch.cuda.current_stream(x.device).cuda_stream
            launched = ctypes.c_int(0)
            words = x.numel() * x.element_size() // 16

            def entry():
                lib.cudecomp_peer_copy(x.data_ptr(), out.data_ptr(), words,
                                       16, stream, ctypes.byref(launched))

            calls = {"a2a": lambda: PK.a2a(x, None), "entry": entry,
                     "empty_like": lambda: torch.empty_like(x),
                     "clone": x.clone}
            for fn in calls.values():
                fn()
            torch.cuda.synchronize()
            if not (torch.equal(PK.a2a(x, None), x) and torch.equal(out, x)
                    and launched.value == 1):
                raise AssertionError("K2s is not a one-launch exact copy")
            runs = {k: [] for k in calls}
            for _ in range(args.rounds):
                for k, fn in calls.items():
                    runs[k].append(mean(perf.time_fn(
                        fn, n_warmup=2, n_trials=3, iters=200)) * 1e6)
        finally:
            dist.destroy_process_group()
    for k, v in runs.items():
        print(f"[{card}] {k}: {min(v):.2f}-{max(v):.2f} us per call "
              f"(rounds {[round(u, 2) for u in v]})")
    line = json.dumps({"card": card, "shape": [1024, 256],
                       "dtype": "float32", "us": runs})
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
