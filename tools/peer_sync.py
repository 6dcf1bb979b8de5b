#!/usr/bin/env python3
"""The synchronisation of K2 and K3 weighed on four ranks that share one
card.

    python3 tools/peer_sync.py [--n 512] [--rounds 200] [--out FILE]

Builds ``tools/peer_sync_variants.cu`` beside the port's K2/K3 library and
runs ``cudecomp_tpu_torch.bench.peer_sync`` on four processes on
``cuda:0`` (gloo over ``file://``).  In each rank:

  * first, the ``PALLAS_A2A`` c2c round trip at pdims (2, 2), traced in
    every rank (a young process keeps every kernel record): the slowest
    rank's window, the four ranks' kernels by name and the card's idle
    share over that window;
  * one signal-then-wait round among the four ranks, ``--rounds`` back to
    back, in each of the probe's forms: (a) the first design's spinning barrier
    kernel, (b) a batch of stream writes then a batch of stream waits,
    (b') a signal kernel of release stores then a batch of stream waits,
    (c) interprocess CUDA events and a gloo barrier;
  * K2 (one exchange of a rank's n^3 c64 pencil over ``pr`` at pdims
    (2, 2)) and K3 (one update of the y dim of the n^3 f32 x-pencil, width
    1, periodic) under each variant of the file (0: the first four-launch
    exchange; 1: stream-ordered with the entry barrier; 2: stream-ordered,
    double buffered; 3: signal kernel, double buffered) and as the
    library runs them, each first held bit for bit to the plain executor
    on the card, then timed in turns (CUDA events, mean of 3 trials of 5
    calls);
  * what ``torch.profiler`` records of one exchange.

Every time is the slowest rank's.  Prints the card's name and power
limit, whether MPS was on, one line per measure, and one JSON line, which
``--out`` also writes to a file.  The port never calls the variants.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import card_line  # noqa: E402

SOURCE = Path(__file__).resolve().with_name("peer_sync_variants.cu")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("CUDA is not available: nothing to time", file=sys.stderr)
        return 1
    from cudecomp_tpu_torch import bench

    card = card_line()
    res = bench.peer_sync(SOURCE, N=args.n, rounds=args.rounds)
    mps = ("MPS on" if res["mps"] else
           "no MPS: four ranks time-slice the card")
    tag = f"[{card}, {mps}]"
    r0 = res["ranks"][0]
    print(f"card: {card}")
    print(f"{tag} device attributes: {r0['caps']}")
    sl = res["slowest"]
    for k, name in bench.SYNC_ROUNDS.items():
        print(f"{tag} round ({name}): {sl['rounds_ms'][str(k)]:.4f} ms on "
              f"the card, {sl['rounds_host_ms'][str(k)]:.4f} ms on the host")
    for what, label in (("k2", f"K2 {args.n}^3 c64 pencil over pr"),
                        ("k3", f"K3 y-dim {args.n}^3 f32 width 1")):
        for k, ms in sl[f"{what}_ms"].items():
            name = bench.SYNC_VARIANTS.get(int(k)) if k != "lib" else \
                "the library"
            runs = [r[what][k] for r in res["ranks"]]
            print(f"{tag} {label}, {k} ({name}): {ms:.4f} ms (ranks' "
                  f"turns {runs})")
    rt = sl["roundtrip"]
    lost = (f"; the traces lost {rt['lost']} launches' kernels, so busy "
            f"and idle are not measured" if rt["lost"] else "")
    print(f"{tag} PALLAS_A2A c2c round trip of {args.n}^3 at pdims (2, 2), "
          f"traced: {rt['window_ms']:.3f} ms on the slowest rank's stream; "
          f"the four ranks' kernels {rt['busy_ms']:.3f} ms (K2's "
          f"exchanges {rt['comm_ms']:.3f} ms), idle share "
          f"{rt['idle_share']:.3f}{lost}; by kernel over the ranks:")
    for name, ms in list(rt["ops"].items())[:12]:
        print(f"{tag}   {ms:9.4f} ms  {name[:100]}")
    for v, launches in r0["launches"].items():
        print(f"variant {v}: (kernels, memory operations) per exchange "
              f"{launches}; max abs diff from the plain executor, bit-equal "
              f"(K2, K3): {[r['err'][v] for r in res['ranks']]}")
    print(f"rank 0's profile of one library K2 exchange: "
          f"{r0['profile_lib']}")
    print(f"rank 0's profile of one variant-2 K2 exchange: "
          f"{r0['profile_v2']}")
    bad = [(v, r["err"][v]) for r in res["ranks"] for v in r["err"]
           if not (r["err"][v][2] and r["err"][v][3])]
    line = json.dumps({"card": card, "mps": res["mps"], **res})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(json.dumps({"card": card, "mps": res["mps"], "slowest": sl,
                      "caps": r0["caps"], "launches": r0["launches"]}))
    if bad:
        print(f"variants that differ from the plain executor: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
