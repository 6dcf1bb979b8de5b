#!/usr/bin/env python3
"""Can torch symmetric memory serve as the transport of the one-sided
kernels K2, K2s and K3?

    python3 tools/symm_mem_probe.py              # one NCCL rank
    python3 tools/symm_mem_probe.py --ranks 4 [--overlapping]

With one rank (K2s's case) the probe initialises an NCCL group of one rank
on tcp://localhost:<free port>, allocates a symmetric buffer, rendezvouses
it, copies through the peer view of rank 0 and runs the signal-pad barrier.

With ``--ranks N`` it spawns N processes that share cuda:0 over a gloo
group (``file://`` in a temporary directory), as the port runs K2 and K3
on one card: each allocates ``torch.distributed._symmetric_memory.empty``,
rendezvouses it over the gloo group (``--overlapping`` sets
``TORCH_SYMM_MEM_ALLOW_OVERLAPPING_DEVICES=1`` first), writes its rank into
the next rank's buffer through the peer view and checks what the previous
rank wrote.  Prints, per rank, each step that worked (written as it
completes, so a rank that hangs shows where) and the first error.
"""

import argparse
import json
import os
import socket
import sys
import tempfile
import time


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def one_rank() -> dict:
    import torch
    import torch.distributed as dist
    steps = {}
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        import torch.distributed._symmetric_memory as symm_mem
        steps["nvshmem_available"] = bool(symm_mem.is_nvshmem_available())
        steps["backend"] = str(symm_mem.get_backend(torch.device("cuda")))
        buf = symm_mem.empty(1024, dtype=torch.float32, device="cuda")
        steps["empty"] = True
        handle = symm_mem.rendezvous(buf, dist.group.WORLD)
        steps["rendezvous"] = True
        peer = handle.get_buffer(0, (1024,), torch.float32)
        src = torch.arange(1024, dtype=torch.float32, device="cuda")
        peer.copy_(src)
        handle.barrier()
        torch.cuda.synchronize()
        steps["peer_copy_and_barrier"] = bool(torch.equal(buf, src))
    except Exception as e:  # the probe's answer is the first failure
        steps["error"] = f"{type(e).__name__}: {e}"[:500]
    finally:
        dist.destroy_process_group()
    return steps


def shared_card_rank(rank: int, world: int, tmp: str,
                     overlapping: bool) -> None:
    """One of ``world`` gloo ranks on cuda:0; writes rank<r>.json."""
    import torch
    import torch.distributed as dist
    if overlapping:
        os.environ["TORCH_SYMM_MEM_ALLOW_OVERLAPPING_DEVICES"] = "1"
    steps = {}

    def step(name, value=True):
        # written after every step, so a rank that hangs shows where
        steps[name] = value
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
            json.dump(steps, fh)

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                            rank=rank, world_size=world)
    step("init")
    try:
        import torch.distributed._symmetric_memory as symm_mem
        buf = symm_mem.empty(1024, dtype=torch.float32, device="cuda")
        buf.fill_(-1.0)
        step("empty")
        step("backend", str(symm_mem.get_backend(torch.device("cuda"))))
        handle = symm_mem.rendezvous(buf, dist.group.WORLD)
        step("rendezvous")
        torch.cuda.synchronize()
        dist.barrier()
        nxt = (rank + 1) % world
        handle.get_buffer(nxt, (1024,), torch.float32).fill_(float(rank))
        torch.cuda.synchronize()
        dist.barrier()
        step("peer_write_seen",
             bool((buf == float((rank - 1) % world)).all()))
    except Exception as e:  # the probe's answer is the first failure
        step("error", f"{type(e).__name__}: {e}"[:500])
    finally:
        dist.destroy_process_group()


def shared_card(world: int, overlapping: bool) -> dict:
    import torch
    with tempfile.TemporaryDirectory() as tmp:
        ctx = torch.multiprocessing.start_processes(
            shared_card_rank, args=(world, tmp, overlapping), nprocs=world,
            join=False, start_method="spawn")
        out = {}
        deadline = time.monotonic() + 120
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                out["error"] = "the ranks did not finish in 120 s"
                break
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as fh:
                    out[f"rank{r}"] = json.load(fh)
        return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--overlapping", action="store_true",
                    help="set TORCH_SYMM_MEM_ALLOW_OVERLAPPING_DEVICES=1")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("symm_mem_probe: needs CUDA", file=sys.stderr)
        return 1
    out = (one_rank() if args.ranks == 1
           else shared_card(args.ranks, args.overlapping))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
