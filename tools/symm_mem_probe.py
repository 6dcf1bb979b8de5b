#!/usr/bin/env python3
"""Can a one-rank process group on one GPU rendezvous torch symmetric
memory, the transport that the one-sided kernels K2, K2s and K3 need?

A P = 1 run of K2's smoke (K2s) needs exactly this: a symmetric buffer
on a group of one rank, its own peer pointer, and a signal-pad barrier.
The probe initialises an NCCL group of one rank on
tcp://localhost:<free port>, allocates a symmetric buffer, rendezvouses
it, copies through the peer view of rank 0 and runs the barrier, and
prints what worked and the first error.

    python3 tools/symm_mem_probe.py
"""

import json
import socket
import sys


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main() -> int:
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("symm_mem_probe: needs CUDA", file=sys.stderr)
        return 1
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
    print(json.dumps(steps))
    return 0


if __name__ == "__main__":
    sys.exit(main())
