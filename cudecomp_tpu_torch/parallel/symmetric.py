"""Workspaces that every rank of a process group maps: the transport of the
one-sided kernels K2 (the all-to-all) and K3 (the halo ring).

The JAX package's kernels address a peer's buffer as a remote ref and
complete on DMA semaphores (``cudecomp_tpu/ops/pallas_kernels.py``); the
reference's NVSHMEM backend puts into a symmetric heap.  Here each rank of
a group holds one :class:`Workspace` per (group, device): a buffer of torch
symmetric memory (``torch.distributed._symmetric_memory``: ``empty`` and a
``rendezvous`` over the group) that every rank of the group maps into its
own address space.  Ranks may be processes that share one card: torch
refuses to rendezvous ranks on one device unless
``TORCH_SYMM_MEM_ALLOW_OVERLAPPING_DEVICES=1``, which this module sets when
the process has not.  A workspace holds

  * a signal pad of one 8-byte slot per group rank (its first
    ``PAD_BYTES``), written by the peers' stream memory operations
    (``csrc/peer.cu``);
  * the receive region, after the pad, in two halves (one per epoch
    parity, ``ops/peer_kernels.sync_schedule``);
  * ``bases_dev``: a device array of the group's buffer addresses as this
    rank maps them, indexed by group rank (this rank's own at its rank),
    and ``bases_host``, the same addresses in host memory (a ctypes
    array, for the stream memory operations);
  * ``launches``: the plans run on it, made ready to launch
    (``ops/peer_kernels.py``: their device tables and ctypes arguments),
    which go when the workspace goes.

The library only allocates and maps; the puts, the signals and the waits
are the port's own code (no ``barrier()`` of the handle, no
``torch.ops.symm_mem``).  Set-up is collective over the group, which may
be gloo.  A workspace is cached per (group, device) and grown on demand, as
the JAX package keys its kernels' collective ids per mesh axis
(``pallas_kernels.py:71-81``): every rank of a group makes the same calls
in the same order with the same sizes, so every rank grows at the same
call.  Growing releases the old workspace (collective too) and starts a
new one with a zeroed pad and its exchange count at 0.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from cudecomp_tpu_torch.config import CannotRun

PAD_BYTES = 4096      # csrc/peer.cu: kPadBytes
MAX_RANKS = 64        # csrc/peer.cu: kMaxPeers
GROW_ALIGN = 1 << 20  # receive regions grow in whole MiB
OVERLAP_ENV = "TORCH_SYMM_MEM_ALLOW_OVERLAPPING_DEVICES"


class Workspace:
    """This rank's mapped view of one group's workspaces (see the module
    docstring).  ``rank`` is the group rank, ``size`` the group size,
    ``recv_bytes`` the receive region's capacity."""

    def __init__(self, group, device: torch.device, recv_bytes: int):
        import torch.distributed._symmetric_memory as symm_mem
        self.group = group
        self.device = device
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        if self.size > MAX_RANKS:
            raise CannotRun(f"a workspace serves at most {MAX_RANKS} ranks, "
                             f"the group has {self.size}")
        self.recv_bytes = recv_bytes
        self.exchanges = 0
        self.launches = {}
        os.environ.setdefault(OVERLAP_ENV, "1")
        nbytes = PAD_BYTES + recv_bytes
        self._buf = symm_mem.empty(nbytes, dtype=torch.uint8, device=device)
        self._handle = symm_mem.rendezvous(self._buf, group)
        if self._handle.rank != self.rank:
            raise RuntimeError(f"symmetric memory ranks this process "
                               f"{self._handle.rank}, the group {self.rank}")
        # the pad starts at 0 (csrc/peer.cu), zeroed through the view
        # the peers address; no rank signals before every rank has zeroed
        self._handle.get_buffer(self.rank, (PAD_BYTES,), torch.uint8).zero_()
        ptrs = [int(p) for p in self._handle.buffer_ptrs]
        self.bases_host = (ctypes.c_uint64 * self.size)(*ptrs)
        self.bases_dev = torch.tensor(ptrs, dtype=torch.int64, device=device)
        torch.cuda.synchronize(device)
        dist.barrier(group=group)

    def signals(self) -> list:
        """The slots of this rank's signal pad, after the device's work is
        done: slot r holds the last value group rank r wrote into it."""
        torch.cuda.synchronize(self.device)
        return self._handle.get_buffer(self.rank, (self.size,),
                                       torch.int64).tolist()

    def next_exchange(self) -> int:
        """The index of the next exchange on this workspace (its epoch)."""
        e = self.exchanges
        self.exchanges += 1
        return e

    def release(self) -> None:
        """Drop this rank's buffer and its mapping of the peers', after
        every rank of the group is done with them (collective)."""
        torch.cuda.synchronize(self.device)
        dist.barrier(group=self.group)
        self._handle = self._buf = self.bases_dev = self.bases_host = None
        self.launches.clear()


_WORKSPACES: Dict[Tuple[str, int], Workspace] = {}


def workspace(group, device, recv_bytes: int) -> Workspace:
    """The workspace of ``group`` (the default group when None) on
    ``device`` with a receive region of at least ``recv_bytes``; created or
    grown collectively (every rank of the group must make the same
    call)."""
    group = group if group is not None else dist.group.WORLD
    device = torch.device(device)
    if device.type != "cuda" or device.index is None:
        raise ValueError(f"workspaces live on an indexed CUDA device, got "
                         f"{device}")
    key = (group.group_name, device.index)
    ws = _WORKSPACES.get(key)
    if ws is not None and ws.recv_bytes >= recv_bytes:
        return ws
    if ws is not None:
        ws.release()
        del _WORKSPACES[key]
    need = -(-max(recv_bytes, 1) // GROW_ALIGN) * GROW_ALIGN
    ws = Workspace(group, device, need)
    _WORKSPACES[key] = ws
    return ws


def release_workspaces() -> None:
    """Release every cached workspace; collective over each workspace's
    group, in the order they were made."""
    for ws in _WORKSPACES.values():
        ws.release()
    _WORKSPACES.clear()
