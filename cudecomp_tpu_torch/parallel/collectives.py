"""Exchange strategies — the "communication backends" of the transpose.

Block contract (the same as ``cudecomp_tpu.parallel.collectives``): the
input is ``(P*B, ...)`` where block ``p`` (rows ``p*B:(p+1)*B``) is destined
for peer ``p`` of the axis group; the output has block ``q`` holding what
peer ``q`` sent.

  * ``exchange_all_to_all`` — one ``torch.distributed.all_to_all_single``
    over the axis group (NCCL on the GPU, gloo on the CPU): the analog of
    the reference's NCCL/MPI one-shot backends.
  * ``exchange_pallas_a2a`` — K2, the one-sided all-to-all kernel
    (``ops/peer_kernels.py``), for CUDA tensors; a CPU tensor takes
    ``exchange_all_to_all``, as the JAX package does off the TPU.

The per-peer strategies (``ring``, ``ring_xor``, ``ring_hier``, the
pipelined transpose) are not ported yet: they raise
``NotImplementedError`` when an exchange over more than one rank would
run.  A slab transpose never exchanges, so on a ``(1, 1)`` grid every
method works.

Ranks that share one card (NCCL refuses two ranks on one GPU) run over a
gloo process group, which exchanges CPU tensors only: there the CUDA
tensors travel through the kernels (``pallas_a2a``, ``HaloMethod.PALLAS``),
and ``exchange_all_to_all`` and ``ppermute`` raise on a CUDA tensor over a
gloo group.

Beside the transposes' exchanges:

  * ``ppermute`` — a neighbour shift with ``lax.ppermute`` semantics over
    one mesh dim, as ``batch_isend_irecv`` point-to-point pairs.  The halo
    engine and the stencil path's ghost exchanges use it, with the pairs of
    ``neighbour_pairs``.
  * ``all_reduce_grid`` — a sum (or a max) over every rank of a grid.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from cudecomp_tpu_torch.ops import peer_kernels


def _refuse_cuda_over_gloo(x: torch.Tensor, group, what: str) -> None:
    if x.device.type != "cpu" and str(dist.get_backend(group)) == "gloo":
        raise ValueError(
            f"{what} of a {x.device.type} tensor over a gloo process group: "
            f"gloo exchanges CPU tensors. Ranks that share a card exchange "
            f"with the kernels (TransposeMethod.PALLAS_A2A, "
            f"HaloMethod.PALLAS); one rank per card can use NCCL")


def ppermute(x: torch.Tensor, mesh, dim_name: str,
             pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Shift ``x`` along mesh dim ``dim_name`` (``lax.ppermute``): see
    :func:`ppermute_group`, over the dim's process group."""
    return ppermute_group(x, mesh.get_group(dim_name), pairs)


def ppermute_group(x: torch.Tensor, group,
                   pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Shift ``x`` over the ranks of ``group`` (``lax.ppermute``).

    ``pairs`` are ``(src, dst)`` group ranks: the rank at ``src`` sends its
    ``x`` to the rank at ``dst``.  Returns what this rank received, with
    ``x``'s shape and dtype.  A rank that no pair sends to receives zeros:
    the stencil path's Dirichlet-0 ghost planes rest on that.  ``x`` is
    made contiguous before it is sent (y and z face planes are strided
    views).  Every rank of the group must call.
    """
    srcs = [s for s, _ in pairs]
    dsts = [d for _, d in pairs]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute pairs must have distinct sources and "
                         f"distinct destinations, got {list(pairs)}")
    _refuse_cuda_over_gloo(x, group, "ppermute")
    me = dist.get_rank(group)
    send = x.contiguous()
    recv = torch.zeros_like(send)
    wire_send = torch.view_as_real(send) if send.is_complex() else send
    wire_recv = torch.view_as_real(recv) if recv.is_complex() else recv
    ops = []
    for src, dst in pairs:
        if src == me and dst == me:
            recv.copy_(send)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, wire_send,
                                  dist.get_global_rank(group, dst), group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, wire_recv,
                                  dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv


def neighbour_pairs(P: int, periodic: bool):
    """The ``(src, dst)`` pairs of the two nearest-neighbour shifts along a
    dim of ``P`` ranks: ``up`` (j -> j+1) and ``down`` (j -> j-1), with the
    wrap pairs only when ``periodic``."""
    up = [(j, j + 1) for j in range(P - 1)]
    down = [(j + 1, j) for j in range(P - 1)]
    if periodic:
        up.append((P - 1, 0))
        down.append((0, P - 1))
    return up, down


def all_reduce_grid(t: torch.Tensor, grid, op=dist.ReduceOp.SUM
                    ) -> torch.Tensor:
    """Reduce ``t`` in place over every rank of ``grid`` with ``op`` (the
    sum by default; one ``all_reduce`` per mesh dim of more than one rank,
    none on a ``(1, 1)`` grid) and return it."""
    if grid.mesh is None:
        return t
    names = grid.mesh.mesh_dim_names
    for name, p in zip(grid.axis_names, grid.pdims):
        if p > 1 and name in names:
            dist.all_reduce(t, op=op, group=grid.group(name))
    return t


def exchange_all_to_all(blocks: torch.Tensor, group, n: int,
                        block: int) -> torch.Tensor:
    """One-shot all-to-all: block p -> peer p, received stacked by peer.
    Complex tensors cross as their ``view_as_real`` float pairs."""
    if blocks.shape[0] != n * block:
        raise ValueError(f"blocks have {blocks.shape[0]} rows, expected "
                         f"{n} peers x {block}")
    _refuse_cuda_over_gloo(blocks, group, "all_to_all")
    blocks = blocks.contiguous()
    out = torch.empty_like(blocks)
    if blocks.is_complex():
        dist.all_to_all_single(torch.view_as_real(out),
                               torch.view_as_real(blocks), group=group)
    else:
        dist.all_to_all_single(out, blocks, group=group)
    return out


def _not_ported(name: str):
    def exchange(blocks, group, n, block):
        raise NotImplementedError(
            f"transpose method {name!r} is not available in "
            f"cudecomp_tpu_torch yet; use 'all_to_all'")
    exchange.__name__ = f"exchange_{name}"
    return exchange


def exchange_pallas_a2a(blocks: torch.Tensor, group, n: int,
                        block: int) -> torch.Tensor:
    """``exchange_pallas_a2a``: the blocks as they are at n == 1
    (``pallas_kernels.py:191-192``), else K2 (``ops.peer_kernels.a2a``) for
    a tensor off the CPU and ``exchange_all_to_all`` for a CPU tensor."""
    if blocks.shape[0] != n * block:
        raise ValueError(f"blocks have {blocks.shape[0]} rows, expected "
                         f"{n} peers x {block}")
    if n == 1:
        return blocks
    if blocks.device.type == "cpu":
        return exchange_all_to_all(blocks, group, n, block)
    return peer_kernels.a2a(blocks, group)


EXCHANGES = {
    "all_to_all": exchange_all_to_all,
    "ring": _not_ported("ring"),
    "ring_xor": _not_ported("ring_xor"),
    "ring_hier": _not_ported("ring_hier"),
    "pallas_a2a": exchange_pallas_a2a,
    # "ring_pipelined" restructures the whole transpose, not just the
    # exchange; the transpose engine handles (and for now rejects) it
}
