"""Exchange strategies — the "communication backends" of the transpose.

Block contract (the same as ``cudecomp_tpu.parallel.collectives``): the
input is ``(P*B, ...)`` where block ``p`` (rows ``p*B:(p+1)*B``) is destined
for peer ``p`` of the axis group; the output has block ``q`` holding what
peer ``q`` sent.

  * ``exchange_all_to_all`` — one ``torch.distributed.all_to_all_single``
    over the axis group (NCCL on the GPU, gloo on the CPU): the analog of
    the reference's NCCL/MPI one-shot backends.
  * ``exchange_ring``, ``exchange_ring_xor``, ``exchange_ring_hier`` — P-1
    point-to-point steps, one peer per step, in the increment, XOR
    (pairwise swaps) or two-tier host-aware order: the reference's
    per-peer backends (``getAlltoallPeerRanks``, ``common.h:533-577``).
    They share one scaffold, :func:`_ring_exchange`, which alone holds
    the block contract; each step is a :func:`ppermute_group`.
  * ``exchange_pallas_a2a`` — K2, the one-sided all-to-all kernel
    (``ops/peer_kernels.py``), for CUDA tensors; a CPU tensor takes
    ``exchange_all_to_all``, as the JAX package does off the TPU.

The pipelined transpose (``ring_pipelined``) restructures the whole
transpose around the ring's steps; the transpose engine holds it.

Gradients: every exchange is differentiable, as the JAX package's are.
An all-to-all of blocks is its own adjoint, so the all-to-all, the rings
and K2 are each one :class:`torch.autograd.Function` whose backward runs
the same exchange on the gradient; the backward of ``ppermute_group`` is
``ppermute_group`` of the gradient with the pairs reversed.  The backward
passes refuse what the forward passes refuse (CUDA over gloo).

Ranks that share one card (NCCL refuses two ranks on one GPU) run over a
gloo process group, which exchanges CPU tensors only: there the CUDA
tensors travel through the kernels (``pallas_a2a``, ``HaloMethod.PALLAS``),
and ``exchange_all_to_all``, ``ppermute`` and so the rings raise on a CUDA
tensor over a gloo group.  Nothing is staged through the host.

Beside the transposes' exchanges:

  * ``ppermute`` — a neighbour shift with ``lax.ppermute`` semantics over
    one mesh dim, as ``batch_isend_irecv`` point-to-point pairs.  The halo
    engine and the stencil path's ghost exchanges use it, with the pairs of
    ``neighbour_pairs``.
  * ``all_reduce_grid`` — a sum (or a max) over every rank of a grid.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from cudecomp_tpu_torch.config import CannotRun
from cudecomp_tpu_torch.ops import peer_kernels
from cudecomp_tpu_torch.parallel.mesh import axis_group_size
from cudecomp_tpu_torch.utils.tracing import EXCHANGE_PREFIX, trace_range


def _refuse_cuda_over_gloo(x: torch.Tensor, group, what: str) -> None:
    if x.device.type != "cpu" and str(dist.get_backend(group)) == "gloo":
        raise CannotRun(
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
    views).  Every rank of the group must call, and in backward every rank
    must reach the result's gradient: a caller that drops the result on
    some ranks links it into the graph anyway (``ops.halo.halo_ring``).
    """
    pairs = tuple((int(s), int(d)) for s, d in pairs)
    srcs = [s for s, _ in pairs]
    dsts = [d for _, d in pairs]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute pairs must have distinct sources and "
                         f"distinct destinations, got {list(pairs)}")
    if torch.is_grad_enabled() and x.requires_grad:
        return _PPermute.apply(x, group, pairs)
    return _ppermute(x, group, pairs)


class _PPermute(torch.autograd.Function):
    """``ppermute_group`` under autograd: the adjoint of a shift along
    ``pairs`` is the shift of the gradient along the reversed pairs; a
    rank that sent nothing gets zeros."""

    @staticmethod
    def forward(ctx, x, group, pairs):
        ctx.group, ctx.pairs = group, pairs
        return _ppermute(x, group, pairs)

    @staticmethod
    def backward(ctx, grad):
        return (_ppermute(grad, ctx.group, [(d, s) for s, d in ctx.pairs]),
                None, None)


def _ppermute(x: torch.Tensor, group, pairs) -> torch.Tensor:
    """The shift of :func:`ppermute_group`, outside autograd."""
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
        with trace_range(EXCHANGE_PREFIX + "ppermute"):
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


class _SelfAdjoint(torch.autograd.Function):
    """An exchange ``run(blocks)`` of the block contract under autograd.
    Block p of rank r lands in block r of rank p, so the adjoint moves
    the gradient's block r of rank p back to block p of rank r: the same
    exchange, run on the gradient."""

    @staticmethod
    def forward(ctx, blocks, run):
        ctx.run = run
        return run(blocks)

    @staticmethod
    def backward(ctx, grad):
        return ctx.run(grad.contiguous()), None


def _self_adjoint(run, blocks: torch.Tensor) -> torch.Tensor:
    """``run(blocks)``, recorded for autograd when ``blocks`` needs a
    gradient."""
    if torch.is_grad_enabled() and blocks.requires_grad:
        return _SelfAdjoint.apply(blocks, run)
    return run(blocks)


def _check_blocks(blocks: torch.Tensor, n: int, block: int) -> None:
    if blocks.shape[0] != n * block:
        raise ValueError(f"blocks have {blocks.shape[0]} rows, expected "
                         f"{n} peers x {block}")


def exchange_all_to_all(blocks: torch.Tensor, group, n: int,
                        block: int) -> torch.Tensor:
    """One-shot all-to-all: block p -> peer p, received stacked by peer.
    Complex tensors cross as their ``view_as_real`` float pairs."""
    _check_blocks(blocks, n, block)
    return _self_adjoint(partial(_all_to_all, group=group), blocks)


def _all_to_all(blocks: torch.Tensor, group) -> torch.Tensor:
    _refuse_cuda_over_gloo(blocks, group, "all_to_all")
    blocks = blocks.contiguous()
    out = torch.empty_like(blocks)
    with trace_range(EXCHANGE_PREFIX + "all_to_all"):
        if blocks.is_complex():
            dist.all_to_all_single(torch.view_as_real(out),
                                   torch.view_as_real(blocks), group=group)
        else:
            dist.all_to_all_single(out, blocks, group=group)
    return out


def _ring_exchange(blocks: torch.Tensor, group, n: int, block: int,
                   steps) -> torch.Tensor:
    """Shared scaffold of every per-peer (ring-style) exchange; see
    :func:`_ring_steps`."""
    _check_blocks(blocks, n, block)
    return _self_adjoint(partial(_ring_steps, group=group, n=n, block=block,
                                 steps=steps), blocks)


def _ring_steps(blocks: torch.Tensor, group, n: int, block: int,
                steps) -> torch.Tensor:
    """The per-peer exchange, outside autograd.

    ``steps`` is a list of ``(sigma, sigma_inv)`` pairs: each step is a
    permutation ``j -> sigma(j)`` of the group ranks (``sigma_inv`` its
    inverse).  At each step every rank sends the block destined for
    ``sigma(me)`` and stores the block it receives under its sender's
    index ``sigma_inv(me)``; the self block is a local copy.  The block
    contract lives here only, so that the increment, XOR and two-tier
    schedules cannot drift apart."""
    me = dist.get_rank(group) if n > 1 else 0
    out = torch.empty_like(blocks)
    out[me * block:(me + 1) * block] = blocks[me * block:(me + 1) * block]
    for sigma, sigma_inv in steps:
        send_peer, recv_peer = sigma(me), sigma_inv(me)
        recv = _ppermute(blocks[send_peer * block:(send_peer + 1) * block],
                         group, [(j, sigma(j)) for j in range(n)])
        out[recv_peer * block:(recv_peer + 1) * block] = recv
    return out


def exchange_ring(blocks: torch.Tensor, group, n: int,
                  block: int) -> torch.Tensor:
    """Ring (per-peer) exchange: step ``s`` sends block ``(me+s) % n`` to
    peer ``(me+s) % n`` and receives peer ``(me-s) % n``'s block (the ring
    order of ``getAlltoallPeerRanks``, ``common.h:533-577``)."""
    steps = [(lambda j, s=s: (j + s) % n, lambda j, s=s: (j - s) % n)
             for s in range(1, n)]
    return _ring_exchange(blocks, group, n, block, steps)


def exchange_ring_xor(blocks: torch.Tensor, group, n: int,
                      block: int) -> torch.Tensor:
    """Pairwise-exchange ring with the XOR peer schedule: step ``s`` swaps
    blocks with peer ``me ^ s``, so each step is a symmetric pairwise
    swap.  A group size that is no power of two takes the increment
    ring."""
    if n & (n - 1):
        return exchange_ring(blocks, group, n, block)
    # each XOR step is an involution: sigma == sigma_inv
    steps = [(lambda j, s=s: j ^ s,) * 2 for s in range(1, n)]
    return _ring_exchange(blocks, group, n, block, steps)


def hier_schedule(n: int, group: int):
    """Two-tier peer schedule (multi-level ring, ``common.h:533-577``).

    Ranks along the dim decompose as ``j = g * group + k`` (g the host's
    group, k the index within it).  Every step is the permutation ``j ->
    ((g+dg) % G) * group + (k+dk) % group``; steps across groups come
    first, interleaved with steps within a group, so that the slow
    transfers are issued early and the fast ones fill in behind them (the
    reference pairs each inter-group transfer with an intra-group one,
    ``transpose.h:695-709``).

    Returns the ``(dg, dk)`` displacement pairs covering all n-1 peers."""
    if group <= 1 or n % group:
        return [(0, s) for s in range(1, n)]
    G = n // group
    inter = [(dg, dk) for dg in range(1, G) for dk in range(group)]
    intra = [(0, dk) for dk in range(1, group)]
    steps = []
    ii, jj = 0, 0
    while ii < len(inter) or jj < len(intra):
        if ii < len(inter):
            steps.append(inter[ii])
            ii += 1
        if jj < len(intra):
            steps.append(intra[jj])
            jj += 1
    return steps


def exchange_ring_hier(blocks: torch.Tensor, group, n: int, block: int,
                       npergroup: int = 1) -> torch.Tensor:
    """Two-tier ring exchange: the contract of :func:`exchange_ring`, with
    the peers in the order of :func:`hier_schedule` for fast groups of
    ``npergroup`` consecutive ranks (``parallel.mesh.axis_group_size``),
    so that each step stays within the hosts' groups or crosses them
    all.  With one group this is the increment ring."""
    if npergroup <= 1 or n % npergroup:
        npergroup = n  # one group: (0, dk) displacements == increment ring
    G = n // npergroup

    def peer_of(dg, dk, j):
        return (((j // npergroup + dg) % G) * npergroup
                + (j % npergroup + dk) % npergroup)

    steps = [(lambda j, dg=dg, dk=dk: peer_of(dg, dk, j),
              lambda j, dg=dg, dk=dk: peer_of((-dg) % G, (-dk) % npergroup,
                                              j))
             for dg, dk in hier_schedule(n, npergroup)]
    return _ring_exchange(blocks, group, n, block, steps)


def exchange_pallas_a2a(blocks: torch.Tensor, group, n: int,
                        block: int) -> torch.Tensor:
    """``exchange_pallas_a2a``: the blocks as they are at n == 1
    (``pallas_kernels.py:191-192``), else K2 (``ops.peer_kernels.a2a``) for
    a tensor off the CPU and ``exchange_all_to_all`` for a CPU tensor.
    K2's backward is K2 on the gradient, through the same workspace."""
    _check_blocks(blocks, n, block)
    if n == 1:
        return blocks
    if blocks.device.type == "cpu":
        return exchange_all_to_all(blocks, group, n, block)
    with trace_range(EXCHANGE_PREFIX + "pallas_a2a"):
        return _self_adjoint(partial(peer_kernels.a2a, group=group), blocks)


EXCHANGES = {
    "all_to_all": exchange_all_to_all,
    "ring": exchange_ring,
    "ring_xor": exchange_ring_xor,
    "ring_hier": exchange_ring_hier,  # the engine passes npergroup=
    "pallas_a2a": exchange_pallas_a2a,
    # "ring_pipelined" restructures the whole transpose, not just the
    # exchange; the transpose engine holds it
}


def exchange_for(method_key: str, grid, dim_name: str):
    """The exchange ``(blocks, group, n, block)`` that a transpose of
    ``method_key`` runs over mesh dim ``dim_name`` of ``grid``: the ring's
    for ``ring_pipelined`` (its steps are the ring's), ``ring_hier`` with
    the dim's fast groups (``mesh.axis_group_size`` of the grid's
    hosts)."""
    if method_key == "ring_pipelined":
        method_key = "ring"
    exchange = EXCHANGES[method_key]
    if method_key == "ring_hier":
        exchange = partial(exchange, npergroup=axis_group_size(
            grid.mesh, dim_name, grid.hosts))
    return exchange
