"""Process-grid meshes: the (Pr, Pc) ``DeviceMesh`` in the configured rank
order.

The reference creates row and column communicators from the rank order
(``src/cudecomp.cc:1039-1269``, ``include/internal/common.h:318-346``).
Here the process grid is a ``torch.distributed`` DeviceMesh with dims
``('pr', 'pc')``; each mesh dim owns the process group its transposes
exchange over.  ``init_device_mesh`` takes only a shape (row-major ranks),
so the mesh is built from an explicit rank tensor, which also covers the
column-major order.

The reference schedules a rank's peers in fast groups, the ranks that
share a node (``npergroup``, ``include/internal/common.h:426-494``).  Here
the fast group is the ranks of one host: :func:`world_hosts` gathers every
rank's host name once, the grid carries them (``GridDescriptor.hosts``),
and :func:`axis_group_size` reads them.
"""

from __future__ import annotations

import socket
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cudecomp_tpu_torch.config import RankOrder


def mesh_ranks(pdims: Tuple[int, int],
               rank_order: RankOrder = RankOrder.ROW_MAJOR) -> torch.Tensor:
    """(Pr, Pc) tensor whose entry [pr, pc] is the linear rank at those
    coords: row-major ``pr*Pc + pc`` or column-major ``pc*Pr + pr``
    (``geometry.coords_of_rank``)."""
    pr, pc = pdims
    ranks = torch.arange(pr * pc, dtype=torch.int64)
    if RankOrder(rank_order) == RankOrder.ROW_MAJOR:
        return ranks.reshape(pr, pc)
    return ranks.reshape(pc, pr).t().contiguous()


def build_mesh(pdims: Tuple[int, int], device_type: str,
               rank_order: RankOrder = RankOrder.ROW_MAJOR,
               axis_names: Tuple[str, str] = ("pr", "pc")):
    """A DeviceMesh over all ranks of the default process group, arranged
    as the (Pr, Pc) process grid.  Every rank must call it (it creates the
    per-dim process groups collectively)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"pdims {tuple(pdims)} need torch.distributed: call "
            f"torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if world != pdims[0] * pdims[1]:
        raise ValueError(
            f"pdims {tuple(pdims)} need {pdims[0] * pdims[1]} ranks, the "
            f"process group has {world}; pass mesh= for a sub-mesh")
    return DeviceMesh(device_type, mesh_ranks(pdims, rank_order),
                      mesh_dim_names=tuple(axis_names))


def world_hosts() -> Tuple[str, ...]:
    """The host name of every rank of the default process group, by rank
    (collective: every rank must call); this process's alone when there is
    no process group."""
    me = socket.gethostname()
    if not dist.is_available() or not dist.is_initialized():
        return (me,)
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, me)
    return tuple(hosts)


def axis_group_size(mesh, dim_name: str,
                    hosts: Optional[Sequence[str]]) -> int:
    """Fast group size along one mesh dim: how many consecutive ranks along
    ``dim_name`` share a host (the reference's ``npergroup``), with
    ``hosts`` the host name of each global rank (:func:`world_hosts`).

    Returns the full dim size when the dim lies on one host, when the
    grouping is irregular or differs between the positions along the
    other dim (then a two-tier schedule would cross hosts in its "fast"
    steps), or when ``hosts`` is None (a grid bound to a caller's mesh):
    a flat ring."""
    names = list(mesh.mesh_dim_names)
    ranks = np.moveaxis(np.asarray(mesh.mesh.cpu()), names.index(dim_name), 0)
    cols = ranks.reshape(ranks.shape[0], -1)
    P = cols.shape[0]
    if hosts is None:
        return P
    K = P
    for c in range(cols.shape[1]):
        group = [hosts[int(r)] for r in cols[:, c]]
        k = next((i for i in range(1, P) if group[i] != group[0]), P)
        if k == P or P % k:
            return P
        for g in range(P // k):
            if len(set(group[g * k:(g + 1) * k])) != 1:
                return P
        if c == 0:
            K = k
        elif k != K:
            return P
    return K


def check_cards(device: torch.device) -> None:
    """Raise when ranks of an NCCL default group share a card (NCCL refuses
    two ranks on one GPU; ranks that share a card run over gloo with the
    kernel exchanges).  Collective when the group is NCCL; free otherwise."""
    device = torch.device(device)
    if device.type != "cuda" or "nccl" not in str(dist.get_backend()):
        return
    mine = str(torch.cuda.get_device_properties(device).uuid)
    cards = [None] * dist.get_world_size()
    dist.all_gather_object(cards, mine)
    if len(set(cards)) < len(cards):
        raise RuntimeError(
            f"{len(cards)} ranks on {len(set(cards))} card(s) over an NCCL "
            f"process group: NCCL refuses two ranks on one GPU. Initialise "
            f"the default group with gloo and exchange with "
            f"TransposeMethod.PALLAS_A2A and HaloMethod.PALLAS")
