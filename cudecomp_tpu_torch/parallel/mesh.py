"""Process-grid meshes: the (Pr, Pc) ``DeviceMesh`` in the configured rank
order.

The reference creates row and column communicators from the rank order
(``src/cudecomp.cc:1039-1269``, ``include/internal/common.h:318-346``).
Here the process grid is a ``torch.distributed`` DeviceMesh with dims
``('pr', 'pc')``; each mesh dim owns the process group its transposes
exchange over.  ``init_device_mesh`` takes only a shape (row-major ranks),
so the mesh is built from an explicit rank tensor, which also covers the
column-major order.
"""

from __future__ import annotations

from typing import Tuple

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
