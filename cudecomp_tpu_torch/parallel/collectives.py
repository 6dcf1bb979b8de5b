"""Exchange strategies — the "communication backends" of the transpose.

Block contract (the same as ``cudecomp_tpu.parallel.collectives``): the
input is ``(P*B, ...)`` where block ``p`` (rows ``p*B:(p+1)*B``) is destined
for peer ``p`` of the axis group; the output has block ``q`` holding what
peer ``q`` sent.

  * ``exchange_all_to_all`` — one ``torch.distributed.all_to_all_single``
    over the axis group (NCCL on the GPU, gloo on the CPU): the analog of
    the reference's NCCL/MPI one-shot backends.

The per-peer strategies (``ring``, ``ring_xor``, ``ring_hier``, the
pipelined transpose) and the kernel exchange (``pallas_a2a``) are not
ported yet: they raise ``NotImplementedError`` when an exchange over more
than one rank would run.  A slab transpose never exchanges, so on a
``(1, 1)`` grid every method works.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def exchange_all_to_all(blocks: torch.Tensor, group, n: int,
                        block: int) -> torch.Tensor:
    """One-shot all-to-all: block p -> peer p, received stacked by peer.
    Complex tensors cross as their ``view_as_real`` float pairs."""
    if blocks.shape[0] != n * block:
        raise ValueError(f"blocks have {blocks.shape[0]} rows, expected "
                         f"{n} peers x {block}")
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


EXCHANGES = {
    "all_to_all": exchange_all_to_all,
    "ring": _not_ported("ring"),
    "ring_xor": _not_ported("ring_xor"),
    "ring_hier": _not_ported("ring_hier"),
    "pallas_a2a": _not_ported("pallas_a2a"),
    # "ring_pipelined" restructures the whole transpose, not just the
    # exchange; the transpose engine handles (and for now rejects) it
}
