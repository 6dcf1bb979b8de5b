"""What every example shares: its command line (``--device``, ``--ranks``,
``--n``), the spawn of ``--ranks`` gloo ranks (CPU ranks, or ranks that
share ``cuda:0``) and a host-side gather for the checks against numpy."""

from __future__ import annotations

import argparse
import importlib
import os
import tempfile
import time

import numpy as np
import torch


def parse(doc: str, n: int, argv=None, extra=None) -> argparse.Namespace:
    """The example's arguments: ``--device`` (``cuda`` by default),
    ``--ranks`` (1) and ``--n`` (``n``), and ``extra`` ``(flag, default)``
    integer options."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--ranks", type=int, default=1)
    p.add_argument("--n", type=int, default=n)
    for flag, default in extra or ():
        p.add_argument(flag, type=int, default=default)
    return p.parse_args(argv)


def device_of(a) -> torch.device:
    """The device of this rank: ``cuda:0`` for every rank on the card."""
    dev = torch.device(a.device)
    return torch.device("cuda", 0) if dev.type == "cuda" else dev


def shared_card(a) -> bool:
    """Whether the ranks share one card over gloo: then only the kernel
    exchanges (``PALLAS_A2A``, ``HaloMethod.PALLAS``) carry CUDA tensors."""
    return torch.device(a.device).type == "cuda" and a.ranks > 1


def gather(grid, local: torch.Tensor, axis: int, **kw) -> np.ndarray:
    """The global field of this rank's pencil tensor as numpy (gathered
    on the host: gloo moves CPU tensors)."""
    import cudecomp_tpu_torch as ct
    return ct.gather_global(grid, local.detach().cpu(), axis, **kw).numpy()


def say(rank: int, msg: str) -> None:
    if rank == 0:
        print(msg, flush=True)


def _body(rank: int, module: str, a) -> None:
    importlib.import_module(module).run(a, rank)


def main(module: str, a, timeout: float = 900.0) -> float:
    """Run ``module.run(a, rank)`` on ``a.ranks`` ranks (in this process
    for one rank); returns the seconds it took.  ``a.workdir`` is a
    directory that every rank sees."""
    from cudecomp_tpu_torch.utils.testing import run_card_ranks, run_cpu_ranks
    t0 = time.perf_counter()
    if a.ranks > 1 and torch.device(a.device).type == "cuda":
        from cudecomp_tpu_torch.ops import (cuda_kernels, dft2,
                                            peer_kernels, stencil_kernel)
        for mod in (cuda_kernels, dft2, peer_kernels, stencil_kernel):
            mod.build()  # once, before the ranks start
    with tempfile.TemporaryDirectory(prefix="cudecomp_example_") as d:
        a.workdir = d
        if a.ranks == 1:
            _body(0, module, a)
        elif torch.device(a.device).type == "cuda":
            run_card_ranks(_body, a.ranks, os.path.join(d, "pg_init"),
                           (module, a), timeout, module)
        else:
            run_cpu_ranks(_body, a.ranks, os.path.join(d, "pg_init"),
                          (module, a), timeout, module)
    return time.perf_counter() - t0
