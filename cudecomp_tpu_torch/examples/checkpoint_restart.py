"""Checkpoint/restart across a process-grid re-decomposition.

Checkpoints a field shard-wise on one process grid and restores it onto a
different one with its halos pre-filled: the workflow of a solver that
changes its allocation between runs.  With N ranks the field is saved on
the squarest grid of N and restored on (1, N) (so (2, 2) onto (1, 4) with
4 ranks); on one rank it is restored into the axis-contiguous layout.

    python -m cudecomp_tpu_torch.examples.checkpoint_restart [--device cpu] [--ranks N] [--n N]
"""

import dataclasses
import os

import numpy as np
import torch

import cudecomp_tpu_torch as ct
from cudecomp_tpu_torch.examples import _launch
from cudecomp_tpu_torch.geometry import squarest_pdims
from cudecomp_tpu_torch.utils import checkpoint as ckpt
from cudecomp_tpu_torch.utils.testing import expected_halo_buffer


def run(a, rank: int) -> None:
    device = _launch.device_of(a)
    n = a.n
    f = np.fromfunction(
        lambda x, y, z: np.sin(2 * np.pi * x / n) * np.cos(2 * np.pi * y / n),
        (n, n, n))
    g1 = ct.make_grid(ct.GridConfig(gdims=(n, n, n),
                                    pdims=squarest_pdims(a.ranks)), device)
    buf = ct.scatter_global(g1, torch.from_numpy(f), axis=0)
    d = os.path.join(a.workdir, "ckpt")
    ckpt.save_pencil(d, g1, buf, axis=0)

    # restore on a different decomposition (or layout, on one rank)
    c2 = ct.GridConfig(gdims=(n, n, n), pdims=(1, a.ranks))
    if a.ranks == 1:
        c2 = dataclasses.replace(c2, transpose_axis_contiguous=(True,) * 3)
    g2 = ct.make_grid(c2, device)
    he = (1, 1, 1)
    buf2 = ckpt.load_pencil(d, g2, halo_extents=he, fill_halos=True)
    got = _launch.gather(g2, buf2, 0, halo_extents=he)
    assert np.allclose(got, f), "restore mismatch"
    # the pre-filled halos hold the periodic neighbours' values
    want = expected_halo_buffer(g2, torch.from_numpy(f), 0, he,
                                (True, True, True))
    assert torch.equal(buf2.cpu(), want.cpu()), "halos not pre-filled"
    _launch.say(rank, f"checkpoint round trip OK: {g1.pdims} -> {g2.pdims}, "
                      f"halos pre-filled, max err "
                      f"{np.max(np.abs(got - f)):.2e}")


def main(argv=None) -> float:
    a = _launch.parse(__doc__, 32, argv)
    secs = _launch.main("cudecomp_tpu_torch.examples.checkpoint_restart", a)
    print(f"checkpoint_restart: {secs:.3f} s")
    return secs


if __name__ == "__main__":
    main()
