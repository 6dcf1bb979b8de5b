"""Basic usage: the analog of the reference's examples/cc/basic_usage.

Decompose a global field, run the full transpose cycle and a halo update,
and check that the data survives.  ``pdims (0, 0)`` runs the autotuner
over the process grids, transpose methods and halo methods that can run
on the device.

    python -m cudecomp_tpu_torch.examples.basic_usage [--device cpu] [--ranks N] [--n N]
"""

import numpy as np
import torch

import cudecomp_tpu_torch as ct
from cudecomp_tpu_torch.examples import _launch


def run(a, rank: int) -> None:
    device = _launch.device_of(a)
    n = a.n
    cfg = ct.GridConfig(gdims=(n, n, n), pdims=(0, 0))
    he = (1, 1, 1)
    grid = ct.make_grid(cfg, device, autotune_options=ct.AutotuneOptions(
        n_warmup=1, n_trials=2, autotune_halo_method=True, halo_extents=he))
    _launch.say(rank, f"ranks: {a.ranks}, device {device}")
    _launch.say(rank, f"autotuned: pdims={grid.pdims} method="
                      f"{grid.config.transpose_method.value} halo="
                      f"{grid.config.halo_method.value}")
    # pencil info, like cudecompGetPencilInfo
    for axis, name in enumerate("xyz"):
        pi = grid.pencil_info(axis, rank=0)
        _launch.say(rank, f"  {name}-pencil rank 0: shape={pi.shape} "
                          f"lo={pi.lo} hi={pi.hi}")

    f = np.random.default_rng(42).standard_normal(cfg.gdims)
    ft = torch.from_numpy(f)
    x = ct.scatter_global(grid, ft, axis=0)
    y = ct.transpose_x_to_y(grid, x)
    z = ct.transpose_y_to_z(grid, y)
    y2 = ct.transpose_z_to_y(grid, z)
    x2 = ct.transpose_y_to_x(grid, y2)
    assert np.allclose(_launch.gather(grid, x2, 0), f)
    _launch.say(rank, "transpose cycle: data intact")

    h = ct.scatter_global(grid, ft, 0, halo_extents=he)
    h = ct.update_halos(grid, h, 0, he, halo_periods=(True, True, True))
    assert np.allclose(_launch.gather(grid, h, 0, halo_extents=he), f)
    _launch.say(rank, "halo update: interior intact")


def main(argv=None) -> float:
    a = _launch.parse(__doc__, 64, argv)
    secs = _launch.main("cudecomp_tpu_torch.examples.basic_usage", a)
    print(f"basic_usage: {secs:.3f} s")
    return secs


if __name__ == "__main__":
    main()
