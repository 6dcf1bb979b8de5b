"""Spectral calculus on the distributed FFT: the vorticity of an analytic
flow.

The reference's example solvers build their spectral operators inline
(``examples/cc/taylor_green/tg.cu:139-210``: wavenumbers, curl and the
Leray projection); this example computes the vorticity of the
Taylor-Green vortex with :class:`cudecomp_tpu_torch.SpectralOperators`,
checks it against the closed form, and checks that the Leray projection
leaves the divergence-free field as it is.  float64 on the CPU, float32
on the card; the gates follow the dtype.

    python -m cudecomp_tpu_torch.examples.spectral_ops [--device cpu] [--ranks N] [--n N]
"""

import numpy as np
import torch

import cudecomp_tpu_torch as ct
from cudecomp_tpu_torch.examples import _launch


def run(a, rank: int) -> None:
    device = _launch.device_of(a)
    n = a.n
    gdims = (n, n, n)
    # ranks that share a card exchange with K2
    method = (ct.TransposeMethod.PALLAS_A2A if _launch.shared_card(a)
              else ct.TransposeMethod.ALL_TO_ALL)
    grid = ct.make_grid(ct.GridConfig(gdims=gdims, pdims=(1, a.ranks),
                                      transpose_method=method), device)
    f64 = device.type == "cpu"
    dtype = torch.float64 if f64 else torch.float32
    _launch.say(rank, f"ranks: {a.ranks}, pdims: {grid.pdims}, {dtype}")

    # Taylor-Green velocity on [0, 2pi)^3
    xs = [np.arange(m) * 2 * np.pi / m for m in gdims]
    x, y, z = np.meshgrid(*xs, indexing="ij")
    u = np.stack([np.cos(x) * np.sin(y) * np.sin(z),
                  -np.sin(x) * np.cos(y) * np.sin(z),
                  np.zeros_like(x)], axis=-1)

    plan = ct.DistributedFFT(grid=grid, real=True)
    sops = ct.SpectralOperators(plan=plan)
    comps = [plan.forward(ct.scatter_global(
        grid, torch.from_numpy(u[..., c]).to(dtype), 0)) for c in range(3)]
    uh = torch.stack(comps, dim=-1)

    # vorticity = curl(u); the TG vortex's closed form:
    #   w_x = sin x cos y cos z, w_y = cos x sin y cos z,
    #   w_z = -2 cos x cos y sin z
    wh = sops.curl(uh)
    w = np.stack([_launch.gather(grid, plan.inverse(wh[..., c].contiguous()),
                                 0) for c in range(3)], axis=-1)
    ref = np.stack([np.sin(x) * np.cos(y) * np.cos(z),
                    np.cos(x) * np.sin(y) * np.cos(z),
                    -2 * np.cos(x) * np.cos(y) * np.sin(z)], axis=-1)
    err = np.abs(w - ref).max()
    _launch.say(rank, f"curl max err vs closed form: {err:.2e}")
    assert err < (1e-6 if f64 else 1e-4), err

    # the TG field is divergence-free: the Leray projection is an identity
    ph = sops.project_solenoidal(uh)
    derr = float((ph - uh).abs().max().cpu())
    scale = float(uh.abs().max().cpu())  # unnormalised spectral coeffs
    if grid.mesh is not None:  # the max over the ranks, on the host
        import torch.distributed as dist
        t = torch.tensor([derr, scale], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        derr, scale = float(t[0]), float(t[1])
    _launch.say(rank, f"projection identity on solenoidal field: "
                      f"{derr:.2e} (relative {derr / scale:.2e})")
    assert derr / scale < (1e-12 if f64 else 1e-6)
    _launch.say(rank, "OK")


def main(argv=None) -> float:
    a = _launch.parse(__doc__, 64, argv)
    secs = _launch.main("cudecomp_tpu_torch.examples.spectral_ops", a)
    print(f"spectral_ops: {secs:.3f} s")
    return secs


if __name__ == "__main__":
    main()
