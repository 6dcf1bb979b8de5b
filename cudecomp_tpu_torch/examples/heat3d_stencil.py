"""3D heat-equation stencil on a pencil decomposition: the halo engine
inside a consumer pipeline.

Explicit 7-point Laplacian diffusion on a periodic box,

    u_{t+1} = u_t + dt * lap(u_t),

two ways: the halo'd-buffer pipeline (``update_halos`` and a shifted-slice
stencil on each rank's buffer, the reference's architecture) and the
ghost-plane pipeline (``diffusion_step``: K4 on a CUDA tensor), both
checked against numpy; on one card the two are then timed side by side.
On ranks that share a card the ghost-plane shifts cannot run (gloo moves
CPU tensors), so that pipeline is reported as refused there.

    python -m cudecomp_tpu_torch.examples.heat3d_stencil [--device cpu] [--ranks N] [--n N] [--steps S]
"""

import numpy as np
import torch

import cudecomp_tpu_torch as ct
from cudecomp_tpu_torch import performance
from cudecomp_tpu_torch.config import CannotRun
from cudecomp_tpu_torch.examples import _launch
from cudecomp_tpu_torch.geometry import squarest_pdims

HE = (1, 1, 1)                      # width-1 halos, all dims
PERIODS = (True, True, True)


def make_step(grid, dt, with_halo=True):
    """One diffusion step on the halo'd X-pencil buffer (natural layout,
    no padding: the interior is ``[1:-1]`` along each dim)."""
    assert grid.config.mem_order(0) == (0, 1, 2)

    def step(ul):
        if with_halo:
            ul = ct.update_halos(grid, ul, 0, HE, PERIODS)
        core = ul[1:-1, 1:-1, 1:-1]
        lap = (ul[:-2, 1:-1, 1:-1] + ul[2:, 1:-1, 1:-1]
               + ul[1:-1, :-2, 1:-1] + ul[1:-1, 2:, 1:-1]
               + ul[1:-1, 1:-1, :-2] + ul[1:-1, 1:-1, 2:]
               - 6.0 * core)
        out = ul.clone()
        out[1:-1, 1:-1, 1:-1] = core + dt * lap
        return out

    return step


def numpy_steps(u0, dt, steps):
    u = u0.astype(np.float64)
    for _ in range(steps):
        lap = sum(np.roll(u, s, axis=d) for d in range(3) for s in (-1, 1)
                  ) - 6.0 * u
        u = u + dt * lap
    return u


def run(a, rank: int) -> None:
    device = _launch.device_of(a)
    N, steps, dt = a.n, a.steps, 0.1
    # ranks that share a card update halos with K3
    halo = (ct.HaloMethod.PALLAS if _launch.shared_card(a)
            else ct.HaloMethod.PPERMUTE)
    cfg = ct.GridConfig(gdims=(N, N, N), pdims=squarest_pdims(a.ranks),
                        halo_method=halo)
    grid = ct.make_grid(cfg, device)
    _launch.say(rank, f"heat3d: {N}^3 on pdims {cfg.pdims}, dt={dt}")

    ax = np.arange(N) - N / 2.0
    r2 = (ax[:, None, None] ** 2 + ax[None, :, None] ** 2
          + ax[None, None, :] ** 2)
    blob = np.exp(-r2 / (2.0 * (N / 16.0) ** 2)).astype(np.float32)
    u = ct.scatter_global(grid, torch.from_numpy(blob), 0, halo_extents=HE)
    step = make_step(grid, dt)
    out = u
    for _ in range(steps):
        out = step(out)
    got = _launch.gather(grid, out, 0, halo_extents=HE)
    want = numpy_steps(blob, dt, steps)
    err = float(np.max(np.abs(got - want)))
    e0, e1 = float(np.sum(blob ** 2)), float(np.sum(got ** 2))
    _launch.say(rank, f"  halo'd-buffer pipeline: max err vs numpy after "
                      f"{steps} steps: {err:.3g}")
    _launch.say(rank, f"  energy {e0:.6f} -> {e1:.6f} (diffusion decays "
                      f"energy)")
    assert err < 1e-4, err
    assert e1 < e0

    # the ghost-plane pipeline: interior layout, no halo buffer, K4 on
    # a CUDA tensor
    ui = ct.scatter_global(grid, torch.from_numpy(blob), 0)

    def ghost(v):
        return ct.diffusion_step(grid, v, dt, 0, PERIODS)

    try:
        g = ui
        for _ in range(steps):
            g = ghost(g)
    except CannotRun as e:
        _launch.say(rank, f"  ghost-plane pipeline: not run here: {e}")
        return
    err_g = float(np.max(np.abs(_launch.gather(grid, g, 0) - want)))
    _launch.say(rank, f"  ghost-plane pipeline:   max err vs numpy: "
                      f"{err_g:.3g}")
    assert err_g < 1e-4, err_g

    # one card: the marginal halo cost, (halo + stencil) vs stencil only,
    # beside the ghost-plane step
    if a.ranks == 1 and device.type == "cuda":
        for label, fn, x0 in (
                ("halo+stencil", step, u),
                ("stencil-only", make_step(grid, dt, with_halo=False), u),
                ("ghost-plane diffusion_step (K4)", ghost, ui)):
            ts = performance.time_fn(fn, x0, n_warmup=3, n_trials=3,
                                     iters=8)
            _launch.say(rank, f"  {label}: {min(ts) * 1e3:.3f} ms/step")


def main(argv=None) -> float:
    a = _launch.parse(__doc__, 64, argv, extra=(("--steps", 10),))
    secs = _launch.main("cudecomp_tpu_torch.examples.heat3d_stencil", a)
    print(f"heat3d_stencil: {secs:.3f} s")
    return secs


if __name__ == "__main__":
    main()
