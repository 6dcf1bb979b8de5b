"""Fractional-step incompressible Navier-Stokes on a pencil decomposition.

The composite consumer pattern the reference library serves (finite-
difference CFD codes): every step composes ghost-cell passes for
advection and diffusion, the divergence and the pressure gradient with a
distributed FFT round trip for the pressure-Poisson solve, through
:class:`cudecomp_tpu_torch.models.ProjectionSolver`.  The projection is
exact at the discrete level, so the example checks two tight invariants:

  1. the velocity stays discretely divergence-free every step;
  2. on the extruded 2D Taylor-Green vortex the nonlinear terms cancel
     under the discrete projection, so the energy follows the RK4
     stability polynomial of the discrete viscous eigenvalue: to 1e-9 in
     float64 (the CPU) and 1e-4 in float32 (the card).

On ranks that share a card the ghost-cell shifts cannot run (gloo moves
CPU tensors): the example then reports the refusal.

    python -m cudecomp_tpu_torch.examples.ns_projection [--device cpu] [--ranks N] [--n N] [--steps S]
"""

import time

import torch

import cudecomp_tpu_torch as ct
from cudecomp_tpu_torch.config import CannotRun
from cudecomp_tpu_torch.examples import _launch
from cudecomp_tpu_torch.geometry import squarest_pdims
from cudecomp_tpu_torch.models import ProjectionSolver
from cudecomp_tpu_torch.models.incompressible import rk_stability


def run(a, rank: int) -> None:
    device = _launch.device_of(a)
    N, steps = a.n, a.steps
    pdims = squarest_pdims(a.ranks)
    f64 = device.type == "cpu"
    dtype = torch.float64 if f64 else torch.float32
    method = (ct.TransposeMethod.PALLAS_A2A if _launch.shared_card(a)
              else ct.TransposeMethod.ALL_TO_ALL)
    grid = ct.make_grid(ct.GridConfig(gdims=(N, N, N), pdims=pdims,
                                      transpose_method=method), device)
    solver = ProjectionSolver(grid=grid, nu=0.02, scheme="rk4",
                              split_complex=not f64)
    u0, fields = solver.setup_tg(dtype=dtype)
    dt = 1e-2
    try:
        u = solver.step(u0, fields, dt)
    except CannotRun as e:
        _launch.say(rank, f"not run on ranks that share a card: {e}")
        return
    e0 = float(solver.energy(u0))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    maxdiv = 0.0
    for _ in range(steps - 1):
        u = solver.step(u, fields, dt)
        maxdiv = max(maxdiv, float(solver.max_divergence(u)))
    ms = (time.perf_counter() - t0) / max(steps - 1, 1) * 1e3

    z = solver.viscous_eigenvalue((1, 1, 0)) * dt
    want = rk_stability("rk4", z) ** (2 * steps)
    got = float(solver.energy(u)) / e0
    tol = 1e-9 if f64 else 1e-4
    _launch.say(rank, f"{N}^3 pdims {pdims} dtype {dtype}: {ms:.2f} "
                      f"ms/RK4-step (with the divergence check)")
    _launch.say(rank, f"energy ratio {got:.12f} vs RK4 polynomial "
                      f"{want:.12f} (|err| {abs(got - want):.2e}, tol "
                      f"{tol:g})")
    _launch.say(rank, f"max |div_h u| over run: {maxdiv:.2e}")
    assert abs(got - want) < tol, (got, want)
    div_tol = 1e-10 if f64 else 5e-3
    assert maxdiv < div_tol, maxdiv
    _launch.say(rank, "OK")


def main(argv=None) -> float:
    a = _launch.parse(__doc__, 32, argv, extra=(("--steps", 10),))
    secs = _launch.main("cudecomp_tpu_torch.examples.ns_projection", a)
    print(f"ns_projection: {secs:.3f} s")
    return secs


if __name__ == "__main__":
    main()
