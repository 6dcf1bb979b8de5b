"""A closed loop of Taylor-Green RK4 steps through
``TaylorGreenSolver.step``, from a vortex translated by a shift drawn
from the seed (the same flow, and the same work, on every seed).

The solver is built as the configuration states it (``nu``, dealiasing,
explicit RK4 or not, interleaved complex state) and its spectral fields
come from its own ``setup``; its initial state is the r2c transform, by
the solver's plan, of the shifted vortex.  ``dt`` is the solver's CFL rule
(``cfl_dt``) at that state, held fixed.

The check, after the window: the last step's input state and its output
are kept, and the plain reference (``reference/taylor_green.py``, in
complex128) takes the same input one step.  Compared, over the step's
increment ``out - in``:

* ``step_rel_l2``: ``|d_program - d_reference| / |d_reference|``;
* ``step_max_rel``: ``max|d_program - d_reference| / max|d_reference|``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bench_torch import yardstick
from bench_torch.reference.taylor_green import ExplicitRK4, initial_velocity


class Driver:
    def __init__(self, ctx, config, traffic):
        if ctx.world != 1 or tuple(config["pdims"]) != (1, 1):
            raise ValueError("the Taylor-Green driver runs on one rank")
        self.ctx = ctx
        self.config = config
        self.limits = config["limits"]
        self.gdims = tuple(config["gdims"])
        self.nu = 1.0 / float(config["reynolds"])
        self.warmup = int(traffic["warmup"])
        self.trace_iterations = int(traffic["trace_iterations"])
        rng = np.random.default_rng(ctx.seed % (1 << 63))
        self.shift = tuple(float(s) for s in rng.uniform(0, 2 * math.pi, 3))

    def setup(self):
        import cudecomp_tpu_torch as cd
        from cudecomp_tpu_torch.models.taylor_green import TaylorGreenSolver

        c = self.config
        grid = cd.make_grid(cd.GridConfig(gdims=self.gdims, pdims=(1, 1)),
                            self.ctx.device)
        want = yardstick.pencil(self.gdims, (1, 1), 0, False, 0)[1]
        if tuple(grid.buffer_shape(0)) != want:
            raise ValueError(f"the program's X-pencil is "
                             f"{tuple(grid.buffer_shape(0))}, not {want}")
        self.solver = TaylorGreenSolver(
            grid=grid, nu=self.nu, dealias=bool(c["dealias"]),
            split_complex=bool(c["split_complex"]),
            integrating_factor=bool(c["integrating_factor"]))
        uh, self.fields = self.solver.setup(torch.float32)
        del uh
        u = initial_velocity(self.gdims, self.shift, self.ctx.device)
        self.uh = self.fields["plan"].forward(u)
        del u
        self.dt = float(self.solver.cfl_dt(self.uh, self.fields,
                                           float(c["cfl"])))
        self.control = None
        if self.ctx.impl == "control":
            self.control = ExplicitRK4(self.gdims, self.nu, self.ctx.device,
                                       bf16=True)
        for _ in range(self.warmup):
            self._step(self.uh)
        self.begin_window()

    def _step(self, uh):
        if self.control is not None:
            return self.control.step(uh, self.dt).to(torch.complex64)
        return self.solver.step(uh, self.fields, self.dt)

    def begin_window(self):
        self.prev = None

    def iteration(self):
        self.prev = self.uh
        self.uh = self._step(self.uh)

    def work(self):
        return {"steps": 1}

    def release(self):
        import cudecomp_tpu_torch as cd

        self.solver = self.fields = self.control = None
        cd.clear_plan_caches()

    def check(self):
        prev, out = self.prev, self.uh
        self.prev = self.uh = None
        ref = ExplicitRK4(self.gdims, self.nu, prev.device).step(prev, self.dt)
        d_ref = ref - prev
        del ref
        diff = out.to(torch.complex128) - prev
        diff -= d_ref
        del out
        rel = float(torch.linalg.vector_norm(diff)
                    / torch.linalg.vector_norm(d_ref))
        mx = float(diff.abs().max() / d_ref.abs().max())
        lim = self.limits
        checks = {"step_rel_l2": (rel, lim["step_rel_l2"]),
                  "step_max_rel": (mx, lim["step_max_rel"])}
        ok = all(v <= l for v, l in checks.values())
        return checks, 0 if ok else 1
