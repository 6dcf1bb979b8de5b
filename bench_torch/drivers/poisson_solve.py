"""A closed loop of spectral Poisson solves through the port's
``PoissonSolver.solve``: the r2c split-complex solve with its FFT plan's
K5 policy pinned (``fused2``), from two seeded right-hand sides in turn.

Per solve, on one rank at pdims (1, 1): the r2c FFT along X, K5 forward
over the half spectrum's planes, the two plane products by
``-1/|k|^2``, the complex rebuild, K5 inverse, the c2r FFT along X with
its input copy, and the one 1/N pass.  Set-up asserts that the plan takes
K5 (``fused2`` and ``dft2_fits`` on the spectrum) and, on the card, that
every warm-up solve launched it twice: a cell that fell back to cuFFT
would measure another path.

The right-hand sides are standard-normal float32 over the whole periodic
box, made on the device from the seed.  Iteration ``i`` solves rhs
``i % 2``, so the answer of every solve is known whatever the window's
length, and the previous output is dropped before the next solve, so that
a pass that leaves part of its output unwritten leaves the other answer's
values there.  Each iteration copies one z-line of its output, at a
position drawn from the seed; the last output is kept whole.  The check,
after the window, against the float64 reference (``reference/
poisson_fft.py``) of the rhs each solve was given:

* ``poisson_rel_l2``: the last output, relative L2;
* ``poisson_max_rel``: its max abs error over the reference's max (one
  wrong region moves the L2 by less than rounding does);
* ``poisson_rows_rel``: each iteration's line against the reference's,
  the largest L2 error over the L2 norm of the reference's average line
  (its whole norm over the square root of its lines), so that a solve
  that wrote no new output fails.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bench_torch import yardstick
from bench_torch.drivers.heat_step import Lines, fields
from bench_torch.reference import poisson_fft as ref

#: x-planes of the last output compared at a time
BLOCK = 256


class Driver:
    def __init__(self, ctx, config, traffic):
        if ctx.world != 1 or tuple(config["pdims"]) != (1, 1):
            raise ValueError("the Poisson driver runs on one rank")
        if (config["dtype"] != "float32" or not all(config["periods"])
                or not (config["real"] and config["split_complex"])
                or config["discrete"]):
            raise ValueError("the Poisson driver runs the continuous r2c "
                             "split-complex solve of a periodic float32 box")
        self.ctx = ctx
        self.limits = config["limits"]
        self.gdims = tuple(config["gdims"])
        self.lengths = tuple(float(v) for v in config["lengths"])
        self.fused2 = config["fused2"]
        self.warmup = int(traffic["warmup"])
        self.trace_iterations = int(traffic["trace_iterations"])
        self.rng = np.random.default_rng([ctx.seed % (1 << 63), 0])
        self.turn = 0       # the rhs the next iteration solves

    # -- set-up ---------------------------------------------------------------

    def setup(self):
        import cudecomp_tpu_torch as cd
        from cudecomp_tpu_torch.models.poisson import PoissonSolver
        from cudecomp_tpu_torch.ops import dft2 as D

        self.cd = cd
        grid = cd.make_grid(cd.GridConfig(gdims=self.gdims, pdims=(1, 1)),
                            self.ctx.device)
        want = yardstick.pencil(self.gdims, (1, 1), 0, False, 0)[1]
        if tuple(grid.buffer_shape(0)) != want:
            raise ValueError(f"the program's X-pencil is "
                             f"{tuple(grid.buffer_shape(0))}, not {want}")
        self.solver = PoissonSolver(grid=grid, lengths=self.lengths,
                                    real=True, split_complex=True,
                                    fused2=self.fused2)
        spectrum = self.solver.plan.complex_grid.buffer_shape(0)
        if not (self.fused2 and D.dft2_fits(torch.empty(
                spectrum, dtype=torch.complex64, device="meta"))):
            raise ValueError(f"K5 does not take the {tuple(spectrum)} "
                             f"spectrum's (1, 2) planes")
        self.u = fields(self.gdims, self.ctx.seed, self.ctx.device)
        self.lines = Lines(self.gdims[2], self.ctx.device)
        self.begin_window()
        n0 = D.launch_count
        for _ in range(self.warmup):
            self.iteration()
        launched = D.launch_count - n0
        if (self.ctx.device.type == "cuda" and self.ctx.impl == "program"
                and launched != 2 * self.warmup):
            raise RuntimeError(f"{self.warmup} solves launched K5 "
                               f"{launched} times, not twice each")
        self.begin_window()

    def begin_window(self):
        self.rows = []      # per iteration: its rhs and the line's (x, y)
        self.lines.clear()
        self.last = None

    def _solve(self, f):
        if self.ctx.impl == "control":
            return ref.control_solve(f, self.lengths)
        return self.solver.solve(f)

    def iteration(self):
        self.last = None    # the previous output goes before the next is made
        f, self.turn = self.turn, (self.turn + 1) % len(self.u)
        out = self._solve(self.u[f])
        a = int(self.rng.integers(self.gdims[0]))
        b = int(self.rng.integers(self.gdims[1]))
        self.lines.put(out[a, b])
        self.rows.append((f, a, b))
        self.last = out

    def work(self):
        return {"steps": 1}     # one solve an iteration

    # -- the check ------------------------------------------------------------

    def release(self):
        self.solver = None
        self.cd.clear_plan_caches()

    def check(self):
        out, self.last = self.last, None
        f_last = self.rows[-1][0]
        got = torch.cat(self.lines.chunks)[:len(self.rows)].to(torch.float64)
        rows = torch.tensor(self.rows, device=got.device)
        rows_rel = torch.full((len(self.rows),), math.inf,
                              dtype=torch.float64, device=got.device)
        err2 = ref2 = err_max = ref_max = 0.0
        for f, u in enumerate(self.u):
            want = ref.solve(u, self.lengths)
            sel = (rows[:, 0] == f).nonzero().flatten()
            w = want[rows[sel, 1], rows[sel, 2]]
            # over the norm of the reference's average line: a line where
            # the long box's leading x-modes cross zero is small, and its
            # own norm would magnify rounding
            line = (torch.linalg.vector_norm(want)
                    / math.sqrt(self.gdims[0] * self.gdims[1]))
            rows_rel[sel] = (torch.linalg.vector_norm(got[sel] - w, dim=1)
                             / line)
            if f == f_last:
                for x0 in range(0, self.gdims[0], BLOCK):
                    d = want[x0:x0 + BLOCK]
                    diff = out[x0:x0 + BLOCK].to(torch.float64) - d
                    err2 += float(diff.square().sum())
                    ref2 += float(d.square().sum())
                    err_max = yardstick.worst((err_max,
                                               float(diff.abs().max())))
                    ref_max = max(ref_max, float(d.abs().max()))
                    del diff
            del want
        rows_rel = rows_rel.tolist()
        lim = self.limits
        checks = {
            "poisson_rel_l2": (math.sqrt(err2 / ref2), lim["poisson_rel_l2"]),
            "poisson_max_rel": (err_max / ref_max, lim["poisson_max_rel"]),
            "poisson_rows_rel": (yardstick.worst(rows_rel),
                                 lim["poisson_rows_rel"]),
        }
        bad = [not (r <= lim["poisson_rows_rel"]) for r in rows_rel]
        if not (checks["poisson_rel_l2"][0] <= lim["poisson_rel_l2"]
                and checks["poisson_max_rel"][0] <= lim["poisson_max_rel"]):
            bad[-1] = True
        return checks, sum(bad)
