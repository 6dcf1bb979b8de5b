"""A closed loop of conjugate-gradient iterations of one solve of the
discrete periodic Poisson equation, through the port's
``PoissonSolver.cg_init`` and ``cg_iterate``: the iteration that
``solve_cg`` runs, with its host read of ``r . r`` every ``check_every``
iterations.  The solve is continued across warm-up, traced window and
timed window, and never restarted.

The right-hand side ``f`` is standard-normal float32 over the whole
periodic box on one rank, made on the device from the seed; the solver
removes its mean.  Each iteration keeps the state it started from by
reference (no copy; the one before is dropped first, so that two states
and the iteration's temporaries are what the device holds), and the
step length and ``r . r`` it used, 0-d tensors on the device (no sync).
``begin_window`` reads the energy ``phi(u) = u.Au/2 - b.u`` of the state
the window starts from.

The check, after the window, in float64 (``reference/cg7.py``):

* ``cg_step_rel_l2``: the last iteration's increments of ``u``, ``r``
  and ``p`` against the reference's iteration from the same input state;
  the largest of the three relative L2 errors;
* ``cg_step_max_rel``: the largest ``max|error| / max|reference|`` of the
  same increments (one wrong cell moves an L2 by less than rounding);
* ``cg_residual_gap``: ``|b - A u - r| / |b|`` for the final state: an
  iteration that moved ``u`` and ``r`` apart, anywhere in the run, leaves
  the recurrence residual off the true one;
* ``cg_energy_rel``: the decrease of ``phi`` over the window against the
  sum of ``alpha_k rs_k / 2`` over the iterations the window counted,
  relative to that sum: an iteration that did no work, or part of it,
  breaks the identity (by its share of the sum: an early iteration of the
  window by a larger share than a late one, and the last by the step
  check).

The solve must still be in progress at the end (its host-read relative
residual above ``tol``): a run that converged measured iterations past
the solve's end, and raises.
"""

from __future__ import annotations

import math

import torch

from bench_torch import yardstick
from bench_torch.drivers.heat_step import fields
from bench_torch.reference import cg7 as ref


class Driver:
    def __init__(self, ctx, config, traffic):
        if ctx.world != 1 or tuple(config["pdims"]) != (1, 1):
            raise ValueError("the CG driver runs on one rank")
        if config["dtype"] != "float32" or not all(config["periods"]):
            raise ValueError("the CG driver solves on a periodic float32 box")
        self.ctx = ctx
        self.limits = config["limits"]
        self.gdims = tuple(config["gdims"])
        self.lengths = tuple(float(v) for v in config["lengths"])
        self.tol = float(config["tol"])
        self.check_every = int(config["check_every"])
        self.warmup = int(traffic["warmup"])
        self.trace_iterations = int(traffic["trace_iterations"])
        self.w = ref.weights(self.gdims, self.lengths)

    # -- set-up ---------------------------------------------------------------

    def setup(self):
        import cudecomp_tpu_torch as cd
        from cudecomp_tpu_torch.models.poisson import PoissonSolver

        self.cd = cd
        grid = cd.make_grid(cd.GridConfig(gdims=self.gdims, pdims=(1, 1)),
                            self.ctx.device)
        want = yardstick.pencil(self.gdims, (1, 1), 0, False, 0)[1]
        if tuple(grid.buffer_shape(0)) != want:
            raise ValueError(f"the program's X-pencil is "
                             f"{tuple(grid.buffer_shape(0))}, not {want}")
        self.solver = PoissonSolver(grid=grid, lengths=self.lengths)
        self.f = fields(self.gdims, self.ctx.seed, self.ctx.device, n=1)[0]
        self.state = self.solver.cg_init(self.f)
        self.prev, self.terms = None, []
        for _ in range(self.warmup):
            self.iteration()
        self.begin_window()

    def begin_window(self):
        self.terms = []     # per iteration: (its input's rs, its alpha)
        self.phi0 = ref.residual_and_energy(self.state.u, self.state.r,
                                            self.f, self.w)[2]

    def _iterate(self, s):
        if self.ctx.impl == "control":
            u, r, p, rs, alpha = ref.control_iteration(s.u, s.r, s.p, s.rs,
                                                       self.w)
            return s._replace(u=u, r=r, p=p, rs=rs, alpha=alpha, it=s.it + 1)
        return self.solver.cg_iterate(s, self.check_every)

    def iteration(self):
        self.prev = None    # the state before the last goes first
        self.prev, self.state = self.state, self._iterate(self.state)
        self.terms.append((self.prev.rs, self.state.alpha))

    def work(self):
        return {"steps": 1}     # one CG iteration an iteration

    # -- the check ------------------------------------------------------------

    def release(self):
        self.solver = None
        self.cd.clear_plan_caches()

    def check(self):
        prev, s = self.prev, self.state
        if s.rel_residual <= self.tol:
            raise RuntimeError(
                f"the solve converged (|r|/|b| {s.rel_residual:.3e} at "
                f"iteration {s.it}): the run timed iterations past its end")
        alpha, beta, _ = ref.scalars(prev.r, prev.p, float(prev.rs), self.w)
        err2, ref2, err_max, ref_max = ([0.0] * 3 for _ in range(4))
        for x0, x1, *incs in ref.increment_blocks(prev.r, prev.p, alpha, beta,
                                                  self.w):
            for k, (new, old, d) in enumerate(zip((s.u, s.r, s.p),
                                                  (prev.u, prev.r, prev.p),
                                                  incs)):
                e = new[x0:x1].to(torch.float64) - old[x0:x1] - d
                err2[k] += float(e.square().sum())
                ref2[k] += float(d.square().sum())
                err_max[k] = yardstick.worst((err_max[k], float(e.abs().max())))
                ref_max[k] = max(ref_max[k], float(d.abs().max()))
                del e
        rel = [math.sqrt(e / r) if r > 0 else math.inf
               for e, r in zip(err2, ref2)]
        mx = [e / r if r > 0 else math.inf for e, r in zip(err_max, ref_max)]
        gap, b_norm, phi1 = ref.residual_and_energy(s.u, s.r, self.f, self.w)
        work = 0.5 * sum(float(rs) * (0.0 if a is None else float(a))
                         for rs, a in self.terms)
        energy = abs((self.phi0 - phi1) - work) / max(abs(work), 1e-300)
        lim = self.limits
        checks = {
            "cg_step_rel_l2": (yardstick.worst(rel), lim["cg_step_rel_l2"]),
            "cg_step_max_rel": (yardstick.worst(mx), lim["cg_step_max_rel"]),
            "cg_residual_gap": (gap / b_norm, lim["cg_residual_gap"]),
            "cg_energy_rel": (energy, lim["cg_energy_rel"]),
        }
        ok = all(v <= limit for v, limit in checks.values())
        return checks, 0 if ok else 1
