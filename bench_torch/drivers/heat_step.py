"""A closed loop of explicit heat steps through the port's
``diffusion_step`` (the 7-point Laplacian folded into one K4 pass), from
two seeded fields in turn.

The fields are standard-normal float32 over the whole periodic box on one
rank, made on the device from the seed.  Iteration ``i`` steps field
``i % 2``, so the work and the answer of every step are known and the
check does not depend on how many steps the window completed (a field
stepped on would decay until its increment reached float32 rounding).
The two fields make a missing write visible: the previous output is
dropped before the next step, so the allocator hands the step the block
that holds the other field's answer, and a pass that leaves part of the
box unwritten leaves that answer there.  Each iteration copies one z-line
of its output, at a position drawn from the seed, into a buffer made in
set-up; the last iteration's output is kept whole.  The check, after the
window, against the float64 reference (``reference/heat7.py``) over the
step's increment ``out - u`` of the field that iteration stepped:

* ``heat_rel_l2``: ``|d_program - d_reference| / |d_reference|`` over the
  last output;
* ``heat_max_rel``: ``max|d_program - d_reference| / max|d_reference|``
  over the last output (one wrong cell among 2**31 moves the L2 by less
  than rounding does);
* ``heat_rows_rel``: each iteration's line against the reference's (the
  largest relative L2), so that an iteration that wrote no new output
  fails.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bench_torch import yardstick
from bench_torch.reference import heat7 as ref

#: lines the buffer grows by (16 MiB of float32 z-lines of 1024)
LINES = 4096


def fields(shape, seed: int, device, n: int = 2) -> list:
    """``n`` standard-normal float32 fields of ``shape``, one after another
    from a generator on ``device`` seeded by the run's seed, in x-slabs (no
    call over 2**30 values)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003) % (1 << 63))
    out = []
    for _ in range(n):
        u = torch.empty(tuple(shape), dtype=torch.float32, device=device)
        step = max(1, (1 << 30) // max(1, u[0].numel()))
        for i in range(0, shape[0], step):
            u[i:i + step].normal_(generator=gen)
        out.append(u)
    return out


class Lines:
    """The z-lines the iterations copy out, in chunks of :data:`LINES`
    rows made ahead of need (a window that outgrows the set-up's chunk
    takes one more)."""

    def __init__(self, length: int, device):
        self.length, self.device = length, device
        self.chunks = [self._chunk()]
        self.n = 0

    def _chunk(self):
        return torch.empty((LINES, self.length), dtype=torch.float32,
                           device=self.device)

    def clear(self):
        self.n = 0

    def put(self, line: torch.Tensor) -> None:
        c, r = divmod(self.n, LINES)
        if c == len(self.chunks):
            self.chunks.append(self._chunk())
        self.chunks[c][r].copy_(line)
        self.n += 1

    def __getitem__(self, i: int) -> torch.Tensor:
        c, r = divmod(i, LINES)
        return self.chunks[c][r]


class Driver:
    def __init__(self, ctx, config, traffic):
        if ctx.world != 1 or tuple(config["pdims"]) != (1, 1):
            raise ValueError("the heat driver runs on one rank")
        if (config["dtype"] != "float32" or not all(config["periods"])
                or tuple(config["halo_extents"]) != (1, 1, 1)):
            raise ValueError("the heat driver steps a periodic float32 box "
                             "with a width-1 halo")
        self.ctx = ctx
        self.limits = config["limits"]
        self.gdims = tuple(config["gdims"])
        self.dt = float(config["dt"])
        self.periods = tuple(bool(p) for p in config["periods"])
        self.warmup = int(traffic["warmup"])
        self.trace_iterations = int(traffic["trace_iterations"])
        self.rng = np.random.default_rng([ctx.seed % (1 << 63), 0])
        self.turn = 0       # the field the next iteration steps

    # -- set-up ---------------------------------------------------------------

    def setup(self):
        import cudecomp_tpu_torch as cd

        self.cd = cd
        self.grid = cd.make_grid(cd.GridConfig(gdims=self.gdims, pdims=(1, 1)),
                                 self.ctx.device)
        want = yardstick.pencil(self.gdims, (1, 1), 0, False, 0)[1]
        if tuple(self.grid.buffer_shape(0)) != want:
            raise ValueError(f"the program's X-pencil is "
                             f"{tuple(self.grid.buffer_shape(0))}, not {want}")
        self.u = fields(self.gdims, self.ctx.seed, self.ctx.device)
        self.lines = Lines(self.gdims[2], self.ctx.device)
        self.begin_window()
        for _ in range(self.warmup):
            self.iteration()
        self.begin_window()

    def begin_window(self):
        self.rows = []      # per iteration: its field and the line's (x, y)
        self.lines.clear()
        self.last = None

    def _step(self, u):
        if self.ctx.impl == "control":
            return ref.control_step(u, self.dt)
        return self.cd.diffusion_step(self.grid, u, self.dt, 0, self.periods)

    def iteration(self):
        self.last = None    # the previous output goes before the next is made
        f, self.turn = self.turn, (self.turn + 1) % len(self.u)
        out = self._step(self.u[f])
        a = int(self.rng.integers(self.gdims[0]))
        b = int(self.rng.integers(self.gdims[1]))
        self.lines.put(out[a, b])
        self.rows.append((f, a, b))
        self.last = out

    def work(self):
        return {"steps": 1}     # one step an iteration

    # -- the check ------------------------------------------------------------

    def release(self):
        self.grid = None
        self.cd.clear_plan_caches()

    def check(self):
        out, self.last = self.last, None
        f_last = self.rows[-1][0]
        err2 = ref2 = err_max = ref_max = 0.0
        rows_rel = [math.inf] * len(self.rows)
        for f, u in enumerate(self.u):
            by_a = {}
            for i, (g, a, _) in enumerate(self.rows):
                if g == f:
                    by_a.setdefault(a, []).append(i)
            for x0, x1, v in ref.step_blocks(u, self.dt):
                u64 = u[x0:x1].to(torch.float64)
                d_ref = v - u64
                del v
                if f == f_last:
                    diff = out[x0:x1].to(torch.float64) - u64 - d_ref
                    err2 += float(diff.square().sum())
                    ref2 += float(d_ref.square().sum())
                    err_max = yardstick.worst((err_max,
                                               float(diff.abs().max())))
                    ref_max = max(ref_max, float(d_ref.abs().max()))
                    del diff
                del u64
                for a in range(x0, x1):
                    for i in by_a.get(a, ()):
                        b = self.rows[i][2]
                        want = d_ref[a - x0, b]
                        got = self.lines[i].to(torch.float64) - u[a, b]
                        rows_rel[i] = float(
                            torch.linalg.vector_norm(got - want)
                            / torch.linalg.vector_norm(want))
        lim = self.limits
        checks = {
            "heat_rel_l2": (math.sqrt(err2 / ref2), lim["heat_rel_l2"]),
            "heat_max_rel": (err_max / ref_max, lim["heat_max_rel"]),
            "heat_rows_rel": (yardstick.worst(rows_rel),
                              lim["heat_rows_rel"]),
        }
        bad = [not (r <= lim["heat_rows_rel"]) for r in rows_rel]
        if not (checks["heat_rel_l2"][0] <= lim["heat_rel_l2"]
                and checks["heat_max_rel"][0] <= lim["heat_max_rel"]):
            bad[-1] = True
        return checks, sum(bad)
