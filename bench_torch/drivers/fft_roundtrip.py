"""A closed loop of c2c round trips through ``DistributedFFT.forward`` and
``inverse``, each from the seeded field.

The field is standard-normal complex64 in this rank's X-pencil, made on
the device from the seed.  Every iteration keeps one line of its
spectrum and one of its round trip, at positions drawn from the seed;
the last iteration's spectrum and round trip are kept whole.  The check,
after the window:

* ``spectrum_rel_l2``: the last spectrum against the complex128
  reference (relative L2 over this rank's pencil);
* ``spectrum_rows_rel``: each iteration's line against the same
  reference (the largest relative L2);
* ``roundtrip_max_abs``, ``roundtrip_rows_max_abs``: the largest
  ``|inverse(forward(x)) - x|`` over the last round trip and over every
  iteration's line; the limit is cuDecomp's single-precision gate
  (``benchmark/benchmark.cu:23-27``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bench_torch import yardstick
from bench_torch.reference import fft_c2c as ref

def field(shape, seed: int, rank: int, device) -> torch.Tensor:
    """Standard-normal complex64 of ``shape``, from a generator on
    ``device`` seeded by the run's seed and the rank, in a few slabs (no
    call over 2**31 values)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + rank) % (1 << 63))
    parts = torch.empty(tuple(shape) + (2,), dtype=torch.float32,
                        device=device)
    step = max(1, (1 << 30) // max(1, parts[0].numel()))
    for i in range(0, shape[0], step):
        parts[i:i + step].normal_(generator=gen)
    return torch.view_as_complex(parts)


class Driver:
    def __init__(self, ctx, config, traffic):
        self.ctx = ctx
        self.limits = config["limits"]
        self.gdims = tuple(config["gdims"])
        self.pdims = tuple(config["pdims"])
        self.method = config.get("transpose_method", "all_to_all")
        self.ac = traffic["layout"] == "axis_contiguous"
        self.warmup = int(traffic["warmup"])
        self.trace_iterations = int(traffic["trace_iterations"])
        r = ctx.rank
        self.xo, self.xshape, _ = yardstick.pencil(
            self.gdims, self.pdims, 0, self.ac, r)
        self.zo, self.zshape, _ = yardstick.pencil(
            self.gdims, self.pdims, 2, self.ac, r)
        if self.zo != (0, 1, 2):
            raise ValueError(f"the spectrum's pencil order {self.zo} is not "
                             f"(X, Y, Z); this driver lays out no other")
        if self.pdims[0] != 1:
            raise ValueError("the reference takes (1, P) process grids")
        self.rng = np.random.default_rng([ctx.seed % (1 << 63), r])

    # -- set-up ---------------------------------------------------------------

    def setup(self):
        import cudecomp_tpu_torch as cd

        cfg = cd.GridConfig(
            gdims=self.gdims, pdims=self.pdims,
            transpose_axis_contiguous=(self.ac,) * 3,
            transpose_method=cd.TransposeMethod(self.method))
        self.grid = cd.make_grid(cfg, self.ctx.device)
        for axis, shape in ((0, self.xshape), (2, self.zshape)):
            if tuple(self.grid.buffer_shape(axis)) != shape:
                raise ValueError(
                    f"the program's pencil {axis} is "
                    f"{tuple(self.grid.buffer_shape(axis))}, the yardstick's "
                    f"{shape}")
        self.plan = cd.DistributedFFT(grid=self.grid)
        self.x = field(self.xshape, self.ctx.seed, self.ctx.rank,
                       self.ctx.device)
        self.begin_window()
        for _ in range(self.warmup):
            self.iteration()
        self.begin_window()

    def begin_window(self):
        # per iteration: (a, b, spectrum line, c, d, round-trip line)
        self.rows = []
        self.last = None

    def _round_trip(self):
        if self.ctx.impl == "control":
            w, g = self.ctx.world, self.ctx.group
            spec = ref.control_forward(yardstick.natural(self.x, self.xo),
                                       w, g)
            y_nat = ref.control_inverse(spec, w, g)
            return spec, y_nat.permute(*self.xo).contiguous()
        spec = self.plan.forward(self.x)
        return spec, self.plan.inverse(spec)

    def iteration(self):
        self.last = None
        spec, y = self._round_trip()
        a = int(self.rng.integers(self.zshape[0]))
        b = int(self.rng.integers(self.zshape[1]))
        c = int(self.rng.integers(self.xshape[0]))
        d = int(self.rng.integers(self.xshape[1]))
        self.rows.append((a, b, spec[a, b].clone(), c, d, y[c, d].clone()))
        self.last = (spec, y)

    def work(self):
        return {"fft_points": math.prod(self.gdims)}

    # -- the check ------------------------------------------------------------

    def release(self):
        import cudecomp_tpu_torch as cd

        self.plan = self.grid = None
        cd.clear_plan_caches()

    def check(self):
        spec, y = self.last
        self.last = None
        lim = self.limits
        x = self.x
        rt = yardstick.worst(float((y[i:i + 8] - x[i:i + 8]).abs().max())
                             for i in range(0, x.shape[0], 8))
        del y
        rt_rows = [float((row - x[c, d]).abs().max())
                   for _, _, _, c, d, row in self.rows]

        by_a = {}
        for i, (a, *_rest) in enumerate(self.rows):
            by_a.setdefault(a, []).append(i)
        err2 = ref2 = 0.0
        spec_rows = [math.inf] * len(self.rows)
        x_nat = yardstick.natural(x, self.xo)
        for lo, hi, s in ref.spectrum_chunks(x_nat, self.ctx.world,
                                             self.ctx.group):
            err2 += float((spec[lo:hi].to(torch.complex128) - s)
                          .abs().square().sum())
            ref2 += float(s.abs().square().sum())
            for a in range(lo, hi):
                for i in by_a.get(a, ()):
                    want = s[a - lo, self.rows[i][1]]
                    got = self.rows[i][2].to(torch.complex128)
                    spec_rows[i] = float(torch.linalg.vector_norm(got - want)
                                         / torch.linalg.vector_norm(want))
            del s
        checks = {
            "spectrum_rel_l2": (math.sqrt(err2 / ref2),
                                lim["spectrum_rel_l2"]),
            "spectrum_rows_rel": (yardstick.worst(spec_rows),
                                  lim["spectrum_rows_rel"]),
            "roundtrip_max_abs": (rt, lim["roundtrip_max_abs"]),
            "roundtrip_rows_max_abs": (yardstick.worst(rt_rows),
                                       lim["roundtrip_rows_max_abs"]),
        }
        bad = [not (s <= lim["spectrum_rows_rel"]
                    and r <= lim["roundtrip_rows_max_abs"])
               for s, r in zip(spec_rows, rt_rows)]
        if not (checks["spectrum_rel_l2"][0] <= lim["spectrum_rel_l2"]
                and rt <= lim["roundtrip_max_abs"]):
            bad[-1] = True
        return checks, sum(bad)
