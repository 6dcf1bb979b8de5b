"""The library's dryrun: one step of the flagship workload, and the whole
multi-rank pipeline on tiny shapes (``__graft_entry__.py``'s ``entry`` and
``dryrun_multichip`` for the JAX package).

``entry(device)`` returns ``(step, args)``: the 64^3 four-transpose round
trip (axis-contiguous, so K1 on a CUDA tensor), a width-1 periodic halo
update, the split-complex c2c forward+inverse, its plane forms and the r2c
plane round trip.  ``dryrun_multichip(n, device)`` spawns ``n`` ranks over
gloo (``file://`` init in a temporary directory): CPU ranks, or ranks that
share ``cuda:0``.  Each runs every transpose method, both halo methods,
the FFTs, ``SpectralOperators``, ``diffusion_step`` and ``halo_map``, an
uneven grid with a mixed ``transpose_mem_order``, a ``ProjectionSolver``
step, a tiny ``autotune`` (and its per-op weighted scorer),
``autotune_fft``, a checkpoint saved on one grid and loaded on another,
and ``finalize``; it returns, per rank, the stages that ran and those
refused with ``CannotRun`` (with their messages).  Only ``CannotRun`` is a
refusal, which on ranks that share a card over gloo is the set that moves
CUDA tensors over gloo (the all-to-all, the rings, ``HaloMethod.PPERMUTE``
and the ghost-plane shifts); any other error propagates.  Every input is
built with numpy and placed on the device asked for: there is no device
fallback.

    python -m cudecomp_tpu_torch.dryrun [--device cpu] [--ranks N]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from cudecomp_tpu_torch.config import (AutotuneOptions, CannotRun,
                                       GridConfig, HaloMethod,
                                       TransposeMethod)

_TRANSPOSES = ("x_to_y", "y_to_z", "z_to_y", "y_to_x")


def entry(device="cuda", seed: Optional[int] = None):
    """``(step, args)`` of the flagship single-rank step on ``device``:
    ``step(x, h, xc)`` returns the four-transpose round trip of ``x``, the
    halo update of a copy of ``h``, the c2c round trip of the split-complex
    ``xc``, the sum of its plane-form round trip and the r2c plane round
    trip of ``x``.  The args are zeros (as in the JAX package) or, with
    ``seed``, standard-normal float32 from numpy."""
    import cudecomp_tpu_torch as ct
    from cudecomp_tpu_torch.ops.fft import DistributedFFT

    cfg = GridConfig(gdims=(64, 64, 64), pdims=(1, 1),
                     transpose_axis_contiguous=(True, True, True))
    grid = ct.make_grid(cfg, device)
    plan = DistributedFFT(grid=grid, split_complex=True)
    rplan = DistributedFFT(grid=grid, real=True, split_complex=True)
    he = (1, 1, 1)

    def step(x, h, xc):
        y = ct.transpose_x_to_y(grid, x)
        z = ct.transpose_y_to_z(grid, y)
        x2 = ct.transpose_y_to_x(grid, ct.transpose_z_to_y(grid, z))
        h2 = ct.update_halos(grid, h.clone(), 0, he, (True, True, True))
        s = plan.inverse(plan.forward(xc))
        pr_, pi_ = plan.inverse_planes(
            plan.forward_planes((xc[..., 0], xc[..., 1])))
        sr = rplan.inverse_planes(rplan.forward_planes(x))
        return x2, h2, s, pr_ + pi_, sr

    rng = np.random.default_rng(seed)

    def arr(shape):
        a = (np.zeros(shape, np.float32) if seed is None
             else rng.standard_normal(shape).astype(np.float32))
        return torch.from_numpy(a).to(grid.device)

    return step, (arr(cfg.gdims), arr(grid.buffer_shape(0, he)),
                  arr(cfg.gdims + (2,)))


class _Report:
    """The stages of one rank: those that ran, and those refused with
    ``CannotRun`` and their messages."""

    def __init__(self):
        self.ran, self.refused = [], {}

    def attempt(self, name, fn):
        try:
            fn()
        except CannotRun as e:
            self.refused[name] = str(e)
        else:
            self.ran.append(name)


def _ok(cond, what):
    if not cond:
        raise RuntimeError(f"dryrun: {what}")


def _pipeline(rank: int, n: int, device, workdir: str) -> dict:
    """The whole pipeline on this rank; returns its report."""
    import cudecomp_tpu_torch as ct
    from cudecomp_tpu_torch.geometry import squarest_pdims
    from cudecomp_tpu_torch.models import ProjectionSolver
    from cudecomp_tpu_torch.ops.fft import DistributedFFT
    from cudecomp_tpu_torch.utils.checkpoint import load_pencil, save_pencil
    from cudecomp_tpu_torch.utils.testing import expected_halo_buffer

    rep = _Report()
    pdims = squarest_pdims(n)
    N = 4 * math.lcm(*pdims)  # tiny but divisible extents
    cfg = GridConfig(gdims=(N, N, N), pdims=pdims,
                     transpose_axis_contiguous=(True, True, True))
    grid = ct.make_grid(cfg, device)
    rng = np.random.default_rng(7)  # the same global fields on every rank
    f = rng.standard_normal(cfg.gdims)
    xg = torch.from_numpy((f + 1j * rng.standard_normal(cfg.gdims))
                          .astype(np.complex64))
    x = ct.scatter_global(grid, xg, 0)
    xr = ct.scatter_global(grid, torch.from_numpy(f.astype(np.float32)), 0)

    def with_methods(g, method=None, halo_method=None):
        c = g.config
        return dataclasses.replace(g, config=dataclasses.replace(
            c, transpose_method=method or c.transpose_method,
            halo_method=halo_method or c.halo_method))

    # every exchange strategy: the four transposes and back, bit for bit
    for m in TransposeMethod:
        def cycle(m=m):
            buf = x
            for name in _TRANSPOSES:
                buf = getattr(ct, f"transpose_{name}")(grid, buf, method=m)
            _ok(torch.equal(buf, x), f"{m.value} round trip")
        rep.attempt(m.value, cycle)
    # both halo methods, against the halo oracle
    he = (1, 1, 1)
    hg = torch.from_numpy(f.astype(np.float32))
    for hm in HaloMethod:
        def halo(hm=hm):
            g = with_methods(grid, halo_method=hm)
            h = ct.scatter_global(g, hg, 0, halo_extents=he)
            ct.update_halos(g, h, 0, he, (True, True, True))
            want = expected_halo_buffer(g, hg, 0, he, (True,) * 3)
            _ok(torch.equal(h.cpu(), want.cpu()), f"halo {hm.value}")
        rep.attempt(f"halo_{hm.value}", halo)

    method = next((m for m in (TransposeMethod.ALL_TO_ALL,
                               TransposeMethod.PALLAS_A2A)
                   if m.value in rep.ran), None)
    hmethod = next((m for m in (HaloMethod.PPERMUTE, HaloMethod.PALLAS)
                    if f"halo_{m.value}" in rep.ran), None)
    _ok(method is not None and hmethod is not None,
        f"no transpose or halo method ran: {rep.refused}")
    wgrid = with_methods(grid, method, hmethod)

    def c2c():
        plan = DistributedFFT(grid=wgrid)
        err = float((plan.inverse(plan.forward(x)) - x).abs().max())
        _ok(err < 1e-4, f"c2c round trip error {err}")
    rep.attempt("fft_c2c", c2c)
    rplan = DistributedFFT(grid=wgrid, real=True, split_complex=True)

    def r2c():
        err = float((rplan.inverse(rplan.forward(xr)) - xr).abs().max())
        _ok(err < 1e-4, f"r2c round trip error {err}")
        err = float((rplan.inverse_planes(rplan.forward_planes(xr))
                     - xr).abs().max())
        _ok(err < 1e-4, f"r2c plane round trip error {err}")
    rep.attempt("fft_r2c", r2c)

    def spectral():
        sops = ct.SpectralOperators(plan=rplan)
        out = rplan.inverse_planes(
            sops.dealias(sops.laplacian(rplan.forward_planes(xr))))
        _ok(bool(torch.isfinite(out).all()), "spectral operators")
    rep.attempt("spectral", spectral)

    def stencil():
        st = ct.diffusion_step(wgrid, xr, 0.1, 0, (True, False, True))
        st = ct.halo_map(wgrid, st, lambda e: e[1:-1, 1:-1, 1:-1], 0, 1)
        _ok(bool(torch.isfinite(st).all()), "stencil path")
    rep.attempt("diffusion_step_halo_map", stencil)

    # the uneven grid with a mixed per-pencil memory order
    gd = (4 * pdims[0] + 1, 4 * pdims[1] + 2, 4 * max(pdims) + 3)
    ucfg = GridConfig(gdims=gd, pdims=pdims, transpose_method=method,
                      halo_method=hmethod,
                      transpose_mem_order=((1, 0, 2), (2, 1, 0), (0, 2, 1)))
    ugrid = ct.make_grid(ucfg, device)
    ug = torch.from_numpy(rng.standard_normal(gd).astype(np.float32))

    def uneven():
        u = ct.scatter_global(ugrid, ug, 0)
        v = u
        for name in _TRANSPOSES:
            v = getattr(ct, f"transpose_{name}")(ugrid, v)
        _ok(torch.equal(v, u), "uneven round trip")
        uh = ct.scatter_global(ugrid, ug, 0, halo_extents=he)
        ct.update_halos(ugrid, uh, 0, he, (True, False, True))
        want = expected_halo_buffer(ugrid, ug, 0, he, (True, False, True))
        _ok(torch.equal(uh.cpu(), want.cpu()), "uneven halo")
    rep.attempt("uneven", uneven)

    def uneven_ring():
        u = ct.scatter_global(ugrid, ug, 0)
        v = ct.transpose_x_to_y(ugrid, u, method=TransposeMethod.RING)
        v = ct.transpose_y_to_x(ugrid, v, method=TransposeMethod.RING)
        _ok(torch.equal(v, u), "uneven ring round trip")
    rep.attempt("uneven_ring", uneven_ring)

    def projection():
        ns = ProjectionSolver(grid=wgrid, nu=0.01, scheme="rk2",
                              split_complex=True)
        uv, nsf = ns.setup_tg(dtype=torch.float32)
        _ok(bool(torch.isfinite(ns.step(uv, nsf, 1e-2)).all()),
            "projection step")
    rep.attempt("projection_step", projection)

    # the autotuner (a sweep, then the per-op weighted scorer), autotune_fft
    methods = tuple(m for m in (TransposeMethod.ALL_TO_ALL,
                                TransposeMethod.RING,
                                TransposeMethod.PALLAS_A2A)
                    if m.value in rep.ran)[:2]
    res = ct.autotune(GridConfig(gdims=(N, N, N), pdims=(0, 0)), device,
                      options=AutotuneOptions(
                          n_warmup=1, n_trials=1, pr_range=(1, pdims[0]),
                          methods=methods))
    ct.autotune(GridConfig(gdims=(N, N, N), pdims=pdims,
                           transpose_method=method), device,
                options=AutotuneOptions(
                    n_warmup=0, n_trials=1, autotune_transpose_method=False,
                    transpose_op_weights=(2.0, 1.0, 1.0, 2.0)))
    rep.ran.append("autotune")
    ct.autotune_fft(res.grid, n_warmup=1, n_trials=1, iters=2)
    rep.ran.append("autotune_fft")

    # a checkpoint saved on one grid, loaded on the tuned one
    src = torch.arange(math.prod(cfg.gdims), dtype=torch.float32).reshape(
        cfg.gdims)
    xs = ct.scatter_global(grid, src, 0)
    ckpt = os.path.join(workdir, "ckpt")
    save_pencil(ckpt, grid, xs, 0)
    xl = load_pencil(ckpt, res.grid, 0)
    # gathered on the host: gloo moves CPU tensors
    _ok(torch.equal(ct.gather_global(res.grid, xl.cpu(), 0), src),
        "checkpoint round trip")
    rep.ran.append("checkpoint")
    ct.finalize()
    rep.ran.append("finalize")
    return {"rank": rank, "device": str(grid.device), "pdims": list(pdims),
            "ran": rep.ran, "refused": rep.refused}


def _rank_body(rank: int, n: int, device: str, workdir: str) -> None:
    """Run the pipeline and write this rank's report into ``workdir``."""
    if device == "cuda":
        device = torch.device("cuda", 0)
    report = _pipeline(rank, n, device, workdir)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as fh:
        json.dump(report, fh)


def dryrun_multichip(n: int, device="cuda", timeout: float = 600.0) -> list:
    """Spawn ``n`` ranks over gloo, run the whole pipeline on each, and
    return their reports (``{"rank", "device", "pdims", "ran",
    "refused"}``), rank by rank.  ``device="cpu"``: CPU ranks; ``"cuda"``:
    ranks that share ``cuda:0`` (``utils.testing.run_card_ranks``)."""
    from cudecomp_tpu_torch.utils.testing import run_card_ranks, run_cpu_ranks

    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip on CUDA needs CUDA")
        from cudecomp_tpu_torch.ops import (cuda_kernels, dft2,
                                            peer_kernels, stencil_kernel)
        for mod in (cuda_kernels, dft2, peer_kernels, stencil_kernel):
            mod.build()  # once, before the ranks start
    elif kind != "cpu":
        raise ValueError(f"dryrun_multichip runs on 'cpu' or 'cuda', got "
                         f"{device!r}")
    with tempfile.TemporaryDirectory(prefix="cudecomp_dryrun_") as d:
        init = os.path.join(d, "pg_init")
        what = f"the {n}-rank dryrun on {kind}"
        if kind == "cuda":
            run_card_ranks(_rank_body, n, init, (n, "cuda", d), timeout,
                           what)
        else:
            run_cpu_ranks(_rank_body, n, init, (n, "cpu", d), timeout,
                          what)
        reports = []
        for r in range(n):
            with open(os.path.join(d, f"rank{r}.json")) as fh:
                reports.append(json.load(fh))
    return reports


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--ranks", type=int, default=4)
    a = p.parse_args(argv)
    step, args = entry(a.device, seed=0)
    outs = step(*args)
    print(f"entry: one step on {a.device}, {len(outs)} outputs, finite: "
          f"{all(bool(torch.isfinite(o).all()) for o in outs)}")
    for rep in dryrun_multichip(a.ranks, a.device):
        print(json.dumps(rep))


if __name__ == "__main__":
    main()
