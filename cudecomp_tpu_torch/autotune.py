"""Runtime autotuner — process-grid shape x transpose strategy search
(``cudecomp_tpu.autotune``; the reference's ``src/autotune.cc``).

Every rank runs the same sweep: for each candidate pdims (factor pairs of
the world size, ``_valid_pdims``), transpose method and, optionally,
pencil layout, it builds the grid, times the 4-transpose round trip
X2Y;Y2Z;Z2Y;Y2X with ``performance.time_fn`` (CUDA events on a CUDA
grid, the host clock on a CPU grid) and averages each trial over the
ranks with an ``all_reduce``, so that every rank scores every candidate
alike and picks the same winner (the reference broadcasts rank 0's
choice, ``autotune.cc:731-736``).  The protocol is the reference's:

  * warm-up calls and timed trials per candidate (``autotune.cc:541-626``);
  * the per-op weights of ``AutotuneOptions.transpose_op_weights``
    (``autotune.cc:631-680``);
  * with ``skip_threshold``, one probe (a warm-up call and one trial)
    first, and no full protocol for a candidate whose probe already
    exceeds ``skip_threshold * best`` (``autotune.cc:578-602``);
  * the transpose sweep first, then the halo method on the winning grid,
    or with ``grid_mode='halo'`` the grid chosen by halo updates
    (``src/cudecomp.cc:1200-1211``);
  * grids with empty pencils are not candidates (``autotune.cc:334-373``);
  * a candidate that refuses to run (``config.CannotRun``, raised on every
    rank alike before any exchange: a CUDA tensor over gloo, a halo wider
    than a pencil) or runs out of device memory (the reference's OOM
    skip, ``autotune.cc:437-447``) is recorded as a skipped trial with its
    error.  Any other error, such as a kernel that fails to build or
    launch, stops the sweep: it is never taken for a candidate that
    cannot run, so that another method's win never hides it.

The default candidates are the methods that can run: ``all_to_all`` and
the rings where the default group's backend exchanges the grid's device
(gloo the CPU, NCCL CUDA), ``ring_hier`` only across more than one host,
``pallas_a2a`` and ``HaloMethod.PALLAS`` on a CUDA grid.  A method named
in ``AutotuneOptions.methods`` or by ``CUDECOMP_TPU_AUTOTUNE_TRANSPOSE_
METHODS`` is tried even where it cannot run, and shows as skipped with
its error.  The winner is frozen into the returned grid's config.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cudecomp_tpu_torch import geometry
from cudecomp_tpu_torch import performance as perf
from cudecomp_tpu_torch.config import (AutotuneOptions, CannotRun,
                                       GridConfig, HaloMethod,
                                       TransposeMethod)
from cudecomp_tpu_torch.grid import (GridDescriptor, clear_plan_caches,
                                     resolve_device)
from cudecomp_tpu_torch.parallel.mesh import (build_mesh, check_cards,
                                              world_hosts)
from cudecomp_tpu_torch.utils import env

#: round trips per timed trial (``time_fn``'s ``iters``)
TRIAL_ITERS = 2
METHODS_KNOB = "CUDECOMP_TPU_AUTOTUNE_TRANSPOSE_METHODS"
#: what a candidate raises when it cannot run: it is recorded as skipped
SKIPPED_ON = (CannotRun, torch.cuda.OutOfMemoryError)


@dataclasses.dataclass
class TrialRecord:
    pdims: Tuple[int, int]
    method: str
    times_s: Tuple[float, ...]   # per-trial weighted round-trip seconds
    avg_s: float
    min_s: float
    skipped: bool = False
    error: Optional[str] = None  # why a candidate that raised was skipped


@dataclasses.dataclass
class AutotuneResult:
    grid: GridDescriptor
    best_pdims: Tuple[int, int]
    best_method: TransposeMethod
    best_time_s: float
    trials: List[TrialRecord]
    halo_trials: List[TrialRecord] = dataclasses.field(default_factory=list)
    best_halo_method: Optional[HaloMethod] = None

    def save_json(self, path: str):
        """Write the tuned choice and the trial tables as strict JSON (a
        skipped trial's infinite times as null), for
        :func:`load_tuned_config` (``docs/autotuning.rst:37-38``)."""
        payload = {
            "best_pdims": list(self.best_pdims),
            "best_method": self.best_method.value,
            "best_axis_contiguous": list(
                self.grid.config.transpose_axis_contiguous),
            "best_halo_method": (self.best_halo_method.value
                                 if self.best_halo_method else None),
            "best_time_s": self.best_time_s,
            "trials": [dataclasses.asdict(t) for t in self.trials],
            "halo_trials": [dataclasses.asdict(t) for t in self.halo_trials],
        }

        def _finite(o):
            if isinstance(o, dict):
                return {k: _finite(v) for k, v in o.items()}
            if isinstance(o, (list, tuple)):
                return [_finite(v) for v in o]
            if isinstance(o, float) and not math.isfinite(o):
                return None
            return o

        with open(path, "w") as f:
            json.dump(_finite(payload), f, indent=2, allow_nan=False)

    def report(self) -> str:
        """The trial table (avg s | min s per candidate) and the choice."""
        def status(t):
            if not t.skipped:
                return f"{t.avg_s:.6f} | {t.min_s:.6f}"
            return "SKIPPED" + (f" ({t.error})" if t.error else "")

        lines = ["CUDECOMP_TPU: autotune results (avg s | min s):"]
        for t in self.trials:
            lines.append(f"  pdims={t.pdims} method={t.method:12s} "
                         f"{status(t)}")
        for t in self.halo_trials:
            lines.append(f"  halo  pdims={t.pdims} method={t.method:12s} "
                         f"{status(t)}")
        ac = self.grid.config.transpose_axis_contiguous
        lines.append(
            f"  -> selected pdims={self.best_pdims} "
            f"method={self.best_method.value} ac={int(ac[0])} "
            f"({self.best_time_s:.6f} s)")
        return "\n".join(lines)


def load_tuned_config(path: str, base_config: GridConfig) -> GridConfig:
    """Apply a saved autotune result (either package's) to a config."""
    with open(path) as f:
        payload = json.load(f)
    cfg = base_config.with_pdims(payload["best_pdims"])
    cfg = dataclasses.replace(
        cfg, transpose_method=TransposeMethod(payload["best_method"]))
    if payload.get("best_axis_contiguous") is not None:
        cfg = dataclasses.replace(
            cfg, transpose_axis_contiguous=tuple(
                payload["best_axis_contiguous"]))
    if payload.get("best_halo_method"):
        cfg = dataclasses.replace(
            cfg, halo_method=HaloMethod(payload["best_halo_method"]))
    return cfg


def _valid_pdims(cfg: GridConfig, nranks: int,
                 options: AutotuneOptions) -> List[Tuple[int, int]]:
    """Factor pairs of ``nranks`` within the P_ROW/P_COL ranges whose
    pencils are all non-empty (and even, unless uneven ones are allowed)."""
    pr_range = options.pr_range or env.int_range(
        "CUDECOMP_TPU_AUTOTUNE_P_ROW_RANGE")
    pc_range = options.pc_range or env.int_range(
        "CUDECOMP_TPU_AUTOTUNE_P_COL_RANGE")
    out = []
    for pr, pc in geometry.pdim_candidates(nranks):
        if pr_range and not (pr_range[0] <= pr <= pr_range[1]):
            continue
        if pc_range and not (pc_range[0] <= pc <= pc_range[1]):
            continue
        trial = cfg.with_pdims((pr, pc))
        ok = True
        for axis in range(3):
            a, b = geometry.pencil_shard_dims(axis)
            for dim, P in ((a, pr), (b, pc)):
                splits = geometry._dist_splits(trial, dim, P)
                if min(splits) == 0 or (
                        not options.allow_uneven_decompositions
                        and len(set(splits)) > 1):
                    ok = False
                    break
            if not ok:
                break
        if ok:
            out.append((pr, pc))
    return out


def _world() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _allreduce_trials(times: List[float]) -> List[float]:
    """The mean of each trial time over the ranks (``autotune.cc:167-188``):
    an ``all_reduce`` of a CPU tensor on gloo, a CUDA tensor on NCCL, so
    that every rank scores every candidate alike."""
    world = _world()
    if world == 1:
        return list(times)
    device = ("cpu" if "gloo" in str(dist.get_backend())
              else torch.device("cuda", torch.cuda.current_device()))
    t = torch.tensor(times, dtype=torch.float64, device=device)
    dist.all_reduce(t)
    return [float(v) / world for v in t.cpu()]


def _time_roundtrip(grid: GridDescriptor, dtype, weights, n_warmup: int,
                    n_trials: int, skip_after_first_above: Optional[float],
                    iters: int = TRIAL_ITERS, n_components: int = 0,
                    op_kwargs=None) -> Tuple[List[float], bool]:
    """Weighted round-trip seconds per trial, and whether the candidate
    was skipped by its probe.

    Uniform weights time the chained round trip (the reference's
    ``at_results`` round trip, ``autotune.cc:546-626``).  Weights uniform
    within each production-adjacent pair (w0 == w1, w2 == w3) time the
    pairs X2Y;Y2Z and Z2Y;Y2X, scored (w0+w1)/2 and (w2+w3)/2 (exact, as
    w*(t0+t1) == w*t0 + w*t1).  Other weights time each op of nonzero
    weight on its own input and score ``sum(w_i * t_i)``
    (``autotune.cc:631-680``); an op of weight 0 never runs.

    With a skip threshold, one probe (one warm-up call and one trial of
    each timed part) runs first; a candidate whose probe exceeds the
    threshold runs nothing more.  A skipped candidate can never win, so a
    threshold tight enough to clip timing noise can drop the true winner
    (as in the reference; use skip_threshold >= ~2).

    ``n_components`` appends trailing dims of size 2; ``op_kwargs`` gives
    each op's halo and padding payload (validated to chain upstream, so
    that each op's input payload is what the chained cycle feeds it)."""
    from cudecomp_tpu_torch.ops import transpose as tr

    op_kwargs = op_kwargs or ({}, {}, {}, {})
    m = grid.config.transpose_method
    ops = (tr.transpose_x_to_y, tr.transpose_y_to_z, tr.transpose_z_to_y,
           tr.transpose_y_to_x)
    in_axes = (0, 1, 2, 1)  # input pencil of X2Y, Y2Z, Z2Y, Y2X

    def chain(ks):
        def run(a):
            for k in ks:
                a = ops[k](grid, a, method=m, **op_kwargs[k])
            return a
        return run

    if len(set(weights)) == 1:
        parts = [(weights[0], (0, 1, 2, 3))]
    elif weights[0] == weights[1] and weights[2] == weights[3]:
        parts = [((weights[0] + weights[1]) / 2.0, (0, 1)),
                 ((weights[2] + weights[3]) / 2.0, (2, 3))]
    else:
        parts = [(weights[k], (k,)) for k in range(4) if weights[k] != 0]

    timers = []
    for w, ks in parts:
        kw = op_kwargs[ks[0]]
        shape = (grid.buffer_shape(in_axes[ks[0]],
                                   kw.get("input_halo_extents", (0, 0, 0)),
                                   kw.get("input_padding", (0, 0, 0)))
                 + (2,) * n_components)
        x = torch.zeros(shape, dtype=dtype, device=grid.device)
        timers.append((w, chain(ks), x))

    def run(n_warm, n):
        return [perf.time_fn(fn, x, n_warmup=n_warm, n_trials=n, iters=iters,
                             device=grid.device) for _, fn, x in timers]

    warm_done = 0
    if skip_after_first_above is not None:
        probes = [_allreduce_trials(t)[0] for t in run(1, 1)]
        score = sum(w * p for (w, _, _), p in zip(timers, probes))
        if score > skip_after_first_above:
            return [score], True
        warm_done = 2  # the probe's warm-up call and trial warmed it
    t_parts = run(max(n_warmup - warm_done, 0), n_trials)
    times = [sum(w * t[i] for (w, _, _), t in zip(timers, t_parts))
             for i in range(n_trials)]
    return _allreduce_trials(times), False


def _time_halo(grid: GridDescriptor, dtype, options: AutotuneOptions,
               n_warmup: int, n_trials: int, iters: int = TRIAL_ITERS,
               n_components: int = 0) -> List[float]:
    """Seconds per ``update_halos`` of the options' halo payload, per
    trial, averaged over the ranks."""
    from cudecomp_tpu_torch.ops.halo import update_halos

    he, pad, axis = options.halo_extents, options.halo_padding, \
        options.halo_axis
    x = torch.zeros(grid.buffer_shape(axis, he, pad) + (2,) * n_components,
                    dtype=dtype, device=grid.device)
    return _allreduce_trials(perf.time_fn(
        lambda a: update_halos(grid, a, axis, he, options.halo_periods,
                               padding=pad),
        x, n_warmup=n_warmup, n_trials=n_trials, iters=iters,
        device=grid.device))


def _backend_carries(device: torch.device) -> bool:
    """Whether the default group's backend exchanges ``device``'s tensors
    (gloo and MPI the CPU's, NCCL CUDA's); True in a world of one rank,
    where nothing is exchanged."""
    if _world() == 1:
        return True
    backend = str(dist.get_backend())
    if device.type == "cuda":
        return "nccl" in backend
    return "gloo" in backend or "mpi" in backend


def _halo_method_candidates(options: AutotuneOptions, device: torch.device):
    if options.halo_methods:
        return list(options.halo_methods)
    out = []
    if _backend_carries(device):
        out.append(HaloMethod.PPERMUTE)
    if device.type == "cuda":
        out.append(HaloMethod.PALLAS)
    return out


def _transpose_method_candidates(options: AutotuneOptions,
                                 device: torch.device, hosts):
    """``options.methods``; else the methods the knob names (all of them,
    runnable or not); else the runnable defaults, less the knob's
    exclusions."""
    if options.methods:
        return list(options.methods)
    defaults = []
    if _backend_carries(device):
        defaults += [TransposeMethod.ALL_TO_ALL, TransposeMethod.RING,
                     TransposeMethod.RING_XOR, TransposeMethod.RING_PIPELINED]
        if len(set(hosts)) > 1:
            # the two-tier schedule differs from RING only across hosts
            defaults.append(TransposeMethod.RING_HIER)
    if device.type == "cuda":
        defaults.append(TransposeMethod.PALLAS_A2A)
    includes, _ = env.candidate_spec(METHODS_KNOB)
    pool = tuple(TransposeMethod) if includes else tuple(defaults)
    return env.filter_candidates(METHODS_KNOB, pool)


def _trial_op_kwargs(options: AutotuneOptions):
    """Per-op transpose trial payload kwargs (the halo and padding
    arguments the application will use, ``cudecomp.h:195-208``).

    The trial runs the 4 ops as the chained cycle X2Y;Y2Z;Z2Y;Y2X, so op
    k's output payload must equal op k+1's input payload and the cycle
    must close: checked here, with a clear error, rather than failing
    every candidate."""
    out = [{}, {}, {}, {}]
    for name, val in (
            ("input_halo_extents", options.transpose_input_halo_extents),
            ("output_halo_extents", options.transpose_output_halo_extents),
            ("input_padding", options.transpose_input_padding),
            ("output_padding", options.transpose_output_padding)):
        if val is not None:
            for i in range(4):
                out[i][name] = val[i]
    zero = (0, 0, 0)
    for kind in ("halo_extents", "padding"):
        for k in range(4):
            o = out[k].get(f"output_{kind}", zero)
            i = out[(k + 1) % 4].get(f"input_{kind}", zero)
            if tuple(o) != tuple(i):
                raise ValueError(
                    f"autotune trial payloads do not chain: op {k}'s "
                    f"output_{kind} {tuple(o)} != op {(k + 1) % 4}'s "
                    f"input_{kind} {tuple(i)} (the trial cycle "
                    f"X2Y;Y2Z;Z2Y;Y2X feeds each op's output to the next "
                    f"op's input and wraps around)")
    return tuple(out)


def _skipped(pdims, tag: str, error: Optional[Exception] = None):
    return TrialRecord(pdims, tag, (), float("inf"), float("inf"),
                       skipped=True,
                       error=None if error is None else repr(error))


def autotune(config: GridConfig, device="cuda",
             options: Optional[AutotuneOptions] = None,
             axis_names: Tuple[str, str] = ("pr", "pc"),
             dtype=None) -> AutotuneResult:
    """Search (pdims x transpose method [x layout]), then the halo method,
    and return the grid with the winning configuration frozen in.

    Collective: every rank of the default process group calls it, with
    the same arguments; the candidates' grids span the whole group.  With
    ``options.grid_mode == "halo"`` the process grid (and halo method) is
    chosen by timing halo updates on ``halo_axis`` pencils, then the
    transpose method is tuned on that grid."""
    options = options or AutotuneOptions()
    device = resolve_device(device)
    nranks = _world()
    if dtype is None:
        dtype = options.dtype if options.dtype is not None else torch.float32
    dtype = perf.as_torch_dtype(dtype)
    n_comp = options.n_components

    if config.autotune_pdims:
        pdims_cands = _valid_pdims(config, nranks, options)
        if not pdims_cands:
            raise ValueError(f"no valid process-grid factorization of "
                             f"{nranks} ranks for gdims {config.gdims}")
    else:
        pdims_cands = [config.pdims]

    hosts = world_hosts()
    if nranks > 1:
        check_cards(device)
    meshes = {}

    def grid_for(cfg):
        if cfg.pdims not in meshes:
            meshes[cfg.pdims] = (None if cfg.pdims == (1, 1) else build_mesh(
                cfg.pdims, device.type, cfg.rank_order, axis_names))
        return GridDescriptor(config=cfg, device=device,
                              mesh=meshes[cfg.pdims], axis_names=axis_names,
                              hosts=hosts)

    # grid_mode == "halo": the process grid (and halo method) by halo
    # timings first (autotuneHaloBackend with the grid sweep,
    # src/autotune.cc:771-1124)
    halo_first_trials: List[TrialRecord] = []
    halo_first_best = None  # (time, pdims, halo_method)
    if options.grid_mode == "halo":
        if not any(options.halo_extents):
            raise ValueError(
                "grid_mode='halo' requires nonzero AutotuneOptions."
                "halo_extents (the reference rejects this too)")
        # without autotune_halo_method the grid is still chosen by halo
        # timings, with the configured halo method only
        halo_cands = (_halo_method_candidates(options, device)
                      if options.autotune_halo_method
                      else [config.halo_method])
        for pdims in pdims_cands:
            for hm in halo_cands:
                cfg = dataclasses.replace(config.with_pdims(pdims),
                                          halo_method=hm)
                try:
                    times = _time_halo(grid_for(cfg), dtype, options,
                                       options.n_warmup, options.n_trials,
                                       n_components=n_comp)
                except SKIPPED_ON as e:
                    halo_first_trials.append(_skipped(pdims, hm.value, e))
                    continue
                avg = float(np.mean(times))
                halo_first_trials.append(TrialRecord(
                    pdims, hm.value, tuple(times), avg,
                    float(np.min(times))))
                if halo_first_best is None or avg < halo_first_best[0]:
                    halo_first_best = (avg, pdims, hm)
        if halo_first_best is None:
            raise RuntimeError("autotuning failed: every halo-mode grid "
                               "candidate was skipped")
        pdims_cands = [halo_first_best[1]]

    if options.autotune_transpose_method:
        methods = _transpose_method_candidates(options, device, hosts)
    else:
        methods = [config.transpose_method]

    # the layout axis: natural and axis-contiguous pencils; an explicit
    # transpose_mem_order is left as it is
    if options.autotune_layouts and config.transpose_mem_order is None:
        layouts = [(False,) * 3, (True,) * 3]
    else:
        layouts = [config.transpose_axis_contiguous]

    weights = options.transpose_op_weights
    # validated once, before the sweep, so that no candidate has run when
    # a bad payload raises
    trial_kwargs = _trial_op_kwargs(options)
    trials: List[TrialRecord] = []
    best = None  # (time, pdims, method, grid)
    first_error: Optional[Exception] = None

    for pdims in pdims_cands:
        for method in methods:
            for layout in layouts:
                cfg = dataclasses.replace(config.with_pdims(pdims),
                                          transpose_method=method,
                                          transpose_axis_contiguous=layout)
                threshold = None
                if options.skip_threshold > 0 and best is not None:
                    threshold = options.skip_threshold * best[0]
                tag = (method.value if len(layouts) == 1 else
                       f"{method.value}/ac={int(layout[0])}")
                try:
                    grid = grid_for(cfg)
                    times, skipped = _time_roundtrip(
                        grid, dtype, weights, options.n_warmup,
                        options.n_trials, threshold, n_components=n_comp,
                        op_kwargs=trial_kwargs)
                except SKIPPED_ON as e:
                    if first_error is None:
                        first_error = e
                    trials.append(_skipped(pdims, tag, e))
                    continue
                avg = float(np.mean(times))
                trials.append(TrialRecord(pdims, tag, tuple(times), avg,
                                          float(np.min(times)),
                                          skipped=skipped))
                if not skipped and (best is None or avg < best[0]):
                    best = (avg, pdims, method, grid)

    if best is None:
        raise RuntimeError(
            "autotuning failed: every candidate was skipped"
            + (f"; first failure: {first_error!r}" if first_error else "")
        ) from first_error

    best_time, best_pdims, best_method, best_grid = best

    halo_trials: List[TrialRecord] = []
    best_halo = None
    if options.grid_mode == "halo":
        # the first phase chose the halo method with the grid
        best_halo = halo_first_best[2]
        halo_trials = halo_first_trials
        best_grid = dataclasses.replace(
            best_grid, config=dataclasses.replace(best_grid.config,
                                                  halo_method=best_halo))
    elif options.autotune_halo_method and any(options.halo_extents):
        hbest = None
        for hm in _halo_method_candidates(options, device):
            grid = dataclasses.replace(
                best_grid, config=dataclasses.replace(best_grid.config,
                                                      halo_method=hm))
            try:
                times = _time_halo(grid, dtype, options, options.n_warmup,
                                   options.n_trials, n_components=n_comp)
            except SKIPPED_ON as e:
                halo_trials.append(_skipped(best_pdims, hm.value, e))
                continue
            avg = float(np.mean(times))
            halo_trials.append(TrialRecord(best_pdims, hm.value,
                                           tuple(times), avg,
                                           float(np.min(times))))
            if hbest is None or avg < hbest[0]:
                hbest = (avg, hm, grid)
        if hbest is not None:
            best_halo, best_grid = hbest[1], hbest[2]

    # drop the candidates' cached plans (the reference clears its graph
    # cache between configs, autotune.cc:629); the winner rebuilds its own
    clear_plan_caches()

    return AutotuneResult(grid=best_grid, best_pdims=best_pdims,
                          best_method=best_method, best_time_s=best_time,
                          trials=trials, halo_trials=halo_trials,
                          best_halo_method=best_halo)
