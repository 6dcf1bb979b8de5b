"""Performance report and timing (``cudecomp_tpu.performance``).

The reference records CUDA event pairs around each operation into
per-configuration sample buffers and prints aggregated tables and CSV
exports (``src/performance.cc``, ``include/internal/performance.h:32-133``,
``common.h:212-244``).  Here:

  * :class:`PerfRegistry` (the process-wide :data:`REGISTRY`) keeps one
    :class:`OpSamples` buffer per op configuration: the keys, rows,
    report and CSV files are the JAX package's, so the two packages'
    reports of the same samples are the same text.  Each public transpose
    and ``update_halos`` records one sample through :func:`maybe_record`
    while the report is on (``CUDECOMP_TPU_ENABLE_PERFORMANCE_REPORT=1``
    or :func:`perf_report_enable`); while it is off nothing is timed or
    synchronised.
  * :func:`time_fn` is the timing protocol shared by the autotuner, the
    benchmark and :func:`segment_roundtrip`: warm-up calls, then trials
    of ``iters`` calls each.  Its clock is the device's: CUDA events for a
    CUDA device, ``time.perf_counter`` for the CPU, where a call returns
    when its work is done.
  * :func:`segment_roundtrip` splits the 4-transpose round trip into
    exchange and local time; :func:`profile_trace` captures a
    ``torch.profiler`` trace, and :func:`device_op_times` and
    :func:`device_op_attribution` read the device time out of it, charged
    to the library's trace ranges, with the exchanges' ranges as the
    communication share.

Not ported: the JAX package's ``ScannedTimer``, ``time_scanned``,
``time_scanned_shapechange`` and ``completion_scalar``, which stop XLA from
folding a timed program and amortise TPU dispatch inside one compiled
scan.  Eager PyTorch folds nothing, and ``time_fn(..., iters=)`` runs the
calls back to back; that is their counterpart here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import json
import os
import tempfile
import time
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cudecomp_tpu_torch.utils import env
from cudecomp_tpu_torch.utils.tracing import EXCHANGE_PREFIX, PREFIX

_N_WARMUP_DISCARD = env.perf_n_warmup()
_MAX_SAMPLES = env.perf_max_samples()


def dtype_name(dtype) -> str:
    """``float32`` for ``torch.float32``: the dtype as the JAX package's
    keys spell it."""
    return str(dtype).replace("torch.", "")


def as_torch_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` from a torch dtype, its name, or a numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        out = getattr(torch, dtype.replace("torch.", ""), None)
        if isinstance(out, torch.dtype):
            return out
        raise ValueError(f"unknown dtype {dtype!r}")
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


@dataclasses.dataclass
class OpSamples:
    """Circular sample buffer per op configuration (``common.h:212-244``)."""
    key: Tuple
    times_ms: List[float] = dataclasses.field(default_factory=list)
    bytes_moved: int = 0  # per-invocation exchange bytes (for the rate)
    n_discarded: int = 0

    def add(self, ms: float):
        if self.n_discarded < _N_WARMUP_DISCARD:
            self.n_discarded += 1
            return
        if len(self.times_ms) >= _MAX_SAMPLES:
            self.times_ms.pop(0)
        self.times_ms.append(ms)


class PerfRegistry:
    def __init__(self):
        self.enabled = env.perf_report_enabled()
        self.samples: Dict[Tuple, OpSamples] = {}
        self.trace_attribution: Optional[Dict] = None

    def record(self, key: Tuple, ms: float, bytes_moved: int = 0):
        s = self.samples.get(key)
        if s is None:
            s = self.samples[key] = OpSamples(key=key, bytes_moved=bytes_moved)
        s.add(ms)

    def attach_trace(self, log_dir: str) -> Dict:
        """Join a :func:`profile_trace` capture: the next :meth:`report`
        prints the device time by trace range and the comm/local split
        beside the samples (``src/performance.cc:391-450``)."""
        self.trace_attribution = device_op_attribution(log_dir)
        return self.trace_attribution

    def clear(self):
        self.samples.clear()
        self.trace_attribution = None

    # -- reporting ---------------------------------------------------------------

    def rows(self, cross_host: bool = False):
        """Aggregated per-config stats.  With ``cross_host=True`` in a
        process group of more than one rank the stats are reduced over the
        ranks (mean of means and of stds, min of mins, max of maxes, the
        sum of the counts), like the reference's cross-rank reductions
        (``performance.cc:391-450``).  That is collective: every rank must
        call with the same keys, so it is opt-in."""
        out = []
        multi = (cross_host and dist.is_available() and dist.is_initialized()
                 and dist.get_world_size() > 1)
        for key, s in sorted(self.samples.items(), key=lambda kv: str(kv[0])):
            if not s.times_ms and not multi:
                continue
            if s.times_ms:
                t = np.array(s.times_ms)
                avg, mn, mx, std = (float(t.mean()), float(t.min()),
                                    float(t.max()), float(t.std()))
            else:
                # warmup-only on this rank: it still joins the gather (a
                # missing rank would hang the others); NaNs are ignored
                t = np.array([])
                avg = mn = mx = std = float("nan")
            count = len(t)
            if multi:
                g = [None] * dist.get_world_size()
                dist.all_gather_object(g, [avg, mn, mx, std, float(count)])
                g = np.asarray(g, dtype=np.float64).reshape(-1, 5)
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")  # all-NaN slices
                    avg, mn, mx, std = (float(np.nanmean(g[:, 0])),
                                        float(np.nanmin(g[:, 1])),
                                        float(np.nanmax(g[:, 2])),
                                        float(np.nanmean(g[:, 3])))
                count = int(g[:, 4].sum())
                if np.isnan(avg):
                    continue  # no rank has samples past the warm-up
            row = {
                "config": "/".join(str(k) for k in key),
                "count": count,
                "avg_ms": avg,
                "min_ms": mn,
                "max_ms": mx,
                "std_ms": std,
            }
            if s.bytes_moved:
                row["a2a_gbps"] = s.bytes_moved / (avg / 1e3) / 1e9
            out.append(row)
        return out

    def report(self, detail: Optional[int] = None,
               cross_host: bool = False) -> str:
        """Aggregated table; ``detail >= 1`` appends each config's samples
        (``performance.cc:480-700``); default ``CUDECOMP_TPU_PERF_DETAIL``.
        ``cross_host=True`` reduces over the ranks (collective).  With
        ``CUDECOMP_TPU_PERF_WRITE_DIR`` set the CSVs are written there."""
        if detail is None:
            detail = env.perf_detail()
        lines = ["CUDECOMP_TPU: performance report",
                 f"{'config':60s} {'count':>6s} {'avg ms':>10s} {'min ms':>10s} "
                 f"{'max ms':>10s} {'std':>8s} {'A2A GB/s':>10s}"]
        for r in self.rows(cross_host=cross_host):
            bw = f"{r.get('a2a_gbps', 0):.1f}" if "a2a_gbps" in r else "-"
            lines.append(
                f"{r['config']:60s} {r['count']:6d} {r['avg_ms']:10.4f} "
                f"{r['min_ms']:10.4f} {r['max_ms']:10.4f} {r['std_ms']:8.4f} "
                f"{bw:>10s}")
        if detail >= 1:
            for key, s in sorted(self.samples.items(),
                                 key=lambda kv: str(kv[0])):
                if not s.times_ms:
                    continue
                lines.append(f"  samples {'/'.join(str(k) for k in key)}:")
                for i, t in enumerate(s.times_ms):
                    lines.append(f"    {i:4d} {t:10.4f} ms")
        if self.trace_attribution:
            a = self.trace_attribution
            pct = 100.0 * a["comm_ms"] / a["total_ms"] if a["total_ms"] else 0
            lines.append(
                f"  device-time attribution (profiler trace): total "
                f"{a['total_ms']:.3f} ms = comm {a['comm_ms']:.3f} ms "
                f"({pct:.1f}%) + local {a['local_ms']:.3f} ms")
            top = sorted(a["ranges"].items(), key=lambda kv: -kv[1])[:10]
            for name, ms in top:
                kind = "comm" if name.startswith(EXCHANGE_PREFIX) else "local"
                lines.append(f"    {name:54s} {kind:5s} {ms:10.4f} ms")
        write_dir = env.perf_write_dir()
        if write_dir:
            paths = self.write_csv(write_dir)
            lines.append(f"  wrote {len(paths)} CSV file(s) to {write_dir}")
        return "\n".join(lines)

    def write_csv(self, directory: str = ".",
                  prefix: str = "cudecomp_tpu_perf"):
        """Per-config CSV export with config-encoding file names."""
        paths = []
        os.makedirs(directory, exist_ok=True)
        for key, s in self.samples.items():
            if not s.times_ms:
                continue
            tag = "_".join(str(k).replace(" ", "").replace("/", "-")
                           for k in key)
            path = os.path.join(directory, f"{prefix}.{tag}.csv")
            with open(path, "w") as f:
                f.write("sample,time_ms\n")
                for i, t in enumerate(s.times_ms):
                    f.write(f"{i},{t}\n")
            paths.append(path)
        return paths


REGISTRY = PerfRegistry()


def perf_report_enable(enable: bool = True):
    REGISTRY.enabled = enable


def maybe_record(key_fn: Callable, run_fn: Callable, arr: torch.Tensor):
    """Run ``run_fn(arr)``; while the report is on, record its time under
    ``key_fn()``'s key: CUDA events on ``arr``'s stream for a CUDA tensor
    (waiting for the end event), the host clock for a CPU tensor.  While
    it is off, or under ``torch.compile``, only run it."""
    if not REGISTRY.enabled or torch.compiler.is_compiling():
        return run_fn(arr)
    if arr.device.type == "cuda":
        stream = torch.cuda.current_stream(arr.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        out = run_fn(arr)
        end.record(stream)
        end.synchronize()
        ms = start.elapsed_time(end)
    else:
        t0 = time.perf_counter()
        out = run_fn(arr)
        ms = (time.perf_counter() - t0) * 1e3
    key, nbytes = key_fn()
    REGISTRY.record(key, ms, nbytes)
    return out


# -- the timing protocol ---------------------------------------------------------

def _timing_device(device, args) -> torch.device:
    if device is not None:
        return torch.device(device)
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cuda")


def time_fn(fn: Callable, *args, n_warmup: int = 3, n_trials: int = 5,
            iters: int = 1, device=None) -> List[float]:
    """Seconds per call of ``fn(*args)`` for each of ``n_trials`` trials
    (``src/autotune.cc:541-626``), after ``n_warmup`` untimed calls; a
    trial times ``iters`` calls back to back.

    The clock is that of ``device``: by default the device of the first
    tensor in ``args``, else CUDA.  On a CUDA device a trial records an
    event, makes its calls on the current stream, records a second event
    and waits for it (a CUDA device without CUDA raises); on the CPU it
    reads ``time.perf_counter`` around its calls.  The performance report
    records none of the timed calls."""
    device = _timing_device(device, args)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("time_fn on a CUDA device needs CUDA")
    # the timed calls record no per-op samples (each would wait for its
    # end event): in JAX they run inside one compiled program
    enabled, REGISTRY.enabled = REGISTRY.enabled, False
    try:
        return _time_calls(fn, args, n_warmup, n_trials, iters, device)
    finally:
        REGISTRY.enabled = enabled


def _time_calls(fn, args, n_warmup, n_trials, iters, device):
    if device.type == "cuda":
        with torch.cuda.device(device):
            for _ in range(n_warmup):
                fn(*args)
            torch.cuda.synchronize()
            times = []
            for _ in range(n_trials):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    fn(*args)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3 / iters)
        return times
    for _ in range(n_warmup):
        fn(*args)
    times = []
    for _ in range(n_trials):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        times.append((time.perf_counter() - t0) / iters)
    return times


_CYCLE = ((0, +1), (1, +1), (2, -1), (1, -1))  # X2Y, Y2Z, Z2Y, Y2X


def _time_exchanges(grid, dtype, method_key: str, *, iters, n_warmup,
                    n_trials) -> float:
    """Seconds of the round trip's exchanges alone: each exchange with
    P > 1 timed on its own, on blocks of exactly the shapes the engine
    exchanges (pad-to-max chunks); the min over trials, summed.  The
    pipelined transpose's steps are the ring's."""
    from cudecomp_tpu_torch import geometry
    from cudecomp_tpu_torch.parallel.collectives import exchange_for

    cfg = grid.config
    total = 0.0
    for ax, dir_ in _CYCLE:
        comm_pd = geometry.shard_pdim_of_dim(ax + dir_, ax)
        P = cfg.pdims[comm_pd]
        if P == 1:
            continue
        name = grid.axis_names[comm_pd]
        group = grid.group(name)
        ms_in = geometry.max_splits(cfg, ax)
        Bs = geometry.max_splits(cfg, ax + dir_)[ax]
        other = [ms_in[d] for d in range(3) if d != ax]
        exchange = exchange_for(method_key, grid, name)
        blocks = torch.zeros((P * Bs, other[0], other[1]), dtype=dtype,
                             device=grid.device)
        total += min(time_fn(
            lambda b: exchange(b, group, P, Bs), blocks,
            n_warmup=n_warmup, n_trials=n_trials, iters=iters,
            device=grid.device))
    return total


def segment_roundtrip(grid, dtype=torch.float32, *, method=None,
                      iters: int = 2, n_warmup: int = 2, n_trials: int = 5,
                      record: bool = True) -> Dict[str, float]:
    """Split the 4-op transpose round trip into exchange and local time
    (the reference's per-step event pairs, ``performance.cc:391,450``).

    ``total_ms`` is the chained round trip X2Y;Y2Z;Z2Y;Y2X, the min over
    trials of :func:`time_fn`; ``a2a_ms`` the exchanges alone, timed on
    blocks of the exchanged shapes (0 at pdims (1, 1)), at most the total;
    ``local_ms`` the rest; ``a2a_gbps`` the bytes that leave this rank
    over the round trip per second of exchange.  Collective at P > 1."""
    from cudecomp_tpu_torch import geometry
    from cudecomp_tpu_torch.ops import transpose as tr

    cfg = grid.config
    dtype = as_torch_dtype(dtype)
    m = method.value if hasattr(method, "value") else (
        method or cfg.transpose_method.value)

    def roundtrip(a):
        b = tr.transpose_x_to_y(grid, a, method=m)
        b = tr.transpose_y_to_z(grid, b, method=m)
        b = tr.transpose_z_to_y(grid, b, method=m)
        return tr.transpose_y_to_x(grid, b, method=m)

    x = torch.zeros(grid.buffer_shape(0), dtype=dtype, device=grid.device)
    total = min(time_fn(roundtrip, x, n_warmup=n_warmup, n_trials=n_trials,
                        iters=iters, device=grid.device))
    a2a = 0.0
    if cfg.pdims != (1, 1):
        a2a = min(_time_exchanges(grid, dtype, m, iters=iters,
                                  n_warmup=n_warmup, n_trials=n_trials),
                  total)
    local = max(total - a2a, 0.0)

    nbytes = 0
    for ax, dir_ in _CYCLE:
        P = cfg.pdims[geometry.shard_pdim_of_dim(ax + dir_, ax)]
        ms_in = geometry.max_splits(cfg, ax)
        elems = ms_in[0] * ms_in[1] * ms_in[2]
        nbytes += int(elems * dtype.itemsize * (P - 1) / max(P, 1))
    gbps = nbytes / a2a / 1e9 if a2a > 0 else 0.0

    out = {"total_ms": total * 1e3, "a2a_ms": a2a * 1e3,
           "local_ms": local * 1e3, "a2a_gbps": gbps}
    if record and REGISTRY.enabled:
        key = ("transpose_roundtrip_segmented", cfg.gdims, cfg.pdims, m,
               dtype_name(dtype))
        REGISTRY.record(key + ("total",), out["total_ms"], nbytes)
        REGISTRY.record(key + ("a2a",), out["a2a_ms"], nbytes)
        REGISTRY.record(key + ("local",), out["local_ms"])
    return out


# -- profiler traces -------------------------------------------------------------

@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of a region (host ops and, where
    CUDA is available, the card's kernels) and write it to ``log_dir`` as
    a chrome trace (``*.trace.json``; Perfetto opens it): the analog of
    the reference's NVTX and Nsight workflow.  Yields ``log_dir``.

    On the H100 machine measured, sessions early in a process record
    every kernel, but after tens of seconds of launches they lose some or
    all kernel records, whatever the window's length;
    ``device_op_attribution`` counts the launches whose kernel is
    missing."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield log_dir
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"cudecomp_tpu_torch.{os.getpid()}.{time.time_ns()}"
                 f".trace.json"))


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _traces(log_dir: str):
    """The complete ('X') events of each trace file under ``log_dir``."""
    for path in sorted(glob.glob(os.path.join(log_dir, "**", "*.trace.json"),
                                 recursive=True)):
        with open(path) as f:
            data = json.load(f)
        yield [e for e in data.get("traceEvents", [])
               if e.get("ph") == "X" and "dur" in e]


def _device_events(events):
    """The trace's device work (its kernels, copies and fills), and
    whether the trace is of a GPU run: one with device work or launches.
    In a CPU run the host ops are the device's work."""
    dev = [e for e in events if e.get("cat") in _DEVICE_CATS]
    return dev, bool(dev) or any(e.get("cat") in _LAUNCH_CATS
                                 for e in events)


def device_op_times(log_dir: str) -> Dict[str, float]:
    """``{name: ms}`` of device time by op from a :func:`profile_trace`
    capture: the kernels, copies and fills on the card's lanes, or, in a
    trace of a CPU run, every host op and trace range (nested ones each
    count)."""
    out: Dict[str, float] = {}
    for events in _traces(log_dir):
        dev, on_gpu = _device_events(events)
        if not on_gpu:
            dev = [e for e in events
                   if e.get("cat") in ("cpu_op", "user_annotation")]
        for e in dev:
            out[e["name"]] = out.get(e["name"], 0.0) + e["dur"] / 1e3
    return out


def _outermost(ops):
    """The ops no other op of the same thread encloses."""
    out, end = [], {}
    for e in sorted(ops, key=lambda e: (e.get("pid"), e.get("tid"), e["ts"],
                                        -e["dur"])):
        lane = (e.get("pid"), e.get("tid"))
        if e["ts"] >= end.get(lane, float("-inf")):
            out.append(e)
            end[lane] = e["ts"] + e["dur"]
    return out


def _innermost_range(ranges, host):
    """The latest-starting library range of ``host``'s thread that
    encloses ``host``'s start, or None."""
    best = None
    for r in ranges:
        if (r.get("pid"), r.get("tid")) != (host.get("pid"), host.get("tid")):
            continue
        if r["ts"] <= host["ts"] <= r["ts"] + r["dur"] and (
                best is None or r["ts"] > best["ts"]):
            best = r
    return best


def device_op_attribution(log_dir: str) -> Dict:
    """Comm/local split of the device time in a :func:`profile_trace`
    capture (``src/performance.cc:391-450``).

    Each device event (a kernel, copy or fill; in a CPU run each outermost
    host op) is charged to the innermost library trace range open on the
    host thread where it was launched (the kernel's launch call, matched
    by its correlation id).  Time charged to an exchange's range
    (``cudecomp_tpu_torch.exchange.*``), and NCCL's kernels anywhere, is
    communication; the rest is local.

    Returns ``{"ops": {name: ms}, "ranges": {range: ms}, "comm_ms",
    "local_ms", "total_ms", "lost_launches"}``; device time outside every
    library range is charged to ``"(outside the library)"``.
    ``lost_launches`` counts the kernel launches in the trace whose kernel
    is not in it: a trace that lost device records (see
    :func:`profile_trace`) undercounts by them."""
    ops: Dict[str, float] = {}
    ranges: Dict[str, float] = {}
    comm = 0.0
    lost = 0
    for events in _traces(log_dir):
        lib = [e for e in events if e.get("cat") == "user_annotation"
               and e["name"].startswith(PREFIX)]
        dev, on_gpu = _device_events(events)
        if on_gpu:
            launches = {e["args"]["correlation"]: e for e in events
                        if e.get("cat") in _LAUNCH_CATS
                        and "correlation" in e.get("args", {})}
            items = [(e, launches.get(e.get("args", {}).get("correlation")))
                     for e in dev]
            seen = {e.get("args", {}).get("correlation") for e in dev}
            lost += sum(1 for c, e in launches.items()
                        if "Launch" in e["name"] and c not in seen)
        else:
            items = [(e, e) for e in _outermost(
                [e for e in events if e.get("cat") == "cpu_op"])]
        for e, host in items:
            r = _innermost_range(lib, host) if host is not None else None
            rname = r["name"] if r is not None else "(outside the library)"
            ms = e["dur"] / 1e3
            ops[e["name"]] = ops.get(e["name"], 0.0) + ms
            ranges[rname] = ranges.get(rname, 0.0) + ms
            if rname.startswith(EXCHANGE_PREFIX) or (
                    on_gpu and e["name"].lower().startswith("nccl")):
                comm += ms
    total = sum(ops.values())
    return {"ops": ops, "ranges": ranges, "comm_ms": comm,
            "local_ms": total - comm, "total_ms": total,
            "lost_launches": lost}


@contextlib.contextmanager
def attributed_trace(log_dir: Optional[str] = None):
    """Trace a region and attach its device-time attribution to
    :data:`REGISTRY`, so that the next ``REGISTRY.report()`` prints the
    comm/local split beside the samples::

        with perf.attributed_trace():
            roundtrip(x)
        print(perf.REGISTRY.report())
    """
    d = log_dir or tempfile.mkdtemp(prefix="cudecomp_tpu_torch_trace_")
    with profile_trace(d):
        yield d
    REGISTRY.attach_trace(d)
