"""One run of one cell on one rank: set-up, the traced window (with
``--trace 1``), the measured window, the peak, the check.

The window is a closed loop: each iteration is enqueued after the one
before it, and the host runs at most two iterations ahead of the device
(it waits on the event of the iteration before the one it has just
enqueued).  A CUDA event recorded on the stream after each iteration times
it, so a device gap counts against the next iteration.  The loop stops
enqueueing once ``--seconds`` have passed on the host's clock (on several
ranks, when rank 0 says so); the window ends when the device has finished
the last iteration.  Rates are taken over the whole window.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import re
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import torch

from bench_torch import trace as tr

ROOT = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


# -- the cell, from BENCHMARK.json --------------------------------------------

def _safe(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"bad name {name!r}")
    return name


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[str]
    per_layer: List[str]


def _reported(metric: dict, workload: str, reported_e2e) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return reported_e2e is None or metric.get("moves") in reported_e2e


def load_cell(bench_file: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``bench_file``: its configuration and
    traffic files, and the metrics it reports."""
    bench = load_json(bench_file)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_file}; "
                       f"there are {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = load_json(bench_file.parent / cfg_entry["file"])
    traffic = load_json(ROOT / "traffic" / f"{_safe(w['traffic'])}.json")
    e2e = [m["name"] for m in bench["end_to_end"]
           if _reported(m, workload, None)]
    layer = [m["name"] for m in bench["per_layer"]
             if _reported(m, workload, e2e)]
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=layer)


def _reader(kind: str, name: str):
    """The ``read`` function of ``<kind>/<name>.py``."""
    path = ROOT / kind / f"{_safe(name)}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_torch.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# -- one rank's run -----------------------------------------------------------

@dataclasses.dataclass
class Context:
    """What a driver is told of its run."""
    device: torch.device
    rank: int
    world: int
    seed: int
    impl: str = "program"   # or "control": the bf16 reference in its place
    group: object = None    # the default process group (None on one rank)


@dataclasses.dataclass
class Window:
    seconds: float
    iterations: int
    iter_ms: List[float]
    setup_s: float
    peak_bytes: int
    work: Dict[str, float]


@dataclasses.dataclass
class Traced:
    """What a per-layer reader reads."""
    trace: tr.Trace
    iterations: int
    config: dict
    traffic: dict
    device_name: str


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Clock:
    """Per-iteration marks: CUDA events on the stream, or the host's clock
    on the CPU (where every call has finished when it returns)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def wait(self, i):
        if self.cuda:
            self.marks[i].synchronize()

    def intervals_ms(self):
        m = self.marks
        if self.cuda:
            return [m[i].elapsed_time(m[i + 1]) for i in range(len(m) - 1)]
        return [(m[i + 1] - m[i]) * 1e3 for i in range(len(m) - 1)]


def _stop(flag: bool, stop_group) -> bool:
    if stop_group is None:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    torch.distributed.broadcast(t, src=0, group=stop_group)
    return bool(t.item())


def measure(driver, seconds: float, device, t0_wall: float,
            stop_group=None) -> Window:
    """The measured window (see the module's docstring)."""
    driver.begin_window()
    clock = _Clock(device)
    _sync(device)
    start_wall = time.time()
    start = time.perf_counter()
    clock.mark()
    n = 0
    while True:
        driver.iteration()
        clock.mark()
        n += 1
        clock.wait(n - 1)
        if _stop(time.perf_counter() - start >= seconds, stop_group):
            break
    _sync(device)
    elapsed = time.perf_counter() - start
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    return Window(seconds=elapsed, iterations=n, iter_ms=clock.intervals_ms(),
                  setup_s=start_wall - t0_wall, peak_bytes=peak,
                  work=driver.work())


def traced(driver, cell: Cell, device) -> Traced:
    """A ``torch.profiler`` window of the traffic's ``trace_iterations``,
    reduced by :mod:`bench_torch.trace`.  A trace that lost kernel records
    is taken once more; lost again, the run fails."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    n = driver.trace_iterations
    for attempt in range(2):
        driver.begin_window()
        _sync(device)
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "window.trace.json")
            with profile(activities=acts) as prof:
                with record_function(tr.WINDOW_SPAN):
                    for _ in range(n):
                        driver.iteration()
                    _sync(device)
            prof.export_chrome_trace(path)
            try:
                t = tr.load(path)
            except tr.LostRecords:
                if attempt:
                    raise
                continue
        return Traced(trace=t, iterations=n, config=cell.config,
                      traffic=cell.traffic, device_name=device_name(device))


def run_rank(cell: Cell, ctx: Context, seconds: float, trace: bool,
             t0_wall: float, stop_group=None) -> dict:
    """This rank's part of a run: its numbers, before the ranks' merge."""
    mod = importlib.import_module(
        f"bench_torch.drivers.{_safe(cell.traffic['driver'])}")
    driver = mod.Driver(ctx, cell.config, cell.traffic)
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    driver.setup()
    _sync(ctx.device)

    out = {"rank": ctx.rank}
    if trace:
        tw = traced(driver, cell, ctx.device)
        layer = {}
        for name in cell.per_layer:
            v = _reader("metrics", name)(tw)
            if v is not None:
                layer[name] = float(v)
        out["per_layer"] = layer
        out["busy_s"] = tw.trace.busy_us() / 1e6
        out["window_s"] = tw.trace.window_us / 1e6
        out["device_ops"] = tw.trace.top_ops()
        out["idle_gaps"] = tw.trace.top_gaps()

    win = measure(driver, seconds, ctx.device, t0_wall, stop_group)
    out["end_to_end"] = {}
    for name in cell.end_to_end:
        v = _reader("end_to_end", name)(win)
        if v is None and ctx.device.type == "cpu":
            continue      # a rehearsal has no device memory to read
        if v is None:
            raise RuntimeError(f"end-to-end metric {name} read nothing in "
                               f"cell {cell.name}")
        out["end_to_end"][name] = float(v)
    out["iterations"] = win.iterations
    out["peak_bytes"] = win.peak_bytes

    driver.release()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    checks, failed = driver.check()
    out["checks"] = {k: [float(v), float(lim)] for k, (v, lim) in
                     checks.items()}
    out["failed"] = int(failed)
    _sync(ctx.device)
    return out


# -- the ranks' merge ---------------------------------------------------------

def merge(parts: List[dict], bench: dict, cell: Cell, device: torch.device,
          world: int, trace: bool) -> dict:
    """The result's line: each metric's worst reading over the ranks (the
    slowest rank's), memory from the fullest, each check's worst
    reading."""
    better = {m["name"]: m["better"]
              for m in bench["end_to_end"] + bench["per_layer"]}
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    key = "per_layer" if trace else "end_to_end"
    names = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for name in names:
        vals = [p[key][name] for p in parts if name in p[key]]
        if not vals:
            continue
        v = max(vals) if better[name] == "lower" else min(vals)
        metrics[name] = {"value": v, "unit": units[name]}

    checks = {}
    for p in parts:
        for k, (v, lim) in p["checks"].items():
            old = checks.get(k)
            if old is None or not (v <= old["value"]):
                checks[k] = {"value": v, "limit": lim}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    failed = sum(p["failed"] for p in parts)
    correct = correct and failed == 0

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": device_name(device), "count": world,
           "memory_peak_bytes": max(p["peak_bytes"] for p in parts)}
    line = {"correct": correct, "attempted": parts[0]["iterations"],
            "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = sum(p["busy_s"] for p in parts) / len(parts)
        dev["window_s"] = max(p["window_s"] for p in parts)
        slow = max(parts, key=lambda p: p["busy_s"])
        line["breakdown"] = {
            "device_ops": [[tr.short(n), s] for n, s in slow["device_ops"]],
            "idle_gaps": [[tr.short(n), s] for n, s in slow["idle_gaps"]]}
    line["checks"] = checks
    return line
