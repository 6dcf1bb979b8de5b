"""Reduce a ``torch.profiler`` chrome trace of the traced window to what
the per-layer readers need: the device's operations, each with the host
op that launched it, the window, the device's busy time and its idle
gaps.

The arithmetic follows ``cudecomp_tpu_torch.performance.device_op_times``
and ``device_op_attribution`` (copied here, so that a change to the
program cannot move the yardstick): device work is the trace's kernels,
copies and fills; a device operation belongs to the launch call with its
correlation id; a launch whose kernel has no record is *lost*.  On the
H100 machines measured, the profiler drops kernel records as a process
ages; a trace that lost any is refused (:class:`LostRecords`), so that no
reader reads low.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

#: the harness's span around the traced iterations
WINDOW_SPAN = "bench_torch.window"

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class LostRecords(RuntimeError):
    """The trace holds launches whose device records are missing."""


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    cat: str
    ts: float     # microseconds
    dur: float    # microseconds
    host: Optional[str]   # the innermost host op around its launch


@dataclasses.dataclass
class Trace:
    ops: List[DeviceOp]
    window_ts: float
    window_us: float
    lost_launches: int
    gaps: List[Tuple[str, float]]   # (what the host did, microseconds)

    def busy_us(self) -> float:
        """Microseconds in which some device operation ran."""
        return sum(b - a for a, b in _merged(self.ops))

    def ms(self, pick) -> float:
        """Milliseconds of the device operations ``pick`` selects."""
        return sum(op.dur for op in self.ops if pick(op)) / 1e3

    def total_ms(self) -> float:
        return self.ms(lambda op: True)

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        """The ``n`` device operations (by name) that took most time, in
        seconds."""
        by: Dict[str, float] = {}
        for op in self.ops:
            by[op.name] = by.get(op.name, 0.0) + op.dur / 1e6
        return sorted(by.items(), key=lambda kv: -kv[1])[:n]

    def top_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        """The idle time of the device, in seconds, summed by what the host
        was doing meanwhile; the ``n`` largest."""
        by: Dict[str, float] = {}
        for what, us in self.gaps:
            by[what] = by.get(what, 0.0) + us / 1e6
        return sorted(by.items(), key=lambda kv: -kv[1])[:n]


def _merged(ops):
    out = []
    for a, b in sorted((op.ts, op.ts + op.dur) for op in ops):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(spans, queries):
    """For each query time, the innermost of ``spans`` (properly nested
    ``(ts, end, name)`` of one thread) open at that time, or None."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out = {}
    stack, i = [], 0
    for q in sorted(set(queries)):
        while i < len(spans) and spans[i][0] <= q:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < q:
            stack.pop()
        out[q] = stack[-1][2] if stack else None
    return out


def short(name: str, n: int = 160) -> str:
    return name if len(name) <= n else name[: n - 3] + "..."


def reduce_events(events) -> Trace:
    """A :class:`Trace` of the complete events of one chrome trace, cut to
    the :data:`WINDOW_SPAN` span."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    spans = [e for e in xs if e.get("name") == WINDOW_SPAN
             and e.get("cat") == "user_annotation"]
    if len(spans) != 1:
        raise ValueError(f"the trace holds {len(spans)} {WINDOW_SPAN!r} "
                         f"spans, not one")
    w0 = float(spans[0]["ts"])
    w1 = w0 + float(spans[0]["dur"])
    lane = (spans[0].get("pid"), spans[0].get("tid"))

    inside = lambda e: w0 <= float(e["ts"]) <= w1
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS and inside(e)]
    launches = {e["args"]["correlation"]: e for e in xs
                if e.get("cat") in LAUNCH_CATS and inside(e)
                and "correlation" in e.get("args", {})}
    seen = {e.get("args", {}).get("correlation") for e in dev}
    lost = sum(1 for c, e in launches.items()
               if "Launch" in e["name"] and c not in seen)

    # host ops by thread, and the launch (or gap) times to look up in them
    threads: Dict[tuple, list] = {}
    for e in xs:
        if e.get("cat") in ("cpu_op", "user_annotation"):
            key = (e.get("pid"), e.get("tid"))
            threads.setdefault(key, []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
    queries: Dict[tuple, list] = {}
    for e in dev:
        host = launches.get(e.get("args", {}).get("correlation"))
        if host is not None:
            queries.setdefault((host.get("pid"), host.get("tid")),
                               []).append(float(host["ts"]))
    found = {k: _innermost(threads.get(k, []), q) for k, q in queries.items()}

    ops = []
    for e in dev:
        host = launches.get(e.get("args", {}).get("correlation"))
        name = None
        if host is not None:
            key = (host.get("pid"), host.get("tid"))
            name = found[key][float(host["ts"])]
        ops.append(DeviceOp(e["name"], e["cat"], float(e["ts"]),
                            float(e["dur"]), name))

    # idle gaps, named by the innermost host op of the window's thread
    # (a cpu op, a trace range, or a runtime call such as a synchronize)
    # open at the gap's midpoint
    edges, t = [], w0
    for a, b in _merged(ops):
        if a > t:
            edges.append((t, a))
        t = max(t, b)
    if w1 > t:
        edges.append((t, w1))
    host_spans = list(threads.get(lane, []))
    host_spans += [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in xs
                   if e.get("cat") in LAUNCH_CATS
                   and (e.get("pid"), e.get("tid")) == lane]
    mids = [(a + b) / 2 for a, b in edges]
    named = _innermost(host_spans, mids)
    gaps = [(named[m] if named[m] not in (None, WINDOW_SPAN)
             else "(host between ops)", b - a)
            for m, (a, b) in zip(mids, edges)]
    return Trace(ops=ops, window_ts=w0, window_us=w1 - w0,
                 lost_launches=lost, gaps=gaps)


def load(path: str, refuse_lost: bool = True) -> Trace:
    """:func:`reduce_events` of the chrome trace at ``path``; raises
    :class:`LostRecords` when a launch's device record is missing."""
    with open(path) as f:
        data = json.load(f)
    tr = reduce_events(data.get("traceEvents", []))
    if refuse_lost and tr.lost_launches:
        raise LostRecords(f"{tr.lost_launches} kernel launches in the traced "
                          f"window have no device record")
    return tr


# -- what a device operation is -----------------------------------------------

def is_cufft(op: DeviceOp) -> bool:
    """cuFFT's work: a kernel launched inside one of torch's FFT ops
    (``aten::_fft_c2c``, ``_fft_r2c``, ``_fft_c2r``) and not inside a
    nested op (the normalisation's ``mul_``, a copy)."""
    return op.cat == "kernel" and (op.host or "").startswith("aten::_fft_")


def is_k1(op: DeviceOp) -> bool:
    """K1, the port's local-permute kernel (``csrc/transpose2d.cu``)."""
    return op.cat == "kernel" and "transpose2d_kernel" in op.name


def is_nccl(op: DeviceOp) -> bool:
    return op.cat == "kernel" and op.name.lower().startswith("nccl")
