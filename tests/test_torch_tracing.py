"""The span recorder of ``cudecomp_tpu_torch.utils.tracing``: nesting,
counts, the buffer's cap, host and device times, nothing recorded with
the profiler off or the tracing knob set, the Taylor-Green step's
operator spans covering its nonlinear term, and on 4 gloo ranks a slab
transpose's pack, exchange and unpack."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import profile

import cudecomp_tpu_torch as ct
from cudecomp_tpu_torch.models.taylor_green import TaylorGreenSolver
from cudecomp_tpu_torch.utils import tracing
from cudecomp_tpu_torch.utils.testing import protocol_worker, run_ranks

ROOT = Path(__file__).resolve().parent.parent
P = tracing.PREFIX


@pytest.fixture(autouse=True)
def _empty_buffer():
    tracing.clear_spans()
    yield
    tracing.clear_spans()


def _tg(integrating_factor=False, split_complex=False):
    grid = ct.make_grid(ct.GridConfig(gdims=(16, 16, 16), pdims=(1, 1)),
                        "cpu")
    solver = TaylorGreenSolver(grid=grid, nu=1 / 1600,
                               integrating_factor=integrating_factor,
                               split_complex=split_complex)
    uh, fields = solver.setup(torch.float32)
    return solver, uh, fields


def test_spans_nest_with_their_parents_indices():
    with profile():
        with tracing.trace_range("a"):
            with tracing.trace_range("b"):
                with tracing.trace_range("c"):
                    pass
            with tracing.trace_range("d"):
                pass
        with tracing.trace_range("e"):
            pass
    spans = tracing.spans()
    assert [(s.name, s.parent) for s in spans] == [
        ("a", None), ("b", 0), ("c", 1), ("d", 0), ("e", None)]
    a, b, c, d, e = spans
    assert a.host_start_ns <= b.host_start_ns <= c.host_start_ns
    assert c.host_end_ns <= b.host_end_ns <= d.host_start_ns
    assert d.host_end_ns <= a.host_end_ns <= e.host_start_ns


def test_spans_carry_their_counts():
    with profile():
        with tracing.trace_range("x", bytes=1 << 40, peers=3):
            with tracing.trace_range("y"):
                pass
    x, y = tracing.spans()
    assert x.counts == {"bytes": 1 << 40, "peers": 3} and y.counts == {}


def test_cpu_spans_have_host_times_and_no_device_times():
    with profile():
        with tracing.trace_range("x"):
            torch.ones(64).sum()
    (x,) = tracing.spans()
    assert 0 < x.host_start_ns <= x.host_end_ns
    assert x.device_start_ms is None and x.device_end_ms is None


def test_the_full_buffer_drops_and_counts(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 3)
    with profile():
        for i in range(5):
            with tracing.trace_range(f"s{i}"):
                pass
    assert [s.name for s in tracing.spans()] == ["s0", "s1", "s2"]
    assert tracing.dropped_spans() == 2
    tracing.clear_spans()
    assert tracing.spans() == [] and tracing.dropped_spans() == 0


def test_a_span_opened_before_a_clear_parents_nothing_after_it():
    with profile():
        with tracing.trace_range("old"):
            tracing.clear_spans()
            with tracing.trace_range("new"):
                pass
    assert [(s.name, s.parent) for s in tracing.spans()] == [("new", None)]


def test_nothing_is_recorded_while_compiling(monkeypatch):
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    with profile():
        with tracing.trace_range("x"):
            pass
    assert tracing.spans() == []


class _FakeEvent:
    """A CUDA event on a host clock: ``record`` takes the time."""
    clock = [0.0]

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self, stream=None):
        self.clock[0] += 1.5
        self.t = self.clock[0]

    def elapsed_time(self, other):
        return other.t - self.t


def test_device_times_resolve_once_from_the_first_event(monkeypatch):
    syncs = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: "stream")
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: syncs.append(1))
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda name: None)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", lambda: None)
    _FakeEvent.clock[0] = 100.0
    with profile():
        with tracing.trace_range("a"):        # events at 101.5 ...
            with tracing.trace_range("b"):    # 103.0, 104.5
                pass
        # ... and 106.0
    assert syncs == []                        # recording waits for nothing
    a, b = tracing.spans()
    assert (a.device_start_ms, a.device_end_ms) == (0.0, 4.5)
    assert (b.device_start_ms, b.device_end_ms) == (1.5, 3.0)
    assert syncs == [1]
    assert tracing.spans() == [a, b] and syncs == [1]


def test_the_profiler_off_records_nothing_and_makes_no_event(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("an event or a sync with the profiler off")

    solver, uh, fields = _tg()
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(tracing.time, "perf_counter_ns", refuse)
    solver.step(uh, fields, 1e-3)
    assert tracing.spans() == [] and tracing.dropped_spans() == 0


_KNOB = (
    "import torch\n"
    "import cudecomp_tpu_torch as ct\n"
    "from cudecomp_tpu_torch.models.taylor_green import TaylorGreenSolver\n"
    "from cudecomp_tpu_torch.utils import tracing\n"
    "from torch.profiler import profile\n"
    "g = ct.make_grid(ct.GridConfig(gdims=(8, 8, 8), pdims=(1, 1)), 'cpu')\n"
    "s = TaylorGreenSolver(grid=g)\n"
    "uh, f = s.setup(torch.float32)\n"
    "with profile() as p:\n"
    "    s.step(uh, f, 1e-3)\n"
    "print(len(tracing.spans()), tracing.dropped_spans())\n")


def test_the_tracing_knob_records_no_span():
    env = dict(os.environ, CUDECOMP_TPU_DISABLE_TRACING="1")
    res = subprocess.run([sys.executable, "-c", _KNOB], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split()[-2:] == ["0", "0"]


@pytest.mark.parametrize("integrating_factor,split_complex",
                         [(False, False), (True, True)])
def test_the_operator_spans_cover_the_nonlinear_term(integrating_factor,
                                                     split_complex):
    solver, uh, fields = _tg(integrating_factor, split_complex)
    with profile() as prof:
        solver.step(uh, fields, 1e-3)
    inner = {P + n for n in ("tg_curl", "tg_cross", "tg_project",
                             "fft3d_forward", "fft3d_inverse")}
    seen, bare = 0, []
    for e in prof.events():
        if not e.name.startswith("aten::"):
            continue
        up, p = [], e.cpu_parent
        while p is not None:
            up.append(p.name)
            p = p.cpu_parent
        if P + "tg_nonlinear" in up:
            seen += 1
            if not inner & set(up):
                bare.append((e.name, up))
    assert seen > 0 and bare == []

    spans = tracing.spans()
    assert [s.name for s in spans if s.parent is None] == [P + "tg_step"]
    kids = {}
    for s in spans:
        if s.parent is not None and spans[s.parent].name == \
                P + "tg_nonlinear":
            kids.setdefault(s.parent, []).append(s.name)
    assert list(kids.values()) == [[
        P + "fft3d_inverse", P + "tg_curl", P + "fft3d_inverse",
        P + "tg_cross", P + "fft3d_forward", P + "tg_project"]] * 4


def test_slab_transpose_spans_on_four_gloo_ranks(tmp_path):
    run_ranks(protocol_worker, 4, (4, str(tmp_path / "pg"), ["spans"]),
              300, "the spans 4-rank run")
