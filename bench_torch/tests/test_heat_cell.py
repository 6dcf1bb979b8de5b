"""The cell ``heat2048x1024.step`` at a tiny size on the CPU: whole runs
read correct, planted faults read not correct, the control fails every
limit, the stencil's byte count against hand counts, and the three
readers on hand-made spans (and on a program without the pass's span)."""

import json
import subprocess
import sys
from collections import namedtuple
from pathlib import Path

import pytest
import torch

from bench_torch import harness, readings, run, spans as sp, stencil_work

ROOT = Path(__file__).resolve().parents[2]
CELL = "heat2048x1024.step"
GDIMS = "32,16,16"
ARGS = ["--workload", CELL, "--gdims", GDIMS, "--seconds", "0.3",
        "--device", "cpu", "--seed", "2147483693"]


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_on_the_cpu_when_asked(trace):
    p = subprocess.run([sys.executable, "-m", "bench_torch.run",
                        *ARGS[:-1], str(2 ** 31 + 12345), "--trace",
                        str(trace)], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1 and list(line)[-1] == "checks"
    assert set(line["checks"]) == {"heat_rel_l2", "heat_max_rel",
                                   "heat_rows_rel"}
    if trace:
        # no device times on the CPU: the span readers read nothing
        assert line["metrics"] == {}
    else:
        assert set(line["metrics"]) == {"step_ms", "setup_s"}


def _patch_step(monkeypatch, fn):
    import cudecomp_tpu_torch as cd

    orig = cd.diffusion_step
    monkeypatch.setattr(cd, "diffusion_step",
                        lambda grid, u, dt, axis, periods:
                        fn(orig, grid, u, dt, axis, periods))


def test_a_step_returning_its_input(monkeypatch):
    _patch_step(monkeypatch, lambda orig, g, u, dt, a, p: u.clone())
    line = run.result(ARGS)
    assert line["correct"] is False
    assert line["checks"]["heat_rel_l2"]["value"] == pytest.approx(1.0)


def test_half_a_step(monkeypatch):
    _patch_step(monkeypatch, lambda orig, g, u, dt, a, p:
                orig(g, u, dt / 2, a, p))
    line = run.result(ARGS)
    assert line["correct"] is False
    assert line["checks"]["heat_rel_l2"]["value"] == pytest.approx(0.5)


def test_one_face_tap_dropped(monkeypatch):
    from cudecomp_tpu_torch.ops import stencil_kernel as K

    real = K.stencil27

    def dropped(u, w, ghosts=None, plan=None):
        w = w.copy()
        w[1, 1, 2] = 0.0          # the z + 1 face
        return real(u, w, ghosts, plan)

    monkeypatch.setattr(K, "stencil27", dropped)
    line = run.result(ARGS)
    assert line["correct"] is False
    assert all(c["value"] > c["limit"] for c in line["checks"].values())


def test_a_pass_that_writes_half_of_x(monkeypatch):
    # K4 makes its output with torch.empty, and on the card the caching
    # allocator hands it the block of the previous output, which the
    # driver dropped just before the step.  The pass here writes the whole
    # box in the two warm-up steps and then only the lower half of x, so
    # the upper half keeps the previous step's answer; one block, held as
    # that allocator hands it over.
    from cudecomp_tpu_torch.ops import stencil_kernel as K

    real = K.stencil27
    block, calls = [], []

    def half(u, w, ghosts=None, plan=None):
        full = real(u, w, ghosts, plan)
        if not block:
            block.append(torch.empty_like(full))
        calls.append(1)
        h = u.shape[0] if len(calls) <= 2 else u.shape[0] // 2
        block[0][:h] = full[:h]
        return block[0]

    monkeypatch.setattr(K, "stencil27", half)
    line = run.result(ARGS)
    assert line["correct"] is False and line["failed"] > 0
    # the upper half keeps the second warm-up step's answer, of field 1:
    # the steps of field 0 read it (the last output only when it is one)
    c = line["checks"]["heat_rows_rel"]
    assert c["value"] > c["limit"]


def test_one_value_off_by_one_percent(monkeypatch):
    def altered(orig, g, u, dt, a, p):
        out = orig(g, u, dt, a, p)
        i = torch.unravel_index(out.abs().argmax(), out.shape)
        out[i] = out[i] * 1.01
        return out

    _patch_step(monkeypatch, altered)
    line = run.result(ARGS)
    assert line["correct"] is False
    assert line["checks"]["heat_max_rel"]["value"] > \
        line["checks"]["heat_max_rel"]["limit"]


def test_one_iteration_that_writes_no_new_output(monkeypatch):
    # the fifth call (the third of the window, after two warm-up steps)
    # leaves the field as it was; the window runs many more
    calls = []

    def once(orig, g, u, dt, a, p):
        calls.append(1)
        return u.clone() if len(calls) == 5 else orig(g, u, dt, a, p)

    _patch_step(monkeypatch, once)
    line = run.result(ARGS)
    assert line["attempted"] > 5
    checks = line["checks"]
    assert checks["heat_rel_l2"]["value"] <= checks["heat_rel_l2"]["limit"]
    assert checks["heat_rows_rel"]["value"] == pytest.approx(1.0)
    assert line["correct"] is False and line["failed"] == 1


def test_the_control_fails_every_limit():
    cell = harness.load_cell(ROOT / "BENCHMARK.json", CELL)
    cell.config["gdims"] = [int(v) for v in GDIMS.split(",")]
    limits = cell.config["limits"]
    cpu = torch.device("cpu")
    for seed in (1, 2, 2 ** 33 + 7):
        prog = readings.reading(cell, seed, "program", 0.2, cpu)
        assert all(v <= limits[k] for k, v in prog["checks"].items()), prog
        ctrl = readings.reading(cell, seed, "control", 0.2, cpu)
        assert all(v > limits[k] for k, v in ctrl["checks"].items()), ctrl


def test_stencil_bytes_hand_counts():
    # one card: the 2048x1024x1024 float32 field read once, written once
    assert stencil_work.step_bytes((2048, 1024, 1024), (1, 1), 4) == \
        2 * 2 ** 31 * 4 == 17179869184
    # (2, 4): a rank's X-pencil is (2048, 512, 256); Y and Z are split, so
    # it also reads two (2048, 256) y-planes and two (2048, 512) z-planes
    share = 2048 * 512 * 256
    assert stencil_work.step_bytes((2048, 1024, 1024), (2, 4), 4) == \
        4 * (2 * share + 2 * 2048 * 256 + 2 * 2048 * 512)
    # (1, 4): Z split only, two (2048, 1024) z-planes, in float64
    assert stencil_work.step_bytes((2048, 1024, 1024), (1, 4), 8) == \
        8 * (2 * 2048 * 1024 * 256 + 2 * 2048 * 1024)


PASS_BYTES = 2 * 2 ** 31 * 4
Span = namedtuple("Span", "name parent host_start_ns host_end_ns counts "
                          "device_start_ms device_end_ms")
P = sp.PREFIX


def _step(t0, with_pass=True):
    """One heat step of 10 ms from ``t0``: the ghosts 0.5 ms, the pass 9 ms,
    and 0.5 ms of the step's own (0.25 before the ghosts, 0.25 after the
    pass)."""
    out = [Span(P + "diffusion_step_axis0", None, 0, 1, {}, t0, t0 + 10)]
    if with_pass:
        out += [Span(P + "stencil_ghosts", 0, 0, 1, {"bytes": 0},
                     t0 + 0.25, t0 + 0.75),
                Span(P + "stencil_pass", 0, 0, 1,
                     {"bytes": PASS_BYTES, "points": 2 ** 31},
                     t0 + 0.75, t0 + 9.75)]
    return out


def _steps(n, with_pass=True, first=0.0):
    """``n`` steps of :func:`_step`; the first of every 8 (a window's
    first) ``first`` ms longer in its own time and in its pass."""
    out = []
    for i in range(n):
        part = _step(20.0 * i, with_pass)
        if i % 8 == 0 and first:
            part = [s._replace(device_end_ms=s.device_end_ms + first)
                    if s.name.endswith(("axis0", "pass")) else s
                    for s in part]
        out += [s._replace(parent=None if s.parent is None
                           else s.parent + len(out)) for s in part]
    return out


def _traced(n, gdims=(2048, 1024, 1024)):
    return harness.Traced(trace=None, iterations=n,
                          config={"gdims": list(gdims), "pdims": [1, 1],
                                  "dtype": "float32"},
                          traffic={"driver": "heat_step"},
                          device_name="NVIDIA H100 80GB HBM3")


def _read(name, t):
    return harness._reader("metrics", name)(t)


@pytest.mark.parametrize("windows", [1, 2])
def test_the_readers_read_the_steady_steps(monkeypatch, windows):
    # each window's first step is 3 ms longer (the host's first enqueue
    # under a fresh profiler): left out of every reading
    monkeypatch.setattr(sp, "recorded",
                        lambda: (_steps(8 * windows, first=3.0), 0))
    t = _traced(8)
    assert _read("heat.stencil_ms", t) == pytest.approx(9.0)
    assert _read("heat.step_self_ms", t) == pytest.approx(0.5)
    # 2 * 2**31 * 4 bytes over 3.35 TB/s, against 9 ms a step
    assert _read("heat.stencil_roofline", t) == pytest.approx(
        100 * (2 * 2 ** 31 * 4 / 3.35e12) / 9e-3)


def test_a_program_without_the_pass_span_reads_nothing(monkeypatch):
    # a diffusion_step that opens no pass span: the root alone
    monkeypatch.setattr(sp, "recorded", lambda: (_steps(8, False), 0))
    t = _traced(8)
    for name in ("heat.stencil_ms", "heat.stencil_roofline",
                 "heat.step_self_ms"):
        assert _read(name, t) is None
    # nor do they read where the root count fits no window, spans were
    # dropped, or the device was not timed
    for got in ((_steps(5), 0), (_steps(8), 1),
                ([s._replace(device_start_ms=None, device_end_ms=None)
                  for s in _steps(8)], 0), None):
        monkeypatch.setattr(sp, "recorded", lambda got=got: got)
        assert _read("heat.stencil_ms", t) is None
    other = _traced(8)
    other.device_name = "some other card"
    monkeypatch.setattr(sp, "recorded", lambda: (_steps(8), 0))
    assert _read("heat.stencil_roofline", other) is None


def test_the_roofline_holds_the_pass_to_the_configurations_bytes(
        monkeypatch):
    t = _traced(8)
    want = 100 * (PASS_BYTES / 3.35e12) / 9e-3

    def counted(counts):
        return [s._replace(counts=counts) if s.name.endswith("pass") else s
                for s in _steps(8)]

    # a pass that counts no bytes: the configuration's alone
    monkeypatch.setattr(sp, "recorded", lambda: (counted({}), 0))
    assert _read("heat.stencil_roofline", t) == pytest.approx(want)
    # a pass that counts half the box: another step, no share
    monkeypatch.setattr(sp, "recorded",
                        lambda: (counted({"bytes": PASS_BYTES // 2}), 0))
    assert _read("heat.stencil_roofline", t) is None
    assert _read("heat.stencil_ms", t) == pytest.approx(9.0)
