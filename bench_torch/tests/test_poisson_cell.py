"""The cell ``poisson4096x256.k5`` at a small size on the CPU (K5's plain
version in the plan): whole runs read correct, planted faults read not
correct, the control fails every limit, K5's byte count against hand
counts, and the five readers on hand-made spans (and on spans they cannot
read)."""

import json
import subprocess
import sys
from collections import namedtuple
from pathlib import Path

import pytest
import torch

from bench_torch import harness, poisson_work, readings, run, spans as sp
from bench_torch import trace as tr

ROOT = Path(__file__).resolve().parents[2]
CELL = "poisson4096x256.k5"
# K5's gate at its smallest: N1 % 8 == 0, N2 % 128 == 0; the cell's
# lengths, so that the box is long in X as the cell's is
GDIMS = (32, 16, 128)
ARGS = ["--workload", CELL, "--gdims", ",".join(map(str, GDIMS)),
        "--seconds", "0.3", "--device", "cpu", "--seed", "2147483693"]
CHECKS = {"poisson_rel_l2", "poisson_max_rel", "poisson_rows_rel"}


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
    assert set(line["checks"]) == CHECKS
    if trace:
        # no device times on the CPU: the readers read nothing
        assert line["metrics"] == {}
    else:
        assert set(line["metrics"]) == {"step_ms", "setup_s"}


def _checked(iterations=6):
    """The cell's driver at the small size: set-up (8 solves of warm-up),
    a window of ``iterations``, the check; the result line's ``checks``
    and ``failed``, as ``harness.merge`` gives them."""
    from bench_torch.drivers.poisson_solve import Driver

    cell = harness.load_cell(ROOT / "BENCHMARK.json", CELL)
    cell.config["gdims"] = list(GDIMS)
    ctx = harness.Context(device=torch.device("cpu"), rank=0, world=1,
                          seed=2147483693)
    driver = Driver(ctx, cell.config, cell.traffic)
    driver.setup()
    driver.begin_window()
    for _ in range(iterations):
        driver.iteration()
    driver.release()
    checks, failed = driver.check()
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return {"correct": failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values()),
        "failed": failed, "checks": checks}


def _failed(line, *names):
    assert line["correct"] is False and line["failed"] > 0
    for name in names:
        c = line["checks"][name]
        assert not (c["value"] <= c["limit"]), (name, c)


def test_a_sound_window_reads_correct():
    line = _checked()
    assert line["correct"] is True and line["failed"] == 0, line


def _wrap_transform(monkeypatch, fn):
    """Replace K5's transform (its plain version here) by ``fn(real, x,
    inverse, scale)``."""
    from cudecomp_tpu_torch.ops import dft2 as D

    real = D._dft2
    monkeypatch.setattr(D, "_dft2", lambda x, inverse, scale=None:
                        fn(real, x, inverse, scale))


def test_k5s_inverse_factor_dropped(monkeypatch):
    # through the whole run: the inverse's 1/(N1*N2) left out
    _wrap_transform(monkeypatch, lambda real, x, inverse, scale:
                    real(x, inverse, 1.0 if inverse else scale))
    line = run.result(ARGS)
    _failed(line, *CHECKS)


@pytest.mark.parametrize("inverse", [False, True])
def test_half_a_transforms_planes_unwritten(monkeypatch, inverse):
    def half(real, x, inv, scale):
        out = real(x, inv, scale)
        if inv == inverse:
            out[x.shape[0] // 2:] = 0
        return out

    _wrap_transform(monkeypatch, half)
    _failed(_checked(), *CHECKS)


def test_the_symbols_sign_flipped(monkeypatch):
    from cudecomp_tpu_torch.models.poisson import PoissonSolver

    real = PoissonSolver._inv_k2
    monkeypatch.setattr(PoissonSolver, "_inv_k2", lambda self: -real(self))
    line = _checked()
    _failed(line, *CHECKS)
    assert line["checks"]["poisson_rel_l2"]["value"] == pytest.approx(2.0)


@pytest.mark.parametrize("zero_mode", [float("-inf"), -1.0])
def test_the_zero_mode_not_pinned(monkeypatch, zero_mode):
    # -1/|k|^2 at k = 0: unguarded (-inf), or left at the value of |k| = 1
    from cudecomp_tpu_torch.models.poisson import PoissonSolver

    real = PoissonSolver._inv_k2

    def unpinned(self):
        s = real(self).clone()
        s[0, 0, 0] = zero_mode
        return s

    monkeypatch.setattr(PoissonSolver, "_inv_k2", unpinned)
    _failed(_checked(), *CHECKS)


def test_one_solve_of_the_window_skipped(monkeypatch):
    # the third solve of the window (after 8 of warm-up) hands back the
    # previous output; every other solve, the last included, is sound
    from cudecomp_tpu_torch.models.poisson import PoissonSolver

    real, calls, last = PoissonSolver.solve, [0], [None]

    def skipping(self, f, discrete=False):
        calls[0] += 1
        if calls[0] != 11:
            last[0] = real(self, f, discrete)
        return last[0]

    monkeypatch.setattr(PoissonSolver, "solve", skipping)
    line = _checked()
    _failed(line, "poisson_rows_rel")
    for name in ("poisson_rel_l2", "poisson_max_rel"):
        c = line["checks"][name]
        assert c["value"] <= c["limit"], (name, c)
    assert line["failed"] == 1


def test_the_control_fails_every_limit():
    cell = harness.load_cell(ROOT / "BENCHMARK.json", CELL)
    cell.config["gdims"] = list(GDIMS)
    limits = cell.config["limits"]
    cpu = torch.device("cpu")
    for seed in (1, 2 ** 33 + 7):
        prog = readings.reading(cell, seed, "program", 0.2, cpu)
        assert all(v <= limits[k] for k, v in prog["checks"].items()), prog
        ctrl = readings.reading(cell, seed, "control", 0.2, cpu)
        assert all(v > limits[k] for k, v in ctrl["checks"].items()), ctrl


def test_k5_bytes_hand_counts():
    # one card: two transforms, each reading and writing the 2049-plane
    # complex64 half spectrum of 256 x 256 planes once
    assert poisson_work.k5_bytes((4096, 256, 256), (1, 1), 8) == \
        2 * 2 * 2049 * 256 * 256 * 8 == 4297064448
    # four ranks hold a quarter each
    assert poisson_work.k5_bytes((4096, 256, 256), (2, 2), 16) == \
        2 * 2 * 2049 * 256 * 256 * 16 // 4


Span = namedtuple("Span", "name parent host_start_ns host_end_ns counts "
                          "device_start_ms device_end_ms")
P = sp.PREFIX


def _solve(t0):
    """One solve of 10 ms from ``t0``: the forward FFT 3.5 ms (K5 1.5 of
    it), the scale 1.5, the inverse 4.5 (K5 1.5 of it), 0.5 ms of the
    root's own."""
    return [Span(P + "poisson_solve", None, 0, 1, {"kernel": 2}, t0, t0 + 10),
            Span(P + "fft3d_forward", 0, 0, 1, {}, t0, t0 + 3.5),
            Span(P + "dft2", 1, 0, 1, {}, t0 + 2, t0 + 3.5),
            Span(P + "poisson_scale", 0, 0, 1, {}, t0 + 3.5, t0 + 5),
            Span(P + "fft3d_inverse", 0, 0, 1, {}, t0 + 5, t0 + 9.5),
            Span(P + "dft2", 4, 0, 1, {}, t0 + 5, t0 + 6.5),
            Span(P + "fft_scale", 4, 0, 1, {}, t0 + 8.5, t0 + 9.5)]


def _solves(n):
    out = []
    for i in range(n):
        out += [s._replace(parent=None if s.parent is None
                           else s.parent + len(out)) for s in _solve(12.0 * i)]
    return out


def _traced(n, cufft_ms_per_solve=3.0):
    ops = [tr.DeviceOp("regular_fft_c2r", "kernel", 0.0,
                       cufft_ms_per_solve * 1e3, "aten::_fft_c2r")
           for _ in range(n)]
    ops.append(tr.DeviceOp("dft2_kernel", "kernel", 0.0, 1e3, "dft2"))
    trace = tr.Trace(ops=ops, window_ts=0.0, window_us=1.0, lost_launches=0,
                     gaps=[])
    return harness.Traced(trace=trace, iterations=n,
                          config={"gdims": [4096, 256, 256], "pdims": [1, 1],
                                  "dtype": "float32"},
                          traffic={"driver": "poisson_solve"},
                          device_name="NVIDIA H100 80GB HBM3")


def _read(name, t):
    return harness._reader("metrics", name)(t)


NAMES = ("poisson.k5_ms", "poisson.k5_roofline", "poisson.cufft_ms",
         "poisson.scale_ms", "poisson.other_ms")


@pytest.mark.parametrize("windows", [1, 2])
def test_the_readers_divide_by_the_poisson_solve_roots(monkeypatch, windows):
    monkeypatch.setattr(sp, "recorded", lambda: (_solves(8 * windows), 0))
    t = _traced(8)
    assert _read("poisson.k5_ms", t) == pytest.approx(3.0)
    assert _read("poisson.scale_ms", t) == pytest.approx(1.5)
    assert _read("poisson.cufft_ms", t) == pytest.approx(3.0)
    assert _read("poisson.other_ms", t) == pytest.approx(10 - 3 - 1.5 - 3)
    # 2 * 2 * 2049 * 256**2 * 8 bytes over 3.35 TB/s, against 3 ms a solve
    assert _read("poisson.k5_roofline", t) == pytest.approx(
        100 * (4297064448 / 3.35e12) / 3e-3)


def test_the_readers_read_nothing_they_cannot_read(monkeypatch):
    t = _traced(8)
    spanned = [n for n in NAMES if n != "poisson.cufft_ms"]
    for got in (None,                                   # no span recorder
                (_solves(7), 0),                        # a root missing
                (_solves(8), 3),                        # spans dropped
                ([s._replace(device_start_ms=None, device_end_ms=None)
                  for s in _solves(8)], 0),             # no device times
                ([s for s in _solves(8)
                  if not s.name.endswith("poisson_solve")], 0)):  # no roots
        monkeypatch.setattr(sp, "recorded", lambda got=got: got)
        for name in spanned:
            assert _read(name, t) is None, (name, got is None)
    # the parent's program: solves without dft2 or poisson_scale spans
    monkeypatch.setattr(sp, "recorded", lambda: (
        [s for s in _solves(8) if s.name.endswith(("poisson_solve",
                                                    "fft3d_forward",
                                                    "fft3d_inverse"))], 0))
    for name in spanned:
        assert _read(name, t) is None, name
    # a trace without cuFFT's kernels (a CPU run): no cuFFT time, no rest
    monkeypatch.setattr(sp, "recorded", lambda: (_solves(8), 0))
    assert _read("poisson.cufft_ms", _traced(8, 0.0)) is None
    assert _read("poisson.other_ms", _traced(8, 0.0)) is None
    other = _traced(8)
    other.device_name = "some other card"
    assert _read("poisson.k5_roofline", other) is None
    assert _read("poisson.k5_ms", other) == pytest.approx(3.0)
