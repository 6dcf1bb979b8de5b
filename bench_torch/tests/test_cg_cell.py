"""The cell ``cg1024.iter`` at a small size on the CPU: whole runs read
correct, planted faults read not correct, the control fails every limit,
the iteration's byte count against hand counts, and the four readers on
hand-made spans (and on spans they cannot read)."""

import itertools
import json
import subprocess
import sys
from collections import namedtuple
from pathlib import Path

import pytest
import torch

from bench_torch import cg_work, harness, readings, run, spans as sp

ROOT = Path(__file__).resolve().parents[2]
CELL = "cg1024.iter"
# cubic, so that the spacings are uniform and the matvec is the cell's
# (laplacian7 and the scale pass); large enough that the solve is still
# far from converged after the warm-up, the traced window and the window
N = 160
GDIMS = f"{N},{N},{N}"
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
    assert set(line["checks"]) == {"cg_step_rel_l2", "cg_step_max_rel",
                                   "cg_residual_gap", "cg_energy_rel"}
    if trace:
        # no device times on the CPU: the span readers read nothing
        assert line["metrics"] == {}
    else:
        assert set(line["metrics"]) == {"step_ms", "setup_s"}


def _wrap_iterate(monkeypatch, fn):
    from cudecomp_tpu_torch.models.poisson import PoissonSolver

    orig = PoissonSolver.cg_iterate
    monkeypatch.setattr(PoissonSolver, "cg_iterate",
                        lambda self, s, check_every=64:
                        fn(lambda: orig(self, s, check_every), s))


def _checked(iterations=8):
    """The cell's driver at the small size: set-up (64 iterations of
    warm-up), a window of ``iterations``, the check; the result line's
    ``checks`` and ``failed``, as ``harness.merge`` gives them."""
    from bench_torch.drivers.cg_iter import Driver

    cell = harness.load_cell(ROOT / "BENCHMARK.json", CELL)
    cell.config["gdims"] = [N] * 3
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


def test_an_iteration_returning_its_input(monkeypatch):
    # through the whole run: the result line reads not correct
    _wrap_iterate(monkeypatch, lambda it, s: s)
    line = run.result(ARGS)
    _failed(line, "cg_step_rel_l2", "cg_step_max_rel")
    assert line["checks"]["cg_step_rel_l2"]["value"] == pytest.approx(1.0)


def test_u_left_unupdated(monkeypatch):
    _wrap_iterate(monkeypatch, lambda it, s: it()._replace(u=s.u))
    _failed(_checked(), "cg_step_rel_l2", "cg_residual_gap",
            "cg_energy_rel")


def test_p_unwritten(monkeypatch):
    _wrap_iterate(monkeypatch, lambda it, s: it()._replace(p=s.p))
    _failed(_checked(), "cg_step_rel_l2", "cg_energy_rel")


def test_alpha_halved(monkeypatch):
    # alpha is the first guarded division of each iteration, beta the
    # second; cg_init makes none
    from cudecomp_tpu_torch.models import poisson

    real, calls = poisson._guarded_div, itertools.count()

    def halved(num, den):
        out = real(num, den)
        return out / 2 if next(calls) % 2 == 0 else out

    monkeypatch.setattr(poisson, "_guarded_div", halved)
    line = _checked()
    _failed(line, "cg_step_rel_l2")
    assert line["checks"]["cg_step_rel_l2"]["value"] >= 0.4


def test_a_missing_tap_in_the_matvec(monkeypatch):
    from cudecomp_tpu_torch.ops import stencil_kernel as K

    real = K.stencil27

    def dropped(u, w, ghosts=None, plan=None):
        w = w.copy()
        w[1, 1, 2] = 0.0          # the z + 1 face
        return real(u, w, ghosts, plan)

    monkeypatch.setattr(K, "stencil27", dropped)
    _failed(_checked(), "cg_step_rel_l2", "cg_step_max_rel",
            "cg_residual_gap")


def test_the_wrong_inverse_spacing_squared(monkeypatch):
    # 1/h^2 from h = L / (N - 1), the fencepost slip, in the solver's
    # cached operator
    from cudecomp_tpu_torch.models.poisson import PoissonSolver

    orig = PoissonSolver._cg_matvec

    def wrong(self):
        self._cache.setdefault("cg_op", ((N - 1) / (2 * torch.pi)) ** 2)
        return orig(self)

    monkeypatch.setattr(PoissonSolver, "_cg_matvec", wrong)
    _failed(_checked(), "cg_step_rel_l2", "cg_residual_gap")


def test_one_iteration_of_the_window_doing_no_work(monkeypatch):
    # the third iteration of the window (after 64 of warm-up) returns its
    # input; every other iteration, the last included, is sound
    calls = itertools.count(1)
    _wrap_iterate(monkeypatch,
                  lambda it, s: s if next(calls) == 67 else it())
    line = _checked()
    _failed(line, "cg_energy_rel")
    for name in ("cg_step_rel_l2", "cg_step_max_rel", "cg_residual_gap"):
        c = line["checks"][name]
        assert c["value"] <= c["limit"], (name, c)


def test_one_iteration_of_the_window_leaving_u(monkeypatch):
    calls = itertools.count(1)
    _wrap_iterate(monkeypatch, lambda it, s: it()._replace(u=s.u)
                  if next(calls) == 67 else it())
    line = _checked()
    _failed(line, "cg_residual_gap", "cg_energy_rel")


def test_the_control_fails_every_limit():
    cell = harness.load_cell(ROOT / "BENCHMARK.json", CELL)
    cell.config["gdims"] = [N] * 3
    limits = cell.config["limits"]
    cpu = torch.device("cpu")
    for seed in (1, 2 ** 33 + 7):
        prog = readings.reading(cell, seed, "program", 0.2, cpu)
        assert all(v <= limits[k] for k, v in prog["checks"].items()), prog
        ctrl = readings.reading(cell, seed, "control", 0.2, cpu)
        assert all(v > limits[k] for k, v in ctrl["checks"].items()), ctrl


def test_iteration_bytes_hand_counts():
    # one card: eleven passes over a 1024^3 float32 vector
    assert cg_work.iter_bytes((1024, 1024, 1024), (1, 1), 4) == \
        11 * 2 ** 30 * 4 == 47244640256
    # (2, 4): a rank's X-pencil is (1024, 512, 256), in float64
    assert cg_work.iter_bytes((1024, 1024, 1024), (2, 4), 8) == \
        11 * 1024 * 512 * 256 * 8


Span = namedtuple("Span", "name parent host_start_ns host_end_ns counts "
                          "device_start_ms device_end_ms")
P = sp.PREFIX


def _iteration(t0, check=False):
    """One CG iteration of 40 ms from ``t0``: the matvec 8 ms (K4's pass
    inside it 4 ms), the dots 3 and 2, the updates 10 and 5, a host check
    of 1 ms, 11 ms of the root's own (gaps between the children)."""
    out = [Span(P + "cg_iter", None, 0, 1, {"bytes": 1}, t0, t0 + 40)]
    t = t0
    for name, ms in (("cg_matvec", 8), ("cg_dot", 3), ("cg_update", 10),
                     ("cg_dot", 2), ("cg_update", 5)) + \
            ((("cg_check", 1),) if check else ()):
        out.append(Span(P + name, 0, 0, 1, {}, t + 1, t + 1 + ms))
        if name == "cg_matvec":
            out.append(Span(P + "stencil_pass", len(out) - 1, 0, 1, {},
                            t + 2, t + 6))
        t += 1 + ms
    return out


def _iterations(n):
    out = []
    for i in range(n):
        part = _iteration(50.0 * i, check=i % 64 == 63)
        out += [s._replace(parent=None if s.parent is None
                           else s.parent + len(out)) for s in part]
    return out


def _traced(n, gdims=(1024, 1024, 1024)):
    return harness.Traced(trace=None, iterations=n,
                          config={"gdims": list(gdims), "pdims": [1, 1],
                                  "dtype": "float32"},
                          traffic={"driver": "cg_iter"},
                          device_name="NVIDIA H100 80GB HBM3")


def _read(name, t):
    return harness._reader("metrics", name)(t)


@pytest.mark.parametrize("windows", [1, 2])
def test_the_readers_divide_by_the_cg_iter_roots(monkeypatch, windows):
    monkeypatch.setattr(sp, "recorded",
                        lambda: (_iterations(64 * windows), 0))
    t = _traced(64)
    assert _read("cg.matvec_ms", t) == pytest.approx(8.0)
    assert _read("cg.dot_ms", t) == pytest.approx(5.0)
    assert _read("cg.update_ms", t) == pytest.approx(15.0)
    # 11 * 2**30 * 4 bytes over 3.35 TB/s, against 40 ms an iteration
    assert _read("cg.iter_roofline", t) == pytest.approx(
        100 * (11 * 2 ** 30 * 4 / 3.35e12) / 40e-3)


def test_the_readers_read_nothing_they_cannot_read(monkeypatch):
    t = _traced(64)
    names = ("cg.matvec_ms", "cg.dot_ms", "cg.update_ms", "cg.iter_roofline")
    for got in (None,                                   # no span recorder
                (_iterations(63), 0),                   # a root missing
                (_iterations(64), 3),                   # spans dropped
                ([s._replace(device_start_ms=None, device_end_ms=None)
                  for s in _iterations(64)], 0),        # no device times
                ([s for s in _iterations(64)
                  if not s.name.endswith("cg_iter")], 0)):  # no roots
        monkeypatch.setattr(sp, "recorded", lambda got=got: got)
        for name in names:
            assert _read(name, t) is None, (name, got is None)
    # the parent's program: roots of another driver, no CG spans
    monkeypatch.setattr(sp, "recorded", lambda: (
        [Span(P + "diffusion_step_axis0", None, 0, 1, {}, 0.0, 1.0)], 0))
    for name in names:
        assert _read(name, t) is None
    other = _traced(64)
    other.device_name = "some other card"
    monkeypatch.setattr(sp, "recorded", lambda: (_iterations(64), 0))
    assert _read("cg.iter_roofline", other) is None
    assert _read("cg.matvec_ms", other) == pytest.approx(8.0)
