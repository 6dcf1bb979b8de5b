"""The port's bench table (``cudecomp_tpu_torch/bench_full.py``) on the
CPU at small sizes, against the JAX table (``bench_full.py``): the same
record keys per headline, the same GFLOPS and GB/s for the same time and
shape, gates that raise on a corrupted round trip, and ``main`` writing
what it printed.  One ``gpu`` test holds the gates on the card."""

import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from cudecomp_tpu_torch import bench, bench_full
from cudecomp_tpu_torch.ops import transpose as tr
from cudecomp_tpu_torch.ops.fft import DistributedFFT

ROOT = Path(__file__).resolve().parent.parent
T_SCANNED = 1e-3          # the stubbed scanned time of a JAX cycle, s
SEG = {"total_ms": 2.0, "a2a_ms": 0.5, "local_ms": 1.5, "a2a_gbps": 7.0}
LARGE_FFT = (32, 16, 16)  # tests/test_bench_smoke.py:60-64


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Clock:
    """A ``time.perf_counter`` that advances ``step`` s per call."""

    def __init__(self, step):
        self.step, self.n = step, 0

    def __call__(self):
        self.n += 1
        return self.n * self.step


@pytest.fixture(scope="module")
def jax_records():
    """JAX's records of every headline at small sizes on its 8 CPU
    devices, with its timers stubbed: ``{name: (record, seconds)}``."""
    mp = pytest.MonkeyPatch()
    try:
        mp.syspath_prepend(str(ROOT))
        jbf = _load("jax_bench_full", ROOT / "bench_full.py")
        jb = _load("jax_bench", ROOT / "bench.py")
        from cudecomp_tpu import performance as jperf
        mp.setattr(jbf, "_time_scanned_local", lambda *a, **k: T_SCANNED)
        mp.setattr(jperf, "segment_roundtrip", lambda *a, **k: dict(SEG))
        out = {
            "r2c": (jbf.fft_r2c(N=16, ITERS=1, n_trials=1), T_SCANNED / 2),
            "transpose": (jbf.transpose_headline(N=16, n_trials=1, iters=1),
                          None),
            "halo": (jbf.halo_headline(N=16, width=1, ITERS=1, n_trials=1),
                     None),
            "stencil": (jbf.stencil_headline(N=16, ITERS=1, n_trials=1),
                        None),
            "cg": (jbf.cg_headline(N=16, tol=1e-5, maxiter=50), None),
            "c2c": (jb.main(N=16, ITERS=1, n_trials=1), None),
        }
        clock = _Clock(1e-7)
        mp.setattr(time, "perf_counter", clock)
        out["fft_large"] = (jbf.fft_headline_large(LARGE_FFT, ITERS=1,
                                                   n_trials=1), clock.step)
        clock = _Clock(1e-6)
        mp.setattr(time, "perf_counter", clock)
        out["transpose_large"] = (jbf.transpose_headline_large(
            16, n_trials=1, iters=1), clock.step)
    finally:
        mp.undo()
    return out


PORT = {
    "c2c": lambda: bench.c2c_headline(N=16, iters=2, n_trials=2,
                                      device="cpu"),
    "r2c": lambda: bench_full.fft_r2c(N=16, iters=2, n_trials=2,
                                      device="cpu"),
    "transpose": lambda: bench_full.transpose_headline(N=16, n_trials=2,
                                                       iters=2, device="cpu"),
    "halo": lambda: bench.halo_headline(N=16, width=1, iters=2, n_trials=2,
                                        device="cpu"),
    "stencil": lambda: bench.stencil_headline(N=16, iters=2, n_trials=2,
                                              device="cpu"),
    "cg": lambda: bench.cg_headline(N=32, tol=1e-5, device="cpu"),
    "fft_large": lambda: bench_full.fft_headline_large(
        LARGE_FFT, iters=2, n_trials=2, device="cpu"),
    "transpose_large": lambda: bench_full.transpose_headline_large(
        16, n_trials=2, iters=2, device="cpu"),
}


@pytest.fixture(scope="module")
def port_records():
    return {k: fn() for k, fn in PORT.items()}


@pytest.mark.parametrize("name", sorted(PORT))
def test_record_has_the_keys_of_jax_record(name, jax_records, port_records):
    # vs_baseline, a ratio to a GPU cluster's number, is not ported
    want = set(jax_records[name][0]) - {"vs_baseline"}
    got = port_records[name]
    assert want <= set(got), want - set(got)
    assert got["unit"] == jax_records[name][0]["unit"]
    assert math.isfinite(got["value"]) and got["value"] > 0
    assert got.get("device", "cpu") == "cpu"


def test_r2c_gflops_is_jax_formula(jax_records):
    rec, t = jax_records["r2c"]
    assert bench_full.fft_gflops(16 ** 3, t) == pytest.approx(
        rec["value"], abs=0.005)
    assert bench.fft_gflops(16 ** 3, t) == pytest.approx(
        5 * 16 ** 3 * math.log2(16 ** 3) / t / 1e9)


def test_transpose_rates_are_jax_formula(jax_records):
    rec, _ = jax_records["transpose"]
    world = 8  # the JAX table's devices (tests/conftest.py)
    assert bench_full.transpose_local_gbps(
        16, 4, world, SEG["local_ms"]) == pytest.approx(
            rec["local_gbps_per_chip"], abs=0.005)
    assert rec["a2a_gbps_per_chip"] == pytest.approx(SEG["a2a_gbps"])
    assert (rec["a2a_ms"], rec["local_ms"], rec["value"]) == (
        SEG["a2a_ms"], SEG["local_ms"], SEG["total_ms"])
    # the port's record from the same segmentation
    got = bench_full._transpose_record(16, world, SEG["total_ms"],
                                       SEG["a2a_ms"], SEG["local_ms"],
                                       SEG["a2a_gbps"], 1.0, "")
    for k in ("value", "a2a_ms", "local_ms", "a2a_gbps_per_chip",
              "local_gbps_per_chip"):
        assert got[k] == pytest.approx(rec[k], abs=0.005), k


def test_large_fft_gflops_is_jax_formula(jax_records):
    rec, step = jax_records["fft_large"]
    n = math.prod(LARGE_FFT)
    work = 5 * n * math.log2(n) / 1e9
    # JAX's t is (clock ticks) / ITERS / 2 with ITERS = 1
    ticks = round(work / rec["value"] / (step / 2))
    assert ticks >= 1
    assert bench_full.fft_gflops(n, ticks * step / 2) == pytest.approx(
        rec["value"], abs=0.005)


def test_large_transpose_rate_is_jax_formula(jax_records):
    rec, step = jax_records["transpose_large"]
    t = rec["value"] / 1e3
    assert t / step == pytest.approx(round(t / step))
    assert bench_full.transpose_local_gbps(16, 4, 1, rec["value"]) == (
        pytest.approx(rec["local_gbps_per_chip"], abs=0.005))
    assert rec["a2a_ms"] == 0.0 and rec["a2a_gbps_per_chip"] is None


# -- the gates ---------------------------------------------------------------------

def _corrupt(monkeypatch, cls_attr, after):
    """Make ``DistributedFFT.<cls_attr>`` add 1e-3 to its output from call
    ``after + 1`` on."""
    real = getattr(DistributedFFT, cls_attr)
    calls = {"n": 0}

    def bad(self, x):
        out = real(self, x)
        calls["n"] += 1
        if calls["n"] <= after:
            return out
        if isinstance(out, tuple):
            return (out[0] + 1e-3, out[1])
        return out + 1e-3

    monkeypatch.setattr(DistributedFFT, cls_attr, bad)


GATED = {
    "c2c": ("inverse", lambda: bench.c2c_headline(N=16, iters=2, n_trials=1,
                                                  device="cpu")),
    "r2c": ("inverse_planes", lambda: bench_full.fft_r2c(
        N=16, iters=2, n_trials=1, device="cpu")),
    "fft_large": ("inverse_planes", lambda: bench_full.fft_headline_large(
        LARGE_FFT, iters=2, n_trials=1, device="cpu")),
}


@pytest.mark.parametrize("name", sorted(GATED))
@pytest.mark.parametrize("when", ["gate", "timed"])
def test_corrupted_round_trip_raises(monkeypatch, name, when):
    attr, run = GATED[name]
    _corrupt(monkeypatch, attr, after=0 if when == "gate" else 1)
    with pytest.raises(RuntimeError, match="gate" if when == "gate"
                       else "timed") as e:
        run()
    assert "max abs err" in str(e.value)


@pytest.mark.parametrize("fn", [
    lambda: bench_full.transpose_headline(N=16, n_trials=1, iters=1,
                                          device="cpu"),
    lambda: bench_full.transpose_headline_large(16, n_trials=1, iters=1,
                                                device="cpu")],
    ids=["transpose", "transpose_large"])
def test_transpose_round_trip_must_give_its_input_back(monkeypatch, fn):
    real = tr.transpose_y_to_x
    monkeypatch.setattr(tr, "transpose_y_to_x",
                        lambda grid, b, **kw: real(grid, b, **kw) + 1e-3)
    with pytest.raises(RuntimeError, match="bit for bit"):
        fn()


def test_max_abs_err_in_chunks_equals_the_whole():
    g = torch.Generator().manual_seed(3)
    a = torch.randn(7, 5, 3, generator=g)
    b = torch.randn(7, 5, 3, generator=g)
    want = float((a - b).abs().max())
    for chunk in (1, 60, 61, 10 ** 9):
        assert bench.max_abs_err(a, b, chunk_bytes=chunk) == want
    c = torch.complex(a, b)
    assert bench.max_abs_err(c, c.conj(), chunk_bytes=8) == pytest.approx(
        float((2 * b).abs().max()))
    assert bench.max_abs_err(torch.tensor(1.0), torch.tensor(3.5)) == 2.5
    assert bench.max_abs_err(torch.zeros(0, 4), torch.zeros(0, 4)) == 0.0
    with pytest.raises(ValueError, match="shapes differ"):
        bench.max_abs_err(a, b[:3])


# -- main and the table ------------------------------------------------------------

def test_table_is_jax_order_with_the_two_new_cells():
    names = [(fn.__name__, kw) for fn, kw in bench_full.table(True)]
    assert names == [
        ("c2c_headline", {"N": 256}), ("c2c_headline", {"N": 512}),
        ("c2c_headline", {"N": 512, "axis_contiguous": False}),
        ("fft_r2c", {"N": 512}), ("transpose_headline", {"N": 512}),
        ("halo_headline", {"N": 512, "width": 1}),
        ("stencil_headline", {"N": 512}), ("cg_headline", {"N": 256}),
        ("fft_headline_large", {"gdims": (768, 768, 768)}),
        ("fft_headline_large", {"gdims": (1024, 512, 512)}),
        ("fft_headline_large", {"gdims": (1024, 1024, 1024)}),
        ("fft_r2c", {"N": 768}), ("transpose_headline_large", {"N": 768}),
        ("transpose_headline_large", {"N": 1024})]
    assert bench_full.table(False) == bench_full.table(True)[:8]


def _small_table(large):
    cells = [(bench.c2c_headline, {"N": 16}),
             (bench.c2c_headline, {"N": 16, "axis_contiguous": False}),
             (bench_full.fft_r2c, {"N": 16}),
             (bench_full.transpose_headline, {"N": 16})]
    if large:
        cells += [(bench_full.fft_headline_large, {"gdims": LARGE_FFT,
                                                   "iters": 2}),
                  (bench_full.transpose_headline_large, {"N": 16})]
    return cells


@pytest.mark.parametrize("large", [True, False])
def test_main_writes_what_it_printed(monkeypatch, capsys, tmp_path, large):
    monkeypatch.setattr(bench_full, "table", _small_table)
    out = tmp_path / "table.json"
    got = bench_full.main(out=str(out), large=large, device="cpu")
    printed = [json.loads(line) for line in
               capsys.readouterr().out.strip().splitlines()]
    assert printed == got == json.loads(out.read_text())
    assert len(got) == len(_small_table(large))
    for r in got:
        assert r["device"] == "cpu" and r["max_memory_allocated_gib"] is None


def test_main_writes_nothing_without_a_path(monkeypatch, capsys, tmp_path):
    # and never the TPU table, BENCH_FULL.json
    tpu_table = (ROOT / "BENCH_FULL.json").read_bytes()
    monkeypatch.setattr(bench_full, "table", _small_table)
    monkeypatch.chdir(tmp_path)
    bench_full.main(large=False, device="cpu")
    assert list(tmp_path.iterdir()) == []
    assert (ROOT / "BENCH_FULL.json").read_bytes() == tpu_table


def test_large_defaults_to_the_environment(monkeypatch, capsys):
    seen = []
    monkeypatch.setattr(bench_full, "table",
                        lambda large: seen.append(large) or [])
    for env, want in ((None, True), ("0", False), ("1", True)):
        if env is None:
            monkeypatch.delenv("CUDECOMP_TPU_BENCH_LARGE", raising=False)
        else:
            monkeypatch.setenv("CUDECOMP_TPU_BENCH_LARGE", env)
        bench_full.main(device="cpu")
        assert seen[-1] is want
    assert bench_full._args([]).large is None
    a = bench_full._args(["--no-large", "--out", "x.json"])
    assert a.large is False and a.out == "x.json"


@pytest.mark.parametrize("fn", [
    bench_full.main, bench_full.fft_r2c, bench_full.transpose_headline,
    lambda: bench_full.fft_headline_large(LARGE_FFT),
    lambda: bench_full.transpose_headline_large(16), bench.c2c_headline,
    bench.halo_headline, bench.stencil_headline, bench.cg_headline],
    ids=["main", "r2c", "transpose", "fft_large", "transpose_large", "c2c",
         "halo", "stencil", "cg"])
def test_headlines_need_cuda_unless_asked_for_the_cpu(monkeypatch, fn):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        fn()


@pytest.mark.parametrize("module", ["bench_full", "sweep"])
def test_module_never_imports_jax(module):
    code = (f"import sys, cudecomp_tpu_torch.{module}\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'cudecomp_tpu' "
            "or m.startswith('cudecomp_tpu.') or m == 'yaml']\n"
            "assert not bad, bad\nprint('CLEAN')")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "CLEAN" in res.stdout, res.stderr


# -- on the card -------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_phase12_gates_at_64(cuda, monkeypatch):
    # every headline's gate on the card at 64^3, then a corrupted round
    # trip raising at the gate and on the timed output
    recs = [bench.c2c_headline(N=64, iters=2, n_trials=2),
            bench_full.fft_r2c(N=64, iters=2, n_trials=2),
            bench_full.fft_headline_large((64, 64, 64), iters=2,
                                          n_trials=2),
            bench_full.transpose_headline(N=64, n_trials=2, iters=2),
            bench_full.transpose_headline_large(64, n_trials=2, iters=2)]
    for r in recs:
        assert math.isfinite(r["value"]) and r["value"] > 0
        for k in ("err", "gate_err", "timed_err"):
            assert r.get(k, 0.0) < bench.GATE
    for attr, when, run in (
            ("inverse", 0, lambda: bench.c2c_headline(N=64, iters=2,
                                                      n_trials=1)),
            ("inverse_planes", 1, lambda: bench_full.fft_headline_large(
                (64, 64, 64), iters=2, n_trials=1))):
        with monkeypatch.context() as m:
            _corrupt(m, attr, after=when)
            with pytest.raises(RuntimeError, match="max abs err"):
                run()
    assert np.isfinite(torch.cuda.max_memory_allocated())
