"""The performance report and timing of cudecomp_tpu_torch against
cudecomp_tpu's: the registry's rows, report and CSV files on the same
samples, the knobs, the per-op records of the transposes and halo updates,
``segment_roundtrip``, ``time_fn``'s clock, ``profile_trace`` and the
tracing off switch; on 4 gloo ranks the cross-rank rows, the segmented
round trip and a trace's communication share."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import cudecomp_tpu as cd
from cudecomp_tpu import performance as jperf

import cudecomp_tpu_torch as ct
from cudecomp_tpu_torch import performance as tperf
from cudecomp_tpu_torch.utils.testing import protocol_worker, run_ranks

ROOT = Path(__file__).resolve().parent.parent

# (key, ms, bytes): the first sample of each key is the warm-up discard
SAMPLES = [
    (("transpose_x_to_y", (16, 16, 16), (2, 2), "all_to_all", "float32",
      (0, 0, 0), (0, 0, 0), (0, 0, 0), (0, 0, 0)), ms, 12288)
    for ms in (9.0, 1.25, 1.5, 0.75)
] + [
    (("update_halos_axis0_dims012", (8, 8, 8), (1, 1), "ppermute",
      "float64", (1, 1, 1), (True, False, True), (0, 0, 0), False), ms, 0)
    for ms in (3.0, 0.125, 0.5)
] + [(("warm-up only",), 4.0, 8)]


def _fed(reg):
    for key, ms, nbytes in SAMPLES:
        reg.record(key, ms, nbytes)
    return reg


def test_registry_rows_report_and_csvs_match_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("CUDECOMP_TPU_PERF_WRITE_DIR", raising=False)
    j, t = _fed(jperf.PerfRegistry()), _fed(tperf.PerfRegistry())
    assert t.rows() == j.rows() and len(t.rows()) == 2
    for detail in (0, 1):
        assert t.report(detail=detail).splitlines() == \
            j.report(detail=detail).splitlines()
    jp = j.write_csv(str(tmp_path / "jax"))
    tp = t.write_csv(str(tmp_path / "torch"))
    assert [os.path.basename(p) for p in tp] == \
        [os.path.basename(p) for p in jp] and len(tp) == 2
    for a, b in zip(jp, tp):
        assert Path(a).read_text() == Path(b).read_text()
    # the write-dir knob exports at report time, as in JAX
    monkeypatch.setenv("CUDECOMP_TPU_PERF_WRITE_DIR", str(tmp_path / "w"))
    assert t.report().splitlines()[-1] == \
        f"  wrote 2 CSV file(s) to {tmp_path / 'w'}"
    t.clear()
    assert not t.rows() and t.trace_attribution is None


def test_import_time_knobs_match_jax(tmp_path):
    # _ENABLE_PERFORMANCE_REPORT, _PERF_N_WARMUP, _PERF_MAX_SAMPLES and
    # _PERF_DETAIL, set before either package is imported
    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "from cudecomp_tpu import performance as J\n"
        "from cudecomp_tpu_torch import performance as T\n"
        "import sys; sys.path.insert(0, 'tests')\n"
        "from test_torch_performance import _fed\n"
        "j, t = _fed(J.PerfRegistry()), _fed(T.PerfRegistry())\n"
        "assert J.REGISTRY.enabled and T.REGISTRY.enabled\n"
        "assert t.rows() == j.rows(), (t.rows(), j.rows())\n"
        "assert [r['count'] for r in t.rows()] == [1, 1]\n"
        "assert t.report().splitlines() == j.report().splitlines()\n"
        "assert '  samples' in t.report()\n"
        "print('SAME')\n")
    env = dict(os.environ, CUDECOMP_TPU_ENABLE_PERFORMANCE_REPORT="1",
               CUDECOMP_TPU_PERF_N_WARMUP="2", CUDECOMP_TPU_PERF_MAX_SAMPLES="1",
               CUDECOMP_TPU_PERF_DETAIL="1", JAX_PLATFORMS="cpu")
    env.pop("CUDECOMP_TPU_PERF_WRITE_DIR", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0 and "SAME" in res.stdout, res.stderr[-3000:]


def _twin_grids(**kw):
    jcfg = cd.GridConfig(gdims=(8, 6, 10), pdims=(1, 1), **kw)
    return (cd.make_grid(jcfg, devices=jax.devices()[:1]),
            ct.make_grid(ct.GridConfig(gdims=(8, 6, 10), pdims=(1, 1), **kw),
                         "cpu"))


def _ops(pkg, grid, x, he):
    names = ("x_to_y", "y_to_z", "z_to_y", "y_to_x")
    for _ in range(3):
        buf = x
        for name in names:
            buf = getattr(pkg, f"transpose_{name}")(
                grid, buf, input_halo_extents=he, output_halo_extents=he)
        pkg.update_halos(grid, x, 0, he, (True, False, True))


@pytest.mark.parametrize("layout", [{}, dict(
    transpose_axis_contiguous=(True, True, True))])
def test_per_op_records_match_jax(layout, monkeypatch):
    monkeypatch.setenv("CUDECOMP_TPU_LOCAL_PERMUTE", "xla")
    jgrid, tgrid = _twin_grids(**layout)
    he = (1, 0, 2)
    f = np.random.default_rng(0).standard_normal((8, 6, 10))
    regs = {}
    for pkg, perf, grid in ((cd, jperf, jgrid), (ct, tperf, tgrid)):
        perf.REGISTRY.clear()
        pkg.perf_report_enable(True)
        try:
            _ops(pkg, grid, pkg.scatter_global(grid, f, 0, halo_extents=he),
                 he)
            regs[pkg] = {k: (len(s.times_ms), s.bytes_moved)
                         for k, s in perf.REGISTRY.samples.items()}
        finally:
            pkg.perf_report_enable(False)
            perf.REGISTRY.clear()
    assert regs[ct] == regs[cd] and len(regs[ct]) == 5
    assert {n for n, _ in regs[ct].values()} == {2}  # 3 calls, 1 discarded


def test_report_off_times_and_synchronises_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("timed or synchronised with the report off")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(tperf.time, "perf_counter", refuse)
    tperf.REGISTRY.clear()
    tperf.perf_report_enable(False)
    _, grid = _twin_grids(transpose_axis_contiguous=(True, True, True))
    he = (1, 1, 1)
    _ops(ct, grid, ct.scatter_global(grid, torch.randn(8, 6, 10), 0,
                                     halo_extents=he), he)
    assert not tperf.REGISTRY.samples


def test_segment_roundtrip_on_one_rank():
    _, grid = _twin_grids(transpose_axis_contiguous=(True, True, True))
    tperf.REGISTRY.clear()
    tperf.perf_report_enable(True)
    try:
        for _ in range(2):  # the first sample of each key is discarded
            seg = ct.segment_roundtrip(grid, torch.complex64, iters=2,
                                       n_warmup=1, n_trials=2)
        rows = tperf.REGISTRY.rows()
    finally:
        tperf.perf_report_enable(False)
        tperf.REGISTRY.clear()
    assert set(seg) == {"total_ms", "a2a_ms", "local_ms", "a2a_gbps"}
    assert seg["total_ms"] > 0 and seg["local_ms"] == seg["total_ms"]
    assert seg["a2a_ms"] == 0.0 and seg["a2a_gbps"] == 0.0
    assert [r["config"].split("/")[-1] for r in rows] == ["a2a", "local",
                                                          "total"]
    assert rows[0]["config"].startswith(
        "transpose_roundtrip_segmented/(8, 6, 10)/(1, 1)/all_to_all/"
        "complex64")


def test_time_fn_clock_follows_the_device(monkeypatch):
    calls = []

    def no_cuda(*a, **k):
        raise AssertionError("a CPU timing touched CUDA")

    monkeypatch.setattr(torch.cuda, "Event", no_cuda)
    monkeypatch.setattr(torch.cuda, "synchronize", no_cuda)
    x = torch.zeros(4)
    times = tperf.time_fn(lambda a: calls.append(a), x, n_warmup=2,
                          n_trials=3, iters=4)
    assert len(times) == 3 and all(t >= 0 for t in times)
    assert len(calls) == 2 + 3 * 4
    assert len(tperf.time_fn(lambda: None, n_warmup=0, n_trials=2,
                             device="cpu")) == 2
    # no tensor and no device: the card's clock, which needs CUDA
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tperf.time_fn(lambda: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        tperf.time_fn(lambda a: None, torch.zeros(1, device="meta"),
                      device="cuda")


def test_profile_trace_names_the_trace_ranges(tmp_path, monkeypatch):
    monkeypatch.delenv("CUDECOMP_TPU_PERF_WRITE_DIR", raising=False)
    _, grid = _twin_grids(transpose_axis_contiguous=(True, True, True))
    x = torch.randn(grid.buffer_shape(0))
    with ct.profile_trace(str(tmp_path / "tr")) as d:
        ct.transpose_y_to_x(grid, ct.transpose_x_to_y(grid, x))
    times = tperf.device_op_times(d)
    assert times["cudecomp_tpu_torch.transpose_x_to_y"] > 0
    assert any(k.startswith("aten::") for k in times)
    a = tperf.device_op_attribution(d)
    assert set(a["ranges"]) >= {"cudecomp_tpu_torch.transpose_x_to_y",
                                "cudecomp_tpu_torch.transpose_y_to_x"}
    assert a["comm_ms"] == 0 and a["total_ms"] == a["local_ms"] > 0
    assert abs(sum(a["ranges"].values()) - a["total_ms"]) < 1e-9
    tperf.REGISTRY.clear()
    try:
        with tperf.attributed_trace(str(tmp_path / "tr2")):
            ct.transpose_x_to_y(grid, x)
        rep = tperf.REGISTRY.report()
    finally:
        tperf.REGISTRY.clear()
    assert "device-time attribution (profiler trace)" in rep
    assert "cudecomp_tpu_torch.transpose_x_to_y" in rep


_TRACED = (
    "import torch, cudecomp_tpu_torch as ct\n"
    "from torch.profiler import profile\n"
    "g = ct.make_grid(ct.GridConfig(gdims=(4, 4, 4), pdims=(1, 1),"
    " transpose_axis_contiguous=(True,) * 3), 'cpu')\n"
    "with profile() as p:\n"
    "    ct.transpose_x_to_y(g, torch.zeros(4, 4, 4))\n"
    "names = {e.key for e in p.key_averages()}\n"
    "print('RANGE' if 'cudecomp_tpu_torch.transpose_x_to_y' in names"
    " else 'NONE')\n")


@pytest.mark.parametrize("disabled", [False, True])
def test_disable_tracing_knob(disabled, capsys):
    # read at import: the knob set runs in a fresh process
    if not disabled:
        exec(_TRACED, {})
        assert capsys.readouterr().out.split()[-1] == "RANGE"
        return
    env = dict(os.environ, CUDECOMP_TPU_DISABLE_TRACING="1")
    res = subprocess.run([sys.executable, "-c", _TRACED], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split()[-1] == "NONE"


def test_performance_on_four_gloo_ranks(tmp_path):
    run_ranks(protocol_worker, 4, (4, str(tmp_path / "pg"), ["performance"]),
              300, "the performance 4-rank run")


def test_attribution_of_a_card_trace(tmp_path):
    # a chrome trace as torch.profiler writes it on the card: kernels
    # matched to their launches by correlation id, charged to the
    # innermost library range open on the launching thread; one launch
    # lost its kernel record
    def ev(cat, name, ts, dur, tid=1, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
             "pid": 1 if cat != "kernel" else 0, "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [
        ev("user_annotation", "cudecomp_tpu_torch.transpose_x_to_y", 0, 100),
        ev("user_annotation", "cudecomp_tpu_torch.exchange.all_to_all", 40,
           30),
        ev("cuda_runtime", "cudaLaunchKernel", 10, 2, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 50, 2, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 80, 2, corr=3),
        ev("cuda_runtime", "cudaLaunchKernel", 200, 2, corr=4),
        ev("cuda_runtime", "cudaLaunchKernel", 90, 2, tid=2, corr=5),
        ev("kernel", "transpose2d_kernel", 20, 500, corr=1),
        ev("kernel", "ncclDevKernel_SendRecv", 520, 250, corr=2),
        ev("kernel", "transpose2d_kernel", 770, 500, corr=3),
        ev("kernel", "ncclDevKernel_AllReduce", 1300, 50, corr=5),
        ev("gpu_user_annotation", "cudecomp_tpu_torch.transpose_x_to_y", 20,
           1250),
    ]
    import json
    (tmp_path / "a.trace.json").write_text(json.dumps(
        {"traceEvents": events}))
    assert tperf.device_op_times(str(tmp_path)) == {
        "transpose2d_kernel": 1.0, "ncclDevKernel_SendRecv": 0.25,
        "ncclDevKernel_AllReduce": 0.05}
    a = tperf.device_op_attribution(str(tmp_path))
    assert a["ranges"] == {"cudecomp_tpu_torch.transpose_x_to_y": 1.0,
                           "cudecomp_tpu_torch.exchange.all_to_all": 0.25,
                           "(outside the library)": 0.05}
    assert abs(a["comm_ms"] - 0.3) < 1e-12 and a["total_ms"] == 1.3
    assert a["lost_launches"] == 1
