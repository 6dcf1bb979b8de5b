"""The trace reduction and the per-layer readers on a hand-made chrome
trace."""

import json

import pytest

from bench_torch import harness, trace as tr


def _x(name, cat, ts, dur, tid=1, **args):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if args:
        e["args"] = args
    return e


def _events(lose=False):
    """A window of 100 us: cuFFT's kernel (10 us, launched inside
    aten::_fft_c2c), the normalisation (5 us, inside a nested mul_), K1
    (20 us), an NCCL kernel (8 us) and a copy (2 us); the device is idle
    from 70 us to 100 us while the host sits in a synchronize."""
    ev = [_x(tr.WINDOW_SPAN, "user_annotation", 0, 100),
          _x(tr.WINDOW_SPAN, "gpu_user_annotation", 10, 52, tid=7),
          _x("aten::_fft_c2c", "cpu_op", 1, 9),
          _x("cudaLaunchKernel", "cuda_runtime", 2, 1, correlation=1),
          _x("aten::mul_", "cpu_op", 5, 3),
          _x("cudaLaunchKernel", "cuda_runtime", 6, 1, correlation=2),
          _x("cudaLaunchKernel", "cuda_runtime", 11, 1, correlation=3),
          _x("ncclKernelLaunch", "cuda_runtime", 13, 1, correlation=4),
          _x("cudaMemcpyAsync", "cuda_runtime", 15, 1, correlation=5),
          _x("cudaDeviceSynchronize", "cuda_runtime", 60, 39),
          _x("regular_fft<...>", "kernel", 10, 10, tid=7, correlation=1),
          _x("vectorized_elementwise_kernel<MulFunctor>", "kernel", 20, 5,
             tid=7, correlation=2),
          _x("void transpose2d_kernel<float2>", "kernel", 30, 20, tid=7,
             correlation=3),
          _x("ncclDevKernel_SendRecv", "kernel", 50, 8, tid=7,
             correlation=4),
          _x("Memcpy DtoD", "gpu_memcpy", 60, 2, tid=7, correlation=5),
          _x("aten::empty", "cpu_op", 200, 3)]   # outside the window
    if lose:
        ev = [e for e in ev if e.get("args", {}).get("correlation") != 3
              or e["cat"] != "kernel"]
    return ev


def _traced(events, iterations=1, tmp_path=None):
    t = tr.reduce_events(events)
    return harness.Traced(trace=t, iterations=iterations,
                          config={"gdims": [1024] * 3, "pdims": [1, 1],
                                  "dtype": "complex64"},
                          traffic={"layout": "axis_contiguous"},
                          device_name="NVIDIA H100 80GB HBM3")


def test_reduction_attributes_by_launch():
    t = tr.reduce_events(_events())
    assert t.window_us == 100 and t.lost_launches == 0
    hosts = {op.name: op.host for op in t.ops}
    assert hosts["regular_fft<...>"] == "aten::_fft_c2c"
    assert hosts["vectorized_elementwise_kernel<MulFunctor>"] == "aten::mul_"
    assert t.ms(tr.is_cufft) == pytest.approx(0.010)
    assert t.ms(tr.is_k1) == pytest.approx(0.020)
    assert t.ms(tr.is_nccl) == pytest.approx(0.008)
    assert t.busy_us() == pytest.approx(10 + 5 + 20 + 8 + 2)
    gaps = dict(t.top_gaps())
    assert gaps["cudaDeviceSynchronize"] == pytest.approx(38e-6)
    assert gaps["aten::mul_"] == pytest.approx(10e-6)
    assert gaps["(host between ops)"] == pytest.approx(5e-6 + 2e-6)
    assert t.top_ops(1)[0][0] == "void transpose2d_kernel<float2>"


def test_readers_on_the_hand_trace(tmp_path):
    read = lambda name: harness._reader("metrics", name)(
        _traced(_events(), iterations=2))
    assert read("fft.cufft_ms") == pytest.approx(0.005)
    assert read("fft.other_ms") == pytest.approx((5 + 2) / 2 / 1e3)
    assert read("exchange.nccl_ms") == pytest.approx(0.004)
    assert read("device.idle.fft") == pytest.approx(55.0)
    assert read("tg.other_ms") == pytest.approx((5 + 20 + 8 + 2) / 2 / 1e3)
    # 4 * 2 * 8 GiB over 3.35 TB/s, against 10 us of K1 per round trip
    want = 100 * (4 * 2 * 8 * 2 ** 30 / 3.35e12) / 10e-6
    assert read("transpose.k1_roofline") == pytest.approx(want)


def test_readers_find_nothing_and_say_so():
    events = [_x(tr.WINDOW_SPAN, "user_annotation", 0, 100)]
    t = _traced(events)
    for name in ("fft.cufft_ms", "transpose.k1_roofline", "exchange.nccl_ms",
                 "device.idle.fft", "tg.cufft_ms"):
        assert harness._reader("metrics", name)(t) is None
    other = _traced(_events())
    other.device_name = "some other card"
    assert harness._reader("metrics", "transpose.k1_roofline")(other) is None


def test_a_trace_with_missing_kernel_records_is_refused(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _events(lose=True)}))
    with pytest.raises(tr.LostRecords):
        tr.load(str(path))
    assert tr.load(str(path), refuse_lost=False).lost_launches == 1
    path.write_text(json.dumps({"traceEvents": _events()}))
    assert tr.load(str(path)).lost_launches == 0


def test_the_window_span_must_be_there_once():
    with pytest.raises(ValueError):
        tr.reduce_events(_events()[1:])
