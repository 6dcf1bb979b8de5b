"""The span readings (``bench_torch/spans.py``) and the readers that use
them, on hand-made span lists."""

from collections import namedtuple

import pytest

from bench_torch import harness, spans as sp

Span = namedtuple("Span", "name parent host_start_ns host_end_ns counts "
                          "device_start_ms device_end_ms")
P = sp.PREFIX


def _s(name, parent, d0, d1, **counts):
    return Span(P + name, parent, 0, 1, counts, d0, d1)


def _tg_step(t0):
    """One explicit RK4 step of 100 ms from ``t0``: one nonlinear term
    (curl 5, cross 7, project 11, two inverse FFTs of 10 and a forward of
    10 with a nested transpose), 1 ms of the nonlinear term in none of
    them, and 46 ms of the step's own sums."""
    b = t0 + 2
    return [
        _s("tg_step", None, t0, t0 + 100),
        _s("tg_nonlinear", 0, b, b + 54),
        _s("fft3d_inverse", 1, b, b + 10),
        _s("tg_curl", 1, b + 10, b + 15),
        _s("fft3d_inverse", 1, b + 15, b + 25),
        _s("tg_cross", 1, b + 25, b + 32),
        _s("fft3d_forward", 1, b + 32, b + 42),
        _s("transpose_x_to_y", 6, b + 33, b + 35),
        _s("tg_project", 1, b + 42, b + 53),
    ]


def _chain(*parts):
    """The span lists one after the other in one buffer."""
    out = []
    for part in parts:
        out += [s._replace(parent=None if s.parent is None
                           else s.parent + len(out)) for s in part]
    return out


def _steps(n):
    return _chain(*(_tg_step(100.0 * i) for i in range(n)))


def _traced(driver, iterations):
    return harness.Traced(trace=None, iterations=iterations, config={},
                          traffic={"driver": driver}, device_name="H100")


def _reads(monkeypatch, spans, dropped=0):
    monkeypatch.setattr(sp, "recorded", lambda: (spans, dropped))


def test_self_time_takes_the_union_of_the_children():
    spans = [_s("a", None, 0, 100),
             _s("b", 0, 10, 30), _s("c", 0, 20, 40),   # overlap: 30
             _s("d", 0, 35, 38),                        # inside c
             _s("e", 0, 90, 120),                       # past the end: 10
             _s("f", 4, 95, 96)]                        # a grandchild
    assert sp.self_ms(spans, P + "a") == pytest.approx(60.0)
    assert sp.self_ms(spans, P + "e") == pytest.approx(29.0)
    assert sp.self_ms(spans, P + "zzz") is None


def test_nested_matches_count_once_and_under_selects():
    spans = [_s("fft3d_forward", None, 0, 10), _s("fft3d_inverse", 0, 2, 5),
             _s("tg_step", None, 20, 40), _s("fft3d_inverse", 2, 21, 24)]
    fft = lambda n: n.startswith(P + "fft3d_")
    assert sp.span_ms(spans, fft) == pytest.approx(13.0)
    assert sp.span_ms(spans, fft, under=P + "tg_step") == pytest.approx(3.0)
    assert sp.span_ms(spans, sp.named("tg_curl")) is None


@pytest.mark.parametrize("windows", [1, 2])
def test_tg_readers_divide_by_the_steps(monkeypatch, windows):
    # the harness retakes a trace that lost records: both windows recorded
    _reads(monkeypatch, _steps(2 * windows))
    t = _traced("tg_step", 2)
    got = {m: harness._reader("metrics", m)(t) for m in
           ("tg.curl_ms", "tg.cross_ms", "tg.project_ms", "tg.fft_ms",
            "tg.step_self_ms")}
    assert got == pytest.approx({"tg.curl_ms": 5.0, "tg.cross_ms": 7.0,
                                 "tg.project_ms": 11.0, "tg.fft_ms": 30.0,
                                 "tg.step_self_ms": 46.0})
    # the five and the nonlinear term's own 1 ms make the step
    assert sum(got.values()) + 1.0 == pytest.approx(100.0)


def _round_trip(t0, nbytes):
    """One slab round trip of 20 ms: two transposes, each a pack of 2, an
    exchange of 4 and an unpack of 3."""
    out = [_s("fft3d_forward", None, t0, t0 + 10),
           _s("transpose_y_to_z", 0, t0 + 1, t0 + 10)]
    out += [_s("transpose_pack", 1, t0 + 1, t0 + 3),
            _s("exchange.all_to_all", 1, t0 + 3, t0 + 7, bytes=nbytes),
            _s("transpose_unpack", 1, t0 + 7, t0 + 10)]
    k = len(out)
    out += [_s("fft3d_inverse", None, t0 + 10, t0 + 20),
            _s("transpose_z_to_y", k, t0 + 10, t0 + 19),
            _s("transpose_pack", k + 1, t0 + 10, t0 + 12),
            _s("exchange.all_to_all", k + 1, t0 + 12, t0 + 16, bytes=nbytes),
            _s("transpose_unpack", k + 1, t0 + 16, t0 + 19)]
    return out


def _round_trips(n, nbytes=6 * 2 ** 30):
    return _chain(*(_round_trip(20.0 * i, nbytes) for i in range(n)))


def test_slab_readers(monkeypatch):
    _reads(monkeypatch, _round_trips(3))
    t = _traced("fft_roundtrip", 3)
    read = lambda m: harness._reader("metrics", m)(t)
    assert read("transpose.pack_ms") == pytest.approx(4.0)
    assert read("transpose.unpack_ms") == pytest.approx(6.0)
    # 6 GiB in 4 ms
    assert read("exchange.a2a_gbps") == pytest.approx(6 * 2 ** 30 / 4e6)


def test_an_exchange_without_bytes_reads_nothing():
    spans = [_s("fft3d_inverse", None, 0, 10), _s("exchange.halo_pallas",
                                                  0, 1, 2)]
    assert sp.exchange_gbps(spans) is None


NEW = ("tg.curl_ms", "tg.cross_ms", "tg.project_ms", "tg.fft_ms",
       "tg.step_self_ms", "transpose.pack_ms", "transpose.unpack_ms",
       "exchange.a2a_gbps")


def _all_read_nothing(t):
    return all(harness._reader("metrics", m)(t) is None for m in NEW)


@pytest.mark.parametrize("n", [1, 3, 5])
def test_a_root_count_that_fits_no_window_reads_nothing(monkeypatch, n):
    _reads(monkeypatch, _chain(_steps(n), _round_trips(n)))
    assert _all_read_nothing(_traced("tg_step", 2))
    assert _all_read_nothing(_traced("fft_roundtrip", 2))


def test_a_buffer_that_dropped_spans_reads_nothing(monkeypatch):
    _reads(monkeypatch, _chain(_steps(2), _round_trips(2)), dropped=1)
    assert _all_read_nothing(_traced("tg_step", 2))
    assert _all_read_nothing(_traced("fft_roundtrip", 2))


def test_spans_without_device_times_read_nothing(monkeypatch):
    cpu = [s._replace(device_start_ms=None, device_end_ms=None)
           for s in _chain(_steps(2), _round_trips(2))]
    _reads(monkeypatch, cpu)
    assert _all_read_nothing(_traced("tg_step", 2))
    assert _all_read_nothing(_traced("fft_roundtrip", 2))


def test_a_program_without_spans_reads_nothing(monkeypatch):
    import cudecomp_tpu_torch.utils.tracing as tracing

    monkeypatch.delattr(tracing, "spans")
    assert sp.recorded() is None
    assert _all_read_nothing(_traced("tg_step", 2))
