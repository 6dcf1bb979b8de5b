"""The yardstick's arithmetic against hand counts and against the
program's own geometry."""

import math

import pytest

import cudecomp_tpu_torch as cd
from cudecomp_tpu_torch.ops.fft import plan_stages

from bench_torch import yardstick


def test_fft_gflops_hand_count():
    # 1024^3 points: 5 * 2**30 * 30 flops in 40 ms
    assert yardstick.fft_gflops(2 ** 30, 0.040) == pytest.approx(
        5 * 2 ** 30 * 30 / 0.040 / 1e9)
    assert yardstick.fft_gflops(2 ** 30, 0.040) == pytest.approx(4026.53,
                                                                  rel=1e-5)


def test_transpose_bytes_hand_count():
    # four slab transposes of a 1024^3 complex64 field, each reading and
    # writing its 8 GiB once: 4 * 2 * 8 GiB
    assert yardstick.transpose_bytes_per_round_trip(
        (1024,) * 3, (1, 1), 8, True) == 4 * 2 * 8 * 2 ** 30
    assert yardstick.transpose_bytes_per_round_trip(
        (1024,) * 3, (1, 1), 8, False) == 0
    # one exchange a direction of a rank's 8 GiB on (1, 4)
    assert yardstick.transpose_bytes_per_round_trip(
        (2048, 2048, 1024), (1, 4), 8, False) == 2 * 2 * 8 * 2 ** 30


@pytest.mark.parametrize("pdims", [(1, 1), (1, 4), (4, 1), (2, 2)])
@pytest.mark.parametrize("ac", [False, True])
def test_transposes_match_the_programs_plan(pdims, ac):
    cfg = cd.GridConfig(gdims=(16, 16, 16), pdims=pdims,
                        transpose_axis_contiguous=(ac,) * 3)
    stages = plan_stages(cfg)
    want = sum(1 for s in stages if s[0] == "transpose")
    assert yardstick.transposes_per_direction(pdims, ac) == want


@pytest.mark.parametrize("pdims", [(1, 1), (1, 4), (2, 2)])
@pytest.mark.parametrize("ac", [False, True])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_pencils_match_the_programs_geometry(pdims, ac, axis):
    from cudecomp_tpu_torch import geometry

    gdims = (16, 8, 32)
    cfg = cd.GridConfig(gdims=gdims, pdims=pdims,
                        transpose_axis_contiguous=(ac,) * 3)
    for rank in range(pdims[0] * pdims[1]):
        order, shape, lo = yardstick.pencil(gdims, pdims, axis, ac, rank)
        assert order == cfg.mem_order(axis)
        assert shape == geometry.pencil_buffer_shape(cfg, axis)
        coords = geometry.coords_of_rank(cfg, rank)
        pinfo = geometry.get_pencil_info(cfg, axis, coords, None, None)
        assert tuple(pinfo.lo_g) == lo


def test_percentile_and_worst():
    v = list(range(1, 101))
    assert yardstick.percentile(v, 95) == pytest.approx(95.05)
    assert math.isnan(yardstick.worst([1.0, math.nan, 2.0]))
    assert yardstick.worst([1.0, 3.0, 2.0]) == 3.0


def test_peak_table():
    h100 = "NVIDIA H100 80GB HBM3"
    assert yardstick.peak(h100, "hbm_bytes_per_s") == 3.35e12
    assert yardstick.peak("cpu", "hbm_bytes_per_s") is None
