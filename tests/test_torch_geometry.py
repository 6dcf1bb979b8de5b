"""cudecomp_tpu_torch config, geometry, mesh and grid against cudecomp_tpu.

Both packages' configs are built from one spec (the JAX config's
``dataclasses.asdict``), and every geometry query must give equal results.
"""

import dataclasses
import enum

import jax
import numpy as np
import pytest
import torch

import cudecomp_tpu as cd
from cudecomp_tpu import geometry as jgeo
from cudecomp_tpu.grid import build_mesh as jax_build_mesh

import cudecomp_tpu_torch as ct
from cudecomp_tpu_torch import geometry as tgeo
from cudecomp_tpu_torch.parallel.mesh import mesh_ranks

ORDERS = [(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)]


def spec_of(jcfg, enums_as_values=True):
    d = dataclasses.asdict(jcfg)
    if enums_as_values:
        d = {k: (v.value if isinstance(v, enum.Enum) else v)
             for k, v in d.items()}
    return d


def twin_configs(**kw):
    jcfg = cd.GridConfig(**kw)
    return jcfg, ct.GridConfig.from_dict(spec_of(jcfg))


def random_spec(rng):
    """A random valid GridConfig spec: gdims, pdims, gdims_dist, layout and
    rank order, with the uneven 9x10x11 grid among the shapes."""
    gdims = [(9, 10, 11), (8, 8, 8), (5, 7, 3), (16, 12, 20),
             tuple(int(v) for v in rng.integers(1, 14, 3))][rng.integers(5)]
    pdims = (int(rng.integers(1, 5)), int(rng.integers(1, 5)))
    kw = dict(gdims=gdims, pdims=pdims)
    if rng.random() < 0.3:
        kw["gdims_dist"] = tuple(int(rng.integers(1, g + 1)) for g in gdims)
    r = rng.random()
    if r < 0.3:
        kw["transpose_axis_contiguous"] = tuple(bool(b) for b in
                                                rng.integers(0, 2, 3))
    elif r < 0.6:
        kw["transpose_mem_order"] = tuple(ORDERS[i] for i in
                                          rng.integers(0, 6, 3))
    if rng.random() < 0.5:
        kw["rank_order"] = cd.RankOrder.COL_MAJOR
    return kw


@pytest.mark.parametrize("enums_as_values", [True, False])
@pytest.mark.parametrize("kw", [
    dict(gdims=(9, 10, 11), pdims=(2, 2)),
    dict(gdims=(8, 8, 8), pdims=(1, 1),
         transpose_axis_contiguous=(True, False, True)),
    dict(gdims=(8, 8, 11), pdims=(2, 4), gdims_dist=(8, 8, 8),
         rank_order=cd.RankOrder.COL_MAJOR,
         transpose_method=cd.TransposeMethod.RING_XOR,
         halo_method=cd.HaloMethod.PALLAS),
    dict(gdims=(6, 7, 8), pdims=(3, 1),
         transpose_mem_order=((2, 1, 0), (0, 2, 1), (1, 0, 2))),
])
def test_config_from_dict(kw, enums_as_values):
    jcfg = cd.GridConfig(**kw)
    tcfg = ct.GridConfig.from_dict(spec_of(jcfg, enums_as_values))
    assert spec_of(jcfg) == spec_of(tcfg)
    for ax in range(3):
        assert tcfg.mem_order(ax) == jcfg.mem_order(ax)
        assert tcfg.inv_mem_order(ax) == jcfg.inv_mem_order(ax)
    assert tcfg.effective_gdims_dist == jcfg.effective_gdims_dist


@pytest.mark.parametrize("kw", [
    dict(gdims=(8, 8)),
    dict(gdims=(8, 8, 0)),
    dict(gdims=(8, 8, 8), pdims=(2, 0)),
    dict(gdims=(8, 8, 8), pdims=(1, 2, 3)),
    dict(gdims=(8, 8, 8), gdims_dist=(9, 8, 8)),
    dict(gdims=(8, 8, 8), transpose_mem_order=((0, 1, 2), (0, 0, 1),
                                               (0, 1, 2))),
    dict(gdims=(8, 8, 8), rank_order="diagonal"),
])
def test_config_rejects_what_jax_rejects(kw):
    with pytest.raises(ValueError):
        cd.GridConfig(**kw)
    with pytest.raises(ValueError):
        ct.GridConfig(**kw)


def test_config_from_dict_unknown_key():
    with pytest.raises(TypeError):
        ct.GridConfig.from_dict({"gdims": (4, 4, 4), "bogus": 1})


@pytest.mark.parametrize("seed", range(16))
def test_geometry_fuzz(seed):
    rng = np.random.default_rng(seed)
    for _ in range(6):
        jcfg, tcfg = twin_configs(**random_spec(rng))
        pr_n, pc_n = jcfg.pdims
        for n in jcfg.gdims:
            for p in (1, 2, 3, 5):
                assert tgeo.get_splits(n, p) == jgeo.get_splits(n, p)
                assert (tgeo.get_split_offsets(n, p)
                        == jgeo.get_split_offsets(n, p))
        for eb in (4, 8, 16):
            assert (tgeo.transpose_workspace_size(tcfg, eb)
                    == jgeo.transpose_workspace_size(jcfg, eb))
        for ax in range(3):
            assert tgeo.max_splits(tcfg, ax) == jgeo.max_splits(jcfg, ax)
            assert (tgeo.global_max_pencil_size(tcfg, ax)
                    == jgeo.global_max_pencil_size(jcfg, ax))
            halo = tuple(int(v) for v in rng.integers(0, 3, 3))
            pad = tuple(int(v) for v in rng.integers(0, 3, 3))
            assert (tgeo.pencil_buffer_shape(tcfg, ax, halo, pad)
                    == jgeo.pencil_buffer_shape(jcfg, ax, halo, pad))
            assert (tgeo.global_buffer_shape(tcfg, ax, halo, pad)
                    == jgeo.global_buffer_shape(jcfg, ax, halo, pad))
            for rank in range(pr_n * pc_n):
                coords = jgeo.coords_of_rank(jcfg, rank)
                assert tgeo.coords_of_rank(tcfg, rank) == coords
                assert tgeo.rank_of_coords(tcfg, *coords) == rank
                ti = tgeo.get_pencil_info(tcfg, ax, coords, halo, pad)
                ji = jgeo.get_pencil_info(jcfg, ax, coords, halo, pad)
                assert dataclasses.asdict(ti) == dataclasses.asdict(ji)
                assert (ti.shape_g, ti.lo_g, ti.hi_g, ti.interior_shape) == (
                    ji.shape_g, ji.lo_g, ji.hi_g, ji.interior_shape)
                assert (tgeo.halo_workspace_size(tcfg, ax, halo, coords, 8)
                        == jgeo.halo_workspace_size(jcfg, ax, halo, coords, 8))
                for dim in range(3):
                    for disp in (-2, -1, 0, 1, 3):
                        for periodic in (True, False):
                            assert tgeo.get_shifted_rank(
                                tcfg, ax, dim, disp, periodic, rank
                            ) == jgeo.get_shifted_rank(
                                jcfg, ax, dim, disp, periodic, rank)


def test_geometry_errors_match():
    jcfg, tcfg = twin_configs(gdims=(9, 10, 11), pdims=(2, 2))
    for fn_t, fn_j, args in [
        (tgeo.get_pencil_info, jgeo.get_pencil_info, (3, (0, 0))),
        (tgeo.get_pencil_info, jgeo.get_pencil_info, (0, (2, 0))),
        (tgeo.get_shifted_rank, jgeo.get_shifted_rank, (0, 3, 1, True, 0)),
        (tgeo.coords_of_rank, jgeo.coords_of_rank, (4,)),
    ]:
        with pytest.raises(ValueError):
            fn_j(jcfg, *args)
        with pytest.raises(ValueError):
            fn_t(tcfg, *args)
    with pytest.raises(ValueError):
        tgeo.get_splits(4, 0)
    with pytest.raises(ValueError):
        tgeo.get_pencil_info(tcfg, 0, (0, 0), halo_extents=(1, -1, 0))


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 12])
def test_pdims_candidates(n):
    assert tgeo.pdim_candidates(n) == jgeo.pdim_candidates(n)
    assert tgeo.squarest_pdims(n) == jgeo.squarest_pdims(n)


@pytest.mark.parametrize("rank_order", list(cd.RankOrder))
@pytest.mark.parametrize("pdims", [(1, 1), (2, 2), (1, 4), (4, 1), (2, 4)])
def test_mesh_rank_order_matches_jax(pdims, rank_order):
    n = pdims[0] * pdims[1]
    jmesh = jax_build_mesh(pdims, devices=jax.devices()[:n],
                           rank_order=rank_order)
    ids = np.vectorize(lambda d: d.id)(np.asarray(jmesh.devices))
    got = mesh_ranks(pdims, ct.RankOrder(rank_order.value))
    np.testing.assert_array_equal(got.numpy(), ids)
    # the coords a rank sits at are those of geometry.coords_of_rank
    cfg = ct.GridConfig(gdims=(4, 4, 4), pdims=pdims,
                        rank_order=rank_order.value)
    for pr in range(pdims[0]):
        for pc in range(pdims[1]):
            assert tgeo.coords_of_rank(cfg, int(got[pr, pc])) == (pr, pc)


def test_single_rank_grid_matches_jax():
    jcfg, tcfg = twin_configs(gdims=(9, 10, 11), pdims=(1, 1),
                              transpose_axis_contiguous=(True, True, True))
    jgrid = cd.make_grid(jcfg, devices=jax.devices()[:1])
    tgrid = ct.make_grid(tcfg, "cpu")
    assert tgrid.mesh is None and tgrid.device == torch.device("cpu")
    assert tgrid.coords == (0, 0) and tgrid.rank == 0
    for ax in range(3):
        assert (dataclasses.asdict(tgrid.pencil_info(ax, halo_extents=(1, 0, 2)))
                == dataclasses.asdict(jgrid.pencil_info(ax,
                                                        halo_extents=(1, 0, 2))))
        assert tgrid.buffer_shape(ax) == tuple(jgrid.global_shape(ax))
        assert tgrid.global_shape(ax) == jgrid.global_shape(ax)
    for ax, d in ((0, 1), (1, 1), (1, -1), (2, -1)):
        assert tgrid.comm_axis_name(ax, d) == jgrid.comm_axis_name(ax, d)
    assert tgrid.shifted_rank(0, 1, 1, True, 0) == 0


def test_make_grid_errors():
    # pdims (0, 0) runs the autotuner, which takes no caller mesh
    opts = ct.AutotuneOptions(n_warmup=0, n_trials=1)
    grid = ct.make_grid(ct.GridConfig(gdims=(8, 8, 8)), "cpu",
                        autotune_options=opts)
    assert grid.pdims == (1, 1) and grid.mesh is None
    with pytest.raises(ValueError, match="explicit mesh"):
        ct.make_grid(ct.GridConfig(gdims=(8, 8, 8)), "cpu", mesh=object(),
                     autotune_options=opts)
    with pytest.raises(ValueError, match="DeviceMesh"):
        ct.GridDescriptor(config=ct.GridConfig(gdims=(8, 8, 8), pdims=(2, 2)),
                          device="cpu")
    if not torch.distributed.is_initialized():
        with pytest.raises(RuntimeError, match="init_process_group"):
            ct.make_grid(ct.GridConfig(gdims=(8, 8, 8), pdims=(2, 2)), "cpu")

