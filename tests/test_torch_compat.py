"""The port's ``compat`` layer (the ``cudecomp*`` entry points) against the
JAX package's: the cases of ``tests/test_compat.py``, every enum constant,
the struct translations field for field, the queries, and the
basic-usage flow on 4 gloo ranks bit-equal to JAX compat's on a (2, 2)
CPU mesh."""

import dataclasses
import enum
import zlib

import jax
import numpy as np
import pytest
import torch

import cudecomp_tpu as cd
from cudecomp_tpu import compat as jc
from cudecomp_tpu import geometry as jgeo
from cudecomp_tpu.utils.arrays import coords_of_shard_index

import cudecomp_tpu_torch as ct
from cudecomp_tpu_torch import compat as cc
from cudecomp_tpu_torch.config import HaloMethod, TransposeMethod
from cudecomp_tpu_torch.utils.testing import (compat_queries,
                                              multirank_worker, run_ranks)


def _names(mod):
    return {k: getattr(mod, k) for k in dir(mod) if k.startswith("CUDECOMP_")}


def test_every_enum_constant_equals_jax():
    assert _names(cc) == _names(jc)
    assert len(_names(cc)) == 23


def _plain(value):
    """A native config or options value as plain data, comparable across
    the packages: enums by value, dtypes by name."""
    if isinstance(value, enum.Enum):
        return value.value
    if isinstance(value, (tuple, list)):
        return tuple(_plain(v) for v in value)
    if isinstance(value, torch.dtype):
        return str(value).replace("torch.", "")
    if isinstance(value, np.dtype):
        return value.name
    return value


def _fields(obj):
    return {f.name: _plain(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


_CONFIGS = [
    dict(gdims=(16, 20, 24), pdims=(2, 2)),
    dict(gdims=(9, 10, 11), gdims_dist=(8, 10, 11), pdims=(1, 4),
         rank_order=2, transpose_comm_backend=6, halo_comm_backend=4,
         transpose_axis_contiguous=(True, False, True)),
    dict(gdims=(8, 8, 8), pdims=(0, 0), rank_order=1,
         transpose_comm_backend=2,
         transpose_mem_order=((1, 0, 2), (2, 1, 0), (0, 2, 1))),
    dict(gdims=(8, 12, 10), pdims=(4, 1), transpose_comm_backend=5,
         halo_comm_backend=3),
]

_OPTIONS = [
    {},
    dict(n_warmup_trials=0, n_trials=1, autotune_transpose_backend=True,
         disable_nccl_backends=True, disable_nvshmem_backends=True),
    dict(grid_mode=1, dtype=-4, allow_uneven_decompositions=False,
         skip_threshold=1.5, autotune_halo_backend=True,
         disable_mpi_backends=True, halo_extents=(1, 2, 1),
         halo_periods=(True, False, True), halo_axis=2,
         halo_padding=(0, 1, 0)),
    dict(dtype=-1, disable_mpi_backends=True, disable_nccl_backends=True,
         transpose_op_weights=(2.0, 1.0, 1.0, 2.0),
         transpose_input_halo_extents=((1, 1, 1),) * 4,
         transpose_output_padding=((0, 1, 0),) * 4),
    dict(dtype=-2, disable_nvshmem_backends=True),
    dict(dtype=-3, disable_mpi_backends=True, disable_nvshmem_backends=True),
]


@pytest.mark.parametrize("i", range(len(_CONFIGS)))
def test_native_config_equals_jax(i):
    t, j = cc.cudecompGridDescConfig_t(), jc.cudecompGridDescConfig_t()
    for k, v in _CONFIGS[i].items():
        setattr(t, k, v)
        setattr(j, k, v)
    assert _fields(t) == _fields(j)
    assert _fields(cc._native_config(t)) == _fields(jc._native_config(j))


@pytest.mark.parametrize("i", range(len(_OPTIONS)))
def test_native_options_equal_jax(i):
    t = cc.cudecompGridDescAutotuneOptionsSetDefaults()
    j = jc.cudecompGridDescAutotuneOptionsSetDefaults()
    for k, v in _OPTIONS[i].items():
        setattr(t, k, v)
        setattr(j, k, v)
    assert _fields(t) == _fields(j)
    assert _fields(cc._native_options(t)) == _fields(jc._native_options(j))


def test_all_families_disabled_rejected():
    for mod in (cc, jc):
        options = mod.cudecompGridDescAutotuneOptionsSetDefaults()
        options.disable_mpi_backends = True
        options.disable_nccl_backends = True
        options.disable_nvshmem_backends = True
        options.autotune_transpose_backend = True
        with pytest.raises(ValueError, match="disabled"):
            mod._native_options(options)
    config = cc.cudecompGridDescConfigSetDefaults()
    config.gdims = (16, 16, 16)
    with pytest.raises(ValueError, match="disabled"):
        cc.cudecompGridDescCreate(cc.cudecompInit(device="cpu"), config,
                                  options)
    with pytest.raises(ValueError, match="must be set positive"):
        cc._native_config(cc.cudecompGridDescConfigSetDefaults())


def test_handle_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cc.cudecompInit()
    config = cc.cudecompGridDescConfigSetDefaults()
    config.gdims, config.pdims = (8, 8, 8), (1, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        cc.cudecompGridDescCreate(None, config)
    h = cc.cudecompInit(device="cpu")
    assert h.device == torch.device("cpu")
    assert cc.cudecompGridDescCreate(h, config).device == torch.device("cpu")


@pytest.mark.parametrize("kw", [
    dict(gdims=(9, 10, 11)),
    dict(gdims=(8, 12, 10), transpose_axis_contiguous=(True, True, True)),
    dict(gdims=(6, 7, 8), transpose_mem_order=((2, 1, 0), (0, 2, 1),
                                               (1, 2, 0))),
])
def test_one_rank_queries_equal_jax(kw):
    jcfg = cd.GridConfig(pdims=(1, 1), **kw)
    jgrid = jc.cudecompGridDescCreate(None, _struct(jc, jcfg),
                                      devices=jax.devices()[:1])
    tgrid = cc.cudecompGridDescCreate(
        cc.cudecompInit(device="cpu"), _struct(cc, jcfg))
    assert compat_queries(cc, None, tgrid) == compat_queries(jc, None, jgrid)


def _struct(mod, jcfg):
    s = mod.cudecompGridDescConfigSetDefaults()
    s.gdims, s.pdims = jcfg.gdims, jcfg.pdims
    s.transpose_axis_contiguous = jcfg.transpose_axis_contiguous
    s.transpose_mem_order = jcfg.transpose_mem_order
    return s


def test_ported_basic_usage_flow_one_rank():
    # the flow of tests/test_compat.py at pdims (1, 1), against JAX compat
    f = np.random.default_rng(5).standard_normal((16, 20, 24))
    handle = cc.cudecompInit(device="cpu")
    config = cc.cudecompGridDescConfigSetDefaults()
    config.gdims, config.pdims = (16, 20, 24), (1, 1)
    config.transpose_axis_contiguous = (True, True, True)
    grid = cc.cudecompGridDescCreate(handle, config)
    jconfig = jc.cudecompGridDescConfigSetDefaults()
    jconfig.gdims, jconfig.pdims = (16, 20, 24), (1, 1)
    jconfig.transpose_axis_contiguous = (True, True, True)
    jgrid = jc.cudecompGridDescCreate(None, jconfig,
                                      devices=jax.devices()[:1])
    assert dataclasses.asdict(config) == dataclasses.asdict(jconfig)
    x = ct.scatter_global(grid, torch.from_numpy(f), 0)
    jx = cd.scatter_global(jgrid, f, 0)
    for name in ("XToY", "YToZ", "ZToY", "YToX"):
        x = getattr(cc, f"cudecompTranspose{name}")(handle, grid, x)
        jx = getattr(jc, f"cudecompTranspose{name}")(None, jgrid, jx)
        assert np.array_equal(x.numpy(), np.asarray(jx)), name
    he = (1, 1, 1)
    h = ct.scatter_global(grid, torch.from_numpy(f), 0, halo_extents=he)
    jh = cd.scatter_global(jgrid, f, 0, halo_extents=he)
    for fn in ("cudecompUpdateHalosX",):
        got = getattr(cc, fn)(handle, grid, h, halo_extents=he,
                              halo_periods=(True, True, True))
        want = getattr(jc, fn)(None, jgrid, jh, halo_extents=he,
                               halo_periods=(True, True, True))
        assert got is h and np.array_equal(got.numpy(), np.asarray(want))
    pinfo = cc.cudecompGetPencilInfo(handle, grid, 0)
    assert pinfo.size == int(np.prod(pinfo.shape))
    assert cc.cudecompGetShiftedRank(handle, grid, 0, 1, 1, True) == 0
    assert cc.cudecompGetShiftedRank(handle, grid, 0, 1, 99, False) == -1
    assert cc.cudecompMalloc(handle, grid, 1024) is None
    assert cc.cudecompFree(handle, grid, None) is None
    cc.cudecompGridDescDestroy(handle, grid)
    cc.cudecompFinalize(handle)


def test_autotune_copies_config_back_one_rank():
    handle = cc.cudecompInit(device="cpu")
    config = cc.cudecompGridDescConfigSetDefaults()
    config.gdims, config.pdims = (16, 16, 16), (0, 0)
    options = cc.cudecompGridDescAutotuneOptionsSetDefaults()
    options.n_warmup_trials, options.n_trials = 0, 1
    options.autotune_transpose_backend = True
    options.disable_nccl_backends = True
    options.disable_nvshmem_backends = True
    grid = cc.cudecompGridDescCreate(handle, config, options)
    assert tuple(config.pdims) == tuple(grid.pdims) == (1, 1)
    assert config.transpose_comm_backend in (
        cc.CUDECOMP_TRANSPOSE_COMM_MPI_P2P,
        cc.CUDECOMP_TRANSPOSE_COMM_MPI_P2P_PL,
        cc.CUDECOMP_TRANSPOSE_COMM_MPI_A2A)
    rt = cc.cudecompGetGridDescConfig(handle, grid)
    assert tuple(rt.pdims) == tuple(grid.pdims)
    cc.cudecompFinalize(handle)


def test_per_op_payloads_translate_one_rank():
    options = cc.cudecompGridDescAutotuneOptionsSetDefaults()
    he = ((1, 1, 1),) * 4
    options.transpose_input_halo_extents = he
    options.transpose_output_halo_extents = he
    options.n_warmup_trials, options.n_trials = 0, 1
    native = cc._native_options(options)
    assert native.transpose_input_halo_extents == he
    config = cc.cudecompGridDescConfigSetDefaults()
    config.gdims, config.pdims = (16, 16, 16), (0, 0)
    grid = cc.cudecompGridDescCreate(cc.cudecompInit(device="cpu"), config,
                                     options)
    assert tuple(config.pdims) == tuple(grid.pdims)


def _shards(grid, arr, axis, he=None):
    local = jgeo.pencil_buffer_shape(grid.config, axis, he)
    return {tuple(int(c) for c in coords_of_shard_index(grid, axis, s.index,
                                                         local)):
            np.asarray(s.data) for s in arr.addressable_shards
            if getattr(s, "replica_id", 0) == 0}


def test_four_gloo_ranks_compat_flow_matches_jax(tmp_path):
    gdims = (16, 20, 24)
    f = np.random.default_rng(zlib.crc32(b"compat")).standard_normal(gdims)
    config = jc.cudecompGridDescConfigSetDefaults()
    config.gdims, config.pdims = gdims, (2, 2)
    config.transpose_comm_backend = jc.CUDECOMP_TRANSPOSE_COMM_MPI_A2A
    grid = jc.cudecompGridDescCreate(None, config, devices=jax.devices()[:4])
    assert grid.config.transpose_method == cd.TransposeMethod.ALL_TO_ALL
    shards = {}
    x = cd.scatter_global(grid, f, 0)
    for name, axis, fn in (("y", 1, "XToY"), ("z", 2, "YToZ"),
                           ("y2", 1, "ZToY"), ("x2", 0, "YToX")):
        x = getattr(jc, f"cudecompTranspose{fn}")(None, grid, x)
        shards[name] = _shards(grid, x, axis)
    he = (1, 1, 1)
    h = jc.cudecompUpdateHalosX(None, grid,
                                cd.scatter_global(grid, f, 0,
                                                  halo_extents=he),
                                halo_extents=he,
                                halo_periods=(True, True, True))
    shards["halo"] = _shards(grid, h, 0, he)
    case = dict(name="compat-2x2", kind="compat", gdims=gdims, field=f,
                config={}, shards=shards,
                queries=compat_queries(jc, None, grid))
    run_ranks(multirank_worker, 4, (4, str(tmp_path / "pg_init"), [case]),
              240, "the 4-rank compat run")


def test_backend_enum_mapping_one_rank():
    h = cc.cudecompInit(device="cpu")
    for be, m in cc._TRANSPOSE_BACKEND_MAP.items():
        config = cc.cudecompGridDescConfigSetDefaults()
        config.gdims, config.pdims = (8, 8, 8), (1, 1)
        config.transpose_comm_backend = be
        assert cc.cudecompGridDescCreate(h, config).config.transpose_method \
            == m
        assert m.value == jc._TRANSPOSE_BACKEND_MAP[be].value
    for be, m in cc._HALO_BACKEND_MAP.items():
        assert m.value == jc._HALO_BACKEND_MAP[be].value
    assert HaloMethod.PALLAS == cc._HALO_BACKEND_MAP[
        cc.CUDECOMP_HALO_COMM_NVSHMEM]
    assert TransposeMethod.PALLAS_A2A == cc._TRANSPOSE_BACKEND_MAP[
        cc.CUDECOMP_TRANSPOSE_COMM_NVSHMEM_SM]
