"""The four transposes of cudecomp_tpu_torch against cudecomp_tpu on a
``pdims (1, 1)`` grid (multi-rank grids: ``test_torch_slice.py``).

Pure data movement, so every output must be bit-equal to the gathered JAX
output, halo and padding regions included.  The JAX side runs its own
local-permute kernel (Pallas, interpret mode) on every op.
"""

import jax
import numpy as np
import pytest
import torch

import cudecomp_tpu as cd
from cudecomp_tpu.utils import testing as jtesting

import cudecomp_tpu_torch as ct
from cudecomp_tpu_torch.ops import transpose as ttr
from cudecomp_tpu_torch.utils import testing as T

OPS = [("x_to_y", 0, 1), ("y_to_z", 1, 2), ("z_to_y", 2, 1), ("y_to_x", 1, 0)]

LAYOUTS = {
    "natural": {},
    "axis_contiguous": dict(transpose_axis_contiguous=(True, True, True)),
    "mixed_ac": dict(transpose_axis_contiguous=(True, False, True)),
    "mem_order_a": dict(transpose_mem_order=((0, 1, 2), (2, 0, 1), (1, 0, 2))),
    "mem_order_b": dict(transpose_mem_order=((2, 1, 0), (0, 2, 1), (1, 2, 0))),
}


@pytest.fixture(autouse=True)
def jax_runs_its_kernel(monkeypatch):
    monkeypatch.setenv("CUDECOMP_TPU_LOCAL_PERMUTE", "pallas")
    monkeypatch.setenv("CUDECOMP_TPU_PALLAS_INTERPRET", "1")


def twin_grids(gdims, **kw):
    jcfg = cd.GridConfig(gdims=gdims, pdims=(1, 1), **kw)
    jgrid = cd.make_grid(jcfg, devices=jax.devices()[:1])
    tgrid = ct.make_grid(ct.GridConfig.from_dict(
        {k: getattr(jcfg, k) for k in jcfg.__dataclass_fields__}), "cpu")
    return jgrid, tgrid


def field(gdims, dtype, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal(gdims)
    if np.issubdtype(dtype, np.complexfloating):
        f = f + 1j * rng.standard_normal(gdims)
    return f.astype(dtype)


def walk_both(jgrid, tgrid, x_global, halos=None, pads=None, comp=None):
    """Run X->Y->Z->Y->X in both packages, comparing every output (whole
    local buffers) bit for bit.  ``halos``/``pads``: per pencil axis."""
    halos = halos or {0: None, 1: None, 2: None}
    pads = pads or {0: None, 1: None, 2: None}
    jbuf = cd.scatter_global(jgrid, x_global, 0, halo_extents=halos[0],
                             padding=pads[0])
    tbuf = ct.scatter_global(tgrid, x_global, 0, halo_extents=halos[0],
                             padding=pads[0])
    if comp is not None:   # trailing component dims: stack shifted copies
        jbuf = np.stack([np.asarray(jbuf) + k for k in range(comp)], -1)
        jbuf = jax.device_put(jbuf, jax.devices()[0])
        tbuf = torch.stack([tbuf + k for k in range(comp)], -1)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    for name, a_in, a_out in OPS:
        kw = dict(input_halo_extents=halos[a_in],
                  output_halo_extents=halos[a_out],
                  input_padding=pads[a_in], output_padding=pads[a_out])
        jbuf = getattr(cd, f"transpose_{name}")(jgrid, jbuf, **kw)
        tbuf = getattr(ct, f"transpose_{name}")(tgrid, tbuf, **kw)
        assert tuple(tbuf.shape) == tuple(jbuf.shape), name
        assert tbuf.is_contiguous()
        np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf),
                                      err_msg=name)
    return tbuf


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("gdims", [(8, 8, 8), (9, 10, 11)])
def test_four_ops_bit_equal(layout, gdims):
    jgrid, tgrid = twin_grids(gdims, **LAYOUTS[layout])
    x = T.global_index_field(gdims).numpy()
    back = walk_both(jgrid, tgrid, x)
    T.check_shards_match_pencil(tgrid, back, 0, torch.from_numpy(x))


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64,
                                   np.complex128])
@pytest.mark.parametrize("layout", ["axis_contiguous", "mem_order_b"])
def test_dtypes_bit_equal(dtype, layout):
    jgrid, tgrid = twin_grids((6, 7, 5), **LAYOUTS[layout])
    walk_both(jgrid, tgrid, field((6, 7, 5), dtype))


@pytest.mark.parametrize("layout", ["natural", "axis_contiguous",
                                    "mem_order_a"])
def test_halos_and_padding_bit_equal(layout):
    jgrid, tgrid = twin_grids((9, 10, 11), **LAYOUTS[layout])
    halos = {0: (1, 2, 0), 1: (0, 1, 1), 2: (2, 0, 1)}
    pads = {0: (0, 0, 2), 1: (1, 0, 0), 2: (0, 3, 0)}
    walk_both(jgrid, tgrid, field((9, 10, 11), np.float64), halos, pads)
    # output halo and padding regions are zero, the interior the field
    x = field((9, 10, 11), np.float64)
    buf = ct.scatter_global(tgrid, x, 0, halo_extents=halos[0],
                            padding=pads[0])
    out = ct.transpose_x_to_y(tgrid, buf, input_halo_extents=halos[0],
                              output_halo_extents=halos[1],
                              input_padding=pads[0], output_padding=pads[1])
    mask = ct.valid_interior_mask(tgrid, 1, halo_extents=halos[1],
                                  padding=pads[1])
    jmask = cd.valid_interior_mask(jgrid, 1, halo_extents=halos[1],
                                   padding=pads[1])
    np.testing.assert_array_equal(mask.numpy(), jmask)
    assert bool((out[~mask] == 0).all())
    got = ct.gather_global(tgrid, out, 1, halo_extents=halos[1],
                           padding=pads[1])
    np.testing.assert_array_equal(got.numpy(), x)


@pytest.mark.parametrize("comp", [1, 2, 3])
@pytest.mark.parametrize("layout", ["natural", "axis_contiguous"])
def test_component_dims_bit_equal(comp, layout):
    jgrid, tgrid = twin_grids((8, 6, 10), **LAYOUTS[layout])
    walk_both(jgrid, tgrid, field((8, 6, 10), np.float32), comp=comp)


@pytest.mark.parametrize("comp", [None, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.complex128])
def test_every_cyclic_net_permute_goes_to_k1(monkeypatch, comp, dtype):
    # the dispatch does not depend on the element's size: a 12- or 48-byte
    # element reaches K1's wrapper like a 4-byte one
    seen = []
    real = ttr.cuda_kernels.cyclic_permute

    def spy(x, perm):
        seen.append((perm, ttr.cuda_kernels.element_bytes(x, 3)))
        return real(x, perm)

    monkeypatch.setattr(ttr.cuda_kernels, "cyclic_permute", spy)
    jgrid, tgrid = twin_grids((8, 6, 10), **LAYOUTS["axis_contiguous"])
    walk_both(jgrid, tgrid, field((8, 6, 10), dtype), comp=comp)
    eb = np.dtype(dtype).itemsize * (comp or 1)
    assert seen == [((1, 2, 0), eb)] * 2 + [((2, 0, 1), eb)] * 2


def test_component_dims_with_halos():
    jgrid, tgrid = twin_grids((8, 6, 10), **LAYOUTS["axis_contiguous"])
    halos = {0: (1, 1, 1), 1: (0, 2, 0), 2: (1, 0, 1)}
    walk_both(jgrid, tgrid, field((8, 6, 10), np.float64), halos=halos,
              comp=2)


@pytest.mark.parametrize("method", list(cd.TransposeMethod))
def test_every_method_runs_without_exchange(method):
    # with one rank the slab path never exchanges, so every method works
    jgrid, tgrid = twin_grids((8, 9, 10), **LAYOUTS["axis_contiguous"])
    x = T.global_index_field((8, 9, 10))
    buf = ct.scatter_global(tgrid, x, 0)
    y = ct.transpose_x_to_y(tgrid, buf, method=method.value)
    jy = cd.transpose_x_to_y(jgrid, cd.scatter_global(jgrid, x.numpy(), 0),
                             method=method)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    back = ct.transpose_y_to_x(tgrid, y,
                               method=ct.TransposeMethod(method.value))
    assert torch.equal(back, buf)


def test_global_index_oracle_every_pencil():
    _, tgrid = twin_grids((9, 10, 11), **LAYOUTS["mem_order_b"])
    x = T.global_index_field((9, 10, 11))
    jx = jtesting.global_index_field((9, 10, 11))
    np.testing.assert_array_equal(x.numpy(), jx)
    buf = ct.scatter_global(tgrid, x, 0)
    for name, _, a_out in OPS:
        buf = getattr(ct, f"transpose_{name}")(tgrid, buf)
        T.check_shards_match_pencil(tgrid, buf, a_out, x)
        assert torch.equal(ct.gather_global(tgrid, buf, a_out), x)
    with pytest.raises(AssertionError):
        T.check_shards_match_pencil(tgrid, buf + 1, 0, x)


def test_net_perm_matches_jax():
    from cudecomp_tpu.ops.transpose import _net_perm as jax_net_perm
    for layout in LAYOUTS.values():
        jgrid, tgrid = twin_grids((8, 8, 8), **layout)
        for _, a, b in OPS:
            assert (ttr._net_perm(tgrid.config, a, b - a)
                    == jax_net_perm(jgrid.config, a, b - a))


def test_input_validation():
    _, tgrid = twin_grids((8, 9, 10))
    with pytest.raises(ValueError, match="does not match"):
        ct.transpose_x_to_y(tgrid, torch.zeros(7, 9, 10))
    with pytest.raises(ValueError, match="does not match"):
        ct.transpose_x_to_y(tgrid, torch.zeros(8, 9))
    with pytest.raises(ValueError, match="does not match"):
        ct.transpose_y_to_z(tgrid, torch.zeros(8, 9, 10),
                            input_halo_extents=(1, 0, 0))
    with pytest.raises(ValueError, match="unknown transpose method"):
        ct.transpose_x_to_y(tgrid, torch.zeros(8, 9, 10), method="carrier")
    with pytest.raises(ValueError, match="nonnegative"):
        ct.transpose_x_to_y(tgrid, torch.zeros(8, 9, 10),
                            output_padding=(0, -1, 0))
    # trailing component dims are allowed
    assert ct.transpose_x_to_y(tgrid, torch.zeros(8, 9, 10, 3)).shape == (
        8, 9, 10, 3)


def test_plan_cache_and_clear():
    _, tgrid = twin_grids((8, 9, 10), **LAYOUTS["axis_contiguous"])
    ct.clear_plan_caches()
    buf = torch.zeros(tgrid.buffer_shape(0))
    ct.transpose_x_to_y(tgrid, buf)
    ct.transpose_x_to_y(tgrid, buf)
    info = ttr._build_transpose_fn.cache_info()
    assert info.currsize == 1 and info.hits == 1
    ct.finalize()
    assert ttr._build_transpose_fn.cache_info().currsize == 0


def test_identity_transpose_returns_data_unchanged():
    # natural layout, one rank: X->Y moves nothing
    _, tgrid = twin_grids((4, 5, 6))
    buf = torch.randn(tgrid.buffer_shape(0))
    out = ct.transpose_x_to_y(tgrid, buf)
    assert torch.equal(out, buf)
    out_h = ct.transpose_x_to_y(tgrid, buf, output_halo_extents=(1, 0, 0))
    assert out_h.shape == (6, 5, 6)
    assert torch.equal(out_h[1:5], buf)
