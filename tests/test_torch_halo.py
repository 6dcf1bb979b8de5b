"""The halo engine of cudecomp_tpu_torch against the JAX package: the same
global field, scattered by both packages, comes out of ``update_halos``
bit for bit equal, and equal to the JAX package's host oracle
``expected_halo_buffer``.  One rank here; the 4-rank cases run in
``test_torch_slice.py``."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudecomp_tpu as cd
from cudecomp_tpu.utils import testing as T

import cudecomp_tpu_torch as ct
from cudecomp_tpu_torch.ops import halo as H

GDIMS = (12, 10, 14)
PERIODS = {"periodic": (True, True, True),
           "non-periodic": (False, False, False),
           "mixed": (True, False, True)}


def grids(gdims=GDIMS, **kw):
    jg = cd.make_grid(cd.GridConfig(gdims=gdims, pdims=(1, 1), **kw),
                      devices=jax.devices()[:1])
    tg = ct.make_grid(ct.GridConfig(gdims=gdims, pdims=(1, 1), **kw), "cpu")
    return jg, tg


def field(gdims=GDIMS, seed=0):
    return np.random.default_rng(seed).standard_normal(gdims)


def run(axis, he, periods, dim=None, padding=None, **kw):
    jg, tg = grids(**kw)
    x = field()
    jbuf = cd.scatter_global(jg, x, axis, halo_extents=he, padding=padding)
    want = np.asarray(cd.update_halos(jg, jbuf, axis, he, periods, dim=dim,
                                      padding=padding))
    buf = ct.scatter_global(tg, x, axis, halo_extents=he, padding=padding)
    got = ct.update_halos(tg, buf, axis, he, periods, dim=dim,
                          padding=padding)
    assert got is buf  # written in place
    np.testing.assert_array_equal(got.numpy(), want)
    return x, jg, got


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("periods", list(PERIODS))
def test_all_dims_bit_equal_to_jax_and_oracle(axis, periods):
    he = (1, 2, 3)
    x, jg, got = run(axis, he, PERIODS[periods])
    want = T.expected_halo_buffer(jg, axis, x, he, PERIODS[periods],
                                  [0, 1, 2])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_one_dim(dim):
    he = (2, 1, 3)
    x, jg, got = run(1, he, PERIODS["mixed"], dim=dim)
    want = T.expected_halo_buffer(jg, 1, x, he, PERIODS["mixed"], [dim])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_axis_contiguous_layout(axis):
    run(axis, (1, 2, 1), PERIODS["mixed"],
        transpose_axis_contiguous=(True, True, True))


def test_padding_and_explicit_memory_order():
    run(2, (1, 1, 2), PERIODS["periodic"], padding=(1, 0, 2),
        transpose_mem_order=((2, 1, 0), (0, 2, 1), (1, 2, 0)))


@pytest.mark.parametrize("periods", ["periodic", "non-periodic"])
def test_trailing_component_dims(periods):
    # a 3-component field: every component sees the scalar update
    jg, tg = grids()
    rng = np.random.default_rng(3)
    x = rng.standard_normal(GDIMS + (3,))
    he = (1, 1, 2)
    p = PERIODS[periods]
    jbuf = jnp.stack([cd.scatter_global(jg, x[..., c], 0, halo_extents=he)
                      for c in range(3)], axis=-1)
    want = np.asarray(cd.update_halos(jg, jbuf, 0, he, p))
    buf = torch.stack([ct.scatter_global(tg, x[..., c], 0, halo_extents=he)
                       for c in range(3)], dim=-1)
    got = ct.update_halos(tg, buf, 0, he, p)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pallas_method_takes_the_plain_path_on_one_rank():
    # at P = 1 no exchange runs, so K3 never would: the self-copy serves
    x, _, want = run(0, (1, 1, 1), PERIODS["periodic"])
    tg = ct.make_grid(ct.GridConfig(gdims=GDIMS, pdims=(1, 1),
                                    halo_method=ct.HaloMethod.PALLAS), "cpu")
    buf = ct.scatter_global(tg, x, 0, halo_extents=(1, 1, 1))
    out = ct.update_halos(tg, buf, 0, (1, 1, 1), PERIODS["periodic"])
    assert torch.equal(out, want)


def test_pallas_method_across_ranks_raises_on_a_cuda_tensor(monkeypatch):
    # off the CPU the exchange is K3's, never its plain ring: a tensor K3
    # cannot take raises before any send or launch (the dispatch is
    # inspected with a meta tensor and a two-rank group that is never used)
    from cudecomp_tpu_torch.ops import peer_kernels

    def ring(*a, **k):
        raise AssertionError("HaloMethod.PALLAS took the plain ring")

    monkeypatch.setattr(H, "halo_ring", ring)
    monkeypatch.setattr(peer_kernels.dist, "get_world_size", lambda g: 2)
    monkeypatch.setattr(peer_kernels.dist, "get_rank", lambda g: 0)
    cfg = ct.GridConfig(gdims=(8, 8, 8), pdims=(2, 1),
                        halo_method=ct.HaloMethod.PALLAS)
    grid = types.SimpleNamespace(config=cfg, axis_names=("pr", "pc"),
                                 group=lambda name: object())
    arr = torch.empty((10, 6, 10), device="meta")
    with pytest.raises(ValueError, match="K3 runs on CUDA tensors"):
        H._update_dim(grid, arr, 1, True, 1, 1, 4, 0, 2, (4, 4))


def test_zero_halo_and_donate_are_no_ops():
    jg, tg = grids()
    buf = ct.scatter_global(tg, field(), 0)
    before = buf.clone()
    assert ct.update_halos(tg, buf, 0, (0, 0, 0), (True,) * 3) is buf
    assert torch.equal(buf, before)
    he = (1, 1, 1)
    a = ct.scatter_global(tg, field(), 0, halo_extents=he)
    b = a.clone()
    ct.update_halos(tg, a, 0, he, (True,) * 3, donate=True)
    ct.update_halos(tg, b, 0, he, (True,) * 3)
    assert torch.equal(a, b)


def test_errors():
    _, tg = grids()
    he = (1, 1, 1)
    buf = ct.scatter_global(tg, field(), 0, halo_extents=he)
    with pytest.raises(ValueError, match="does not match pencil layout"):
        ct.update_halos(tg, buf[1:], 0, he, (True,) * 3)
    with pytest.raises(ValueError, match="does not match pencil layout"):
        ct.update_halos(tg, buf, 0, (1, 1, 2), (True,) * 3)
    with pytest.raises(ValueError, match="halo_periods"):
        ct.update_halos(tg, buf, 0, he, (True, True))
    with pytest.raises(ValueError, match="dim out of range"):
        ct.update_halos(tg, buf, 0, he, (True,) * 3, dim=3)
    with pytest.raises(ValueError, match="axis out of range"):
        ct.update_halos(tg, buf, 3, he, (True,) * 3)
    # a halo wider than the dim's extent, before any halo is written
    wide = (1, 11, 1)
    big = ct.scatter_global(tg, field(), 0, halo_extents=wide)
    before = big.clone()
    with pytest.raises(ValueError, match="exceeds smallest pencil extent"):
        ct.update_halos(tg, big, 0, wide, (True,) * 3)
    assert torch.equal(big, before)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_scatter_fill_halos_matches_jax(axis):
    jg, tg = grids(transpose_axis_contiguous=(True, False, True))
    x = field(seed=4)
    he = (2, 1, 3)
    want = np.asarray(cd.scatter_global(jg, x, axis, halo_extents=he,
                                        fill_halos=True))
    got = ct.scatter_global(tg, x, axis, halo_extents=he, fill_halos=True)
    np.testing.assert_array_equal(got.numpy(), want)
    # a periodic update of the filled buffer changes nothing
    again = ct.update_halos(tg, got.clone(), axis, he, (True,) * 3)
    assert torch.equal(again, got)


@pytest.mark.parametrize("P", [2, 3, 4])
@pytest.mark.parametrize("periodic", [True, False])
def test_neighbour_pairs(P, periodic):
    # the shifts of the halo engine and of both ghost exchanges: j -> j+1
    # and j -> j-1, with the wrap pairs only on a periodic dim, so that the
    # edge ranks of a non-periodic dim receive nothing (zeros)
    from cudecomp_tpu_torch.parallel.collectives import neighbour_pairs
    up, down = neighbour_pairs(P, periodic)
    wrap = P if periodic else P - 1
    assert sorted(up) == sorted((j, (j + 1) % P) for j in range(wrap))
    assert sorted(down) == sorted(((j + 1) % P, j) for j in range(wrap))
    assert sorted(d for _, d in up) == sorted(s for s, _ in down)
    if not periodic:
        assert 0 not in [d for _, d in up] and P - 1 not in [d for _, d in down]
