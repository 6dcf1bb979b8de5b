"""Gradients of the port against ``jax.grad`` of the JAX package on the
same seeded numpy inputs and cotangents: every transpose method (even and
uneven, with halos and padding) and ``update_halos`` bit for bit, the
distributed FFTs to 1e-10 in float64, at ``pdims (1, 1)`` and on 4 (and 3)
gloo ranks against the JAX shards of a 4-device CPU mesh; and the backward
formulas of K1's and K5's autograd Functions on the CPU.

Convention: torch's gradient of a real loss at a complex input is the
conjugate of JAX's (``jax.grad`` returns ``dL/dx - i dL/dy``); the JAX side
conjugates before the comparison.
"""

import dataclasses
import enum
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudecomp_tpu as cd
from cudecomp_tpu import geometry as jgeo
from cudecomp_tpu.ops.fft import DistributedFFT as JFFT
from cudecomp_tpu.utils.arrays import coords_of_shard_index

import cudecomp_tpu_torch as ct
from cudecomp_tpu_torch.ops import cuda_kernels as K
from cudecomp_tpu_torch.ops import dft2 as D
from cudecomp_tpu_torch.ops.fft import DistributedFFT as TFFT
from cudecomp_tpu_torch.utils.testing import (_grad_of, multirank_worker,
                                              run_ranks)

_OPS = (("x_to_y", 0, 1), ("y_to_z", 1, 2), ("z_to_y", 2, 1),
        ("y_to_x", 1, 0))


def _spec(jcfg):
    return {k: (v.value if isinstance(v, enum.Enum) else v)
            for k, v in dataclasses.asdict(jcfg).items()}


def _jgrid(**kw):
    jcfg = cd.GridConfig(**kw)
    n = jcfg.pdims[0] * jcfg.pdims[1]
    return jcfg, cd.make_grid(jcfg, devices=jax.devices()[:n])


def _shards(grid, arr, axis, he=None, pad=None):
    """{(pr, pc): numpy local tensor} of a JAX pencil buffer."""
    local = jgeo.pencil_buffer_shape(grid.config, axis, he, pad)
    out = {}
    for s in arr.addressable_shards:
        if getattr(s, "replica_id", 0) != 0:
            continue
        coords = coords_of_shard_index(grid, axis, s.index, local)
        out[tuple(int(c) for c in coords)] = np.asarray(s.data)
    return out


def _buffer(rng, grid, axis, he=None, pad=None):
    """A random global buffer of the pencil layout, halos and padding
    included, on the grid's sharding."""
    a = rng.standard_normal(grid.global_shape(axis, halo_extents=he,
                                              padding=pad))
    return jax.device_put(a, grid.sharding(axis))


def _field(rng, grid, axis, cplx=False):
    """A random global field scattered into the pencil layout (zeros in
    the padding slots)."""
    f = rng.standard_normal(grid.config.gdims)
    if cplx:
        f = f + 1j * rng.standard_normal(grid.config.gdims)
    return cd.scatter_global(grid, f, axis)


def _vjp_real(fn, x, c):
    """``jax.grad`` of ``<c, fn(x)>`` (the real inner product), conjugated
    for a complex ``x`` into torch's convention."""
    def loss(v):
        out, cts = fn(v), c
        if not isinstance(out, tuple):
            out, cts = (out,), (c,)
        return sum(jnp.sum(jnp.real(jnp.conj(w) * o))
                   for o, w in zip(out, cts))
    g = jax.grad(loss)(x)
    return jnp.conj(g) if jnp.iscomplexobj(g) else g


def _transpose_case(name, method, he, pad, hosts=None, **kw):
    jcfg, grid = _jgrid(transpose_method=method, **kw)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    opkw = dict(input_halo_extents=he, output_halo_extents=he,
                input_padding=pad, output_padding=pad)
    shards = {}
    for op, a_in, a_out in _OPS:
        fn = getattr(cd, f"transpose_{op}")
        x = _buffer(rng, grid, a_in, he, pad)
        c = _buffer(rng, grid, a_out, he, pad)
        g = _vjp_real(lambda v: fn(grid, v, **opkw), x, c)
        shards[f"in_{op}"] = _shards(grid, x, a_in, he, pad)
        shards[f"ct_{op}"] = _shards(grid, c, a_out, he, pad)
        shards[f"grad_{op}"] = _shards(grid, g, a_in, he, pad)
    return dict(name=name, kind="grad_transpose", config=_spec(jcfg),
                halo_extents=he, padding=pad, hosts=hosts, shards=shards)


def _halo_case(name, axis, he, periods, **kw):
    jcfg, grid = _jgrid(**kw)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    x = _buffer(rng, grid, axis, he)
    c = _buffer(rng, grid, axis, he)

    def fn(v):
        return cd.update_halos(grid, v, axis, he, periods)

    g1 = jax.grad(lambda v: jnp.sum(fn(v)))(x)
    values = sorted(set(np.asarray(g1).ravel().tolist()))
    return dict(name=name, kind="grad_halo", config=_spec(jcfg), axis=axis,
                halo_extents=he, periods=periods, adjoint_values=values,
                shards={"in": _shards(grid, x, axis, he),
                        "ct": _shards(grid, c, axis, he),
                        "grad": _shards(grid, _vjp_real(fn, x, c), axis,
                                        he)})


def _fft_case(name, **kw):
    jcfg, grid = _jgrid(**kw)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    plan = JFFT(grid=grid)
    rplan = JFFT(grid=grid, real=True)
    pplan = JFFT(grid=grid, split_complex=True)
    cgrid = rplan.complex_grid
    sh = {}

    def put(key, arr, g, axis):
        sh[key] = _shards(g, arr, axis)

    def case(tag, fn, x, g_in, a_in, c, g_out, a_out):
        put(f"{tag}_in", x, g_in, a_in)
        put(f"{tag}_ct", c, g_out, a_out)
        put(f"{tag}_grad", _vjp_real(fn, x, c), g_in, a_in)

    case("c", plan.forward, _field(rng, grid, 0, True), grid, 0,
         _field(rng, grid, 2, True), grid, 2)
    case("ci", plan.inverse, _field(rng, grid, 2, True), grid, 2,
         _field(rng, grid, 0, True), grid, 0)
    case("r", rplan.forward, _field(rng, grid, 0), grid, 0,
         _field(rng, cgrid, 2, True), cgrid, 2)
    case("ri", rplan.inverse, _field(rng, cgrid, 2, True), cgrid, 2,
         _field(rng, grid, 0), grid, 0)
    pr, pi = _field(rng, grid, 0), _field(rng, grid, 0)
    cr, ci = _field(rng, grid, 2), _field(rng, grid, 2)
    for key, v in (("p_in_r", pr), ("p_in_i", pi)):
        put(key, v, grid, 0)
    for key, v in (("p_ct_r", cr), ("p_ct_i", ci)):
        put(key, v, grid, 2)
    put("p_grad_r", _vjp_real(lambda v: pplan.forward_planes((v, pi)), pr,
                              (cr, ci)), grid, 0)
    put("p_grad_i", _vjp_real(lambda v: pplan.forward_planes((pr, v)), pi,
                              (cr, ci)), grid, 0)
    # the inverse planes take the spectral (z-pencil) layout: same cases
    zr, zi = _field(rng, grid, 2), _field(rng, grid, 2)
    xr, xi = _field(rng, grid, 0), _field(rng, grid, 0)
    put("pi_in_r", zr, grid, 2)
    put("pi_in_i", zi, grid, 2)
    put("pi_ct_r", xr, grid, 0)
    put("pi_ct_i", xi, grid, 0)
    put("pi_grad_r", _vjp_real(lambda v: pplan.inverse_planes((v, zi)), zr,
                               (xr, xi)), grid, 2)
    return dict(name=name, kind="grad_fft", config=_spec(jcfg), shards=sh)


_METHODS = ("all_to_all", "ring", "ring_xor", "ring_hier", "ring_pipelined",
            "pallas_a2a")
_SHAPES = (((8, 8, 8), (2, 2), ((1, 1, 2), (2, 0, 1))),
           ((9, 10, 11), (1, 4), ((2, 1, 1), (0, 3, 1))),
           ((9, 10, 11), (4, 1), None),
           ((8, 12, 10), (2, 2), None))


def test_four_gloo_ranks_gradients_match_jax(tmp_path):
    cases = []
    for m, method in enumerate(_METHODS):
        for k in (0, 1):
            gdims, pdims, payload = _SHAPES[(m + k) % 4]
            he, pad = payload or ((0, 0, 0), (0, 0, 0))
            cases.append(_transpose_case(
                f"grad-{method}-{pdims[0]}x{pdims[1]}-{gdims[0]}", method,
                he, pad, hosts=("h0", "h0", "h1", "h1"), gdims=gdims,
                pdims=pdims))
    # a (4, 6, 8) field with width-1 periodic halos on every dim: the
    # adjoint of sum(out) takes the values {0, 1, 2, 4, 8}
    cases += [
        _halo_case("grad-halo-periodic-2x2", 0, (1, 1, 1), (True,) * 3,
                   gdims=(4, 6, 8), pdims=(2, 2)),
        _halo_case("grad-halo-open-1x4", 1, (1, 2, 1), (False, True, False),
                   gdims=(9, 10, 11), pdims=(1, 4)),
        _halo_case("grad-halo-mixed-4x1-ac", 2, (2, 1, 1),
                   (True, False, True), gdims=(9, 10, 11), pdims=(4, 1),
                   transpose_axis_contiguous=(True, True, True)),
        _fft_case("grad-fft-2x2", gdims=(8, 8, 8), pdims=(2, 2)),
        _fft_case("grad-fft-uneven-1x4-ac", gdims=(9, 10, 11), pdims=(1, 4),
                  transpose_axis_contiguous=(True, True, True)),
    ]
    assert cases[len(_METHODS) * 2]["adjoint_values"] == [0, 1, 2, 4, 8]
    run_ranks(multirank_worker, 4, (4, str(tmp_path / "pg_init"), cases),
              300, "the 4-rank gradient run")


def test_three_gloo_ranks_ring_xor_gradients_match_jax(tmp_path):
    # P = 3: ring_xor takes the increment ring; hosts (a, a, b) group
    # unevenly, so ring_hier runs flat
    cases = [
        _transpose_case("grad-ring_xor-1x3", "ring_xor", (1, 0, 1),
                        (0, 1, 0), gdims=(9, 10, 11), pdims=(1, 3)),
        _transpose_case("grad-ring_xor-3x1", "ring_xor", (0, 0, 0),
                        (0, 0, 0), gdims=(9, 10, 11), pdims=(3, 1)),
        _transpose_case("grad-ring_hier-3x1", "ring_hier", (1, 1, 0),
                        (0, 0, 2), hosts=("a", "a", "b"), gdims=(8, 9, 7),
                        pdims=(3, 1)),
    ]
    run_ranks(multirank_worker, 3, (3, str(tmp_path / "pg_init"), cases),
              300, "the 3-rank gradient run")


# -- pdims (1, 1), in this process -----------------------------------------------

_LAYOUTS = {
    "natural": {},
    "axis_contiguous": dict(transpose_axis_contiguous=(True, True, True)),
    "mem_order": dict(transpose_mem_order=((2, 1, 0), (0, 2, 1), (1, 2, 0))),
}


def _local(case, key):
    return torch.from_numpy(np.array(case["shards"][key][(0, 0)]))


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
def test_one_rank_transpose_and_halo_gradients_match_jax(layout):
    he, pad = (1, 2, 1), (0, 1, 2)
    case = _transpose_case(f"p1-{layout}", "all_to_all", he, pad,
                           gdims=(6, 7, 8), pdims=(1, 1), **_LAYOUTS[layout])
    grid = ct.make_grid(ct.GridConfig.from_dict(case["config"]), "cpu")
    kw = dict(input_halo_extents=he, output_halo_extents=he,
              input_padding=pad, output_padding=pad)
    for op, _, _ in _OPS:
        fn = getattr(ct, f"transpose_{op}")
        got = _grad_of(lambda v: fn(grid, v, **kw), _local(case, f"in_{op}"),
                       _local(case, f"ct_{op}"))
        assert torch.equal(got, _local(case, f"grad_{op}")), op
    h = _halo_case(f"p1-halo-{layout}", 1, (1, 2, 1), (True, False, True),
                   gdims=(6, 7, 8), pdims=(1, 1), **_LAYOUTS[layout])

    def run(v):
        return ct.update_halos(grid, v.clone(), 1, (1, 2, 1),
                               (True, False, True))

    assert torch.equal(_grad_of(run, _local(h, "in"), _local(h, "ct")),
                       _local(h, "grad"))


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
def test_one_rank_fft_gradients_match_jax(layout):
    case = _fft_case(f"p1-fft-{layout}", gdims=(6, 8, 10), pdims=(1, 1),
                     **_LAYOUTS[layout])
    grid = ct.make_grid(ct.GridConfig.from_dict(case["config"]), "cpu")
    plan, rplan = TFFT(grid=grid), TFFT(grid=grid, real=True)
    pplan = TFFT(grid=grid, split_complex=True)

    def close(got, key):
        np.testing.assert_allclose(got.numpy(), case["shards"][key][(0, 0)],
                                   rtol=0, atol=1e-10)

    for tag, fn in (("c", plan.forward), ("ci", plan.inverse),
                    ("r", rplan.forward), ("ri", rplan.inverse)):
        close(_grad_of(fn, _local(case, f"{tag}_in"),
                       _local(case, f"{tag}_ct")), f"{tag}_grad")
    pr, pi = _local(case, "p_in_r"), _local(case, "p_in_i")
    cts = (_local(case, "p_ct_r"), _local(case, "p_ct_i"))
    close(_grad_of(lambda v: pplan.forward_planes((v, pi)), pr, cts),
          "p_grad_r")
    close(_grad_of(lambda v: pplan.forward_planes((pr, v)), pi, cts),
          "p_grad_i")
    zi = _local(case, "pi_in_i")
    close(_grad_of(lambda v: pplan.inverse_planes((v, zi)),
                   _local(case, "pi_in_r"),
                   (_local(case, "pi_ct_r"), _local(case, "pi_ct_i"))),
          "pi_grad_r")


def test_fused2_plan_gradients_match_cufft_path():
    # a split-complex plan with K5 for the (1, 2) pair (its plain version
    # on the CPU) against the same plan on torch.fft alone
    grid = ct.make_grid(ct.GridConfig(gdims=(4, 8, 128), pdims=(1, 1)),
                        "cpu")
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(grid.buffer_shape(0) + (2,), generator=gen,
                    dtype=torch.float64)
    c = torch.randn(grid.buffer_shape(2) + (2,), generator=gen,
                    dtype=torch.float64)
    grads = {}
    for fused2 in (False, True):
        plan = TFFT(grid=grid, split_complex=True, fused2=fused2)
        grads[fused2] = (_grad_of(plan.forward, x, c),
                         _grad_of(plan.inverse, c, x))
    for a, b in zip(grads[False], grads[True]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-10)


# -- the kernels' autograd Functions ----------------------------------------------

@pytest.mark.parametrize("perm", K.CYCLIC_PERMS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_cyclic_permute_backward_is_the_inverse_permute(perm, dtype):
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((3, 4, 5, 2), generator=gen, dtype=dtype)
    c = torch.randn(K.cyclic_permute(x, perm).shape, generator=gen,
                    dtype=dtype)
    a = x.clone().requires_grad_(True)
    out = K.cyclic_permute(a, perm)
    assert out.grad_fn is not None and "CyclicPermute" in type(
        out.grad_fn).__name__
    (got,) = torch.autograd.grad(out, a, c)
    b = x.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(
        b.permute(perm + (3,)).contiguous(), b, c)
    assert torch.equal(got, want)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape", [(3, 8, 128), (2, 16, 256), (2, 5, 6)])
def test_dft2_backward_matches_torch_fft(inverse, shape):
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(shape, generator=gen, dtype=torch.complex128)
    c = torch.randn(shape, generator=gen, dtype=torch.complex128)
    a = x.clone().requires_grad_(True)
    out = D.dft2(a, inverse)
    assert "Dft2" in type(out.grad_fn).__name__
    (got,) = torch.autograd.grad(out, a, c)
    b = x.clone().requires_grad_(True)
    fn = torch.fft.ifftn if inverse else torch.fft.fftn
    (want,) = torch.autograd.grad(fn(b, dim=(1, 2)), b, c)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-12 * np.abs(want.numpy()).max())
    # the backward is one transform of the other direction: no grad graph
    assert not got.requires_grad


def test_no_grad_calls_take_no_autograd_function():
    x = torch.randn((2, 8, 128), dtype=torch.complex64, requires_grad=True)
    with torch.no_grad():
        assert D.dft2(x).grad_fn is None
        assert K.cyclic_permute(x, (1, 2, 0)).grad_fn is None


# -- refusals in backward ----------------------------------------------------------

def test_backward_keeps_the_cuda_over_gloo_refusal(monkeypatch):
    # the backward passes run the same raw exchanges, which refuse a
    # tensor off the CPU over a gloo group, as the forward passes do
    from functools import partial
    from types import SimpleNamespace

    from cudecomp_tpu_torch.config import CannotRun
    from cudecomp_tpu_torch.parallel import collectives as C
    monkeypatch.setattr(C.dist, "get_backend", lambda g=None: "gloo")
    grad = torch.empty((4, 3), device="meta")
    ctx = SimpleNamespace(run=partial(C._all_to_all, group=object()))
    with pytest.raises(CannotRun, match="all_to_all of a meta tensor"):
        C._SelfAdjoint.backward(ctx, grad)
    ctx = SimpleNamespace(group=object(), pairs=((0, 1), (1, 0)))
    with pytest.raises(CannotRun, match="ppermute of a meta tensor"):
        C._PPermute.backward(ctx, grad)


def test_pallas_halo_with_grad_raises_naming_ppermute():
    from types import SimpleNamespace

    from cudecomp_tpu_torch.config import HaloMethod
    from cudecomp_tpu_torch.ops import halo as H
    grid = SimpleNamespace(config=SimpleNamespace(
        halo_method=HaloMethod.PALLAS), axis_names=("pr", "pc"),
        group=lambda name: None)
    arr = torch.empty((6, 4), device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="HaloMethod.PPERMUTE"):
        H._update_dim(grid, arr, 0, True, 0, 1, 4, 0, 2, (4, 4))
