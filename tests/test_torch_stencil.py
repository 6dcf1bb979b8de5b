"""The ghost-plane stencil path of cudecomp_tpu_torch against the JAX
package: ``halo_map``, ``stencil_apply``, ``laplacian7``,
``diffusion_step`` and the gradients agree to 1e-12 in float64 with JAX's
generic path and with its Pallas kernel run in interpret mode.  K4's
plain version (``stencil27_ref``) serves every CPU tensor; its meaning is
pinned here against an explicit definition.  One rank here; the 4-rank
cases run in ``test_torch_slice.py``."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudecomp_tpu as cd

import cudecomp_tpu_torch as ct
from cudecomp_tpu_torch.ops import stencil as st
from cudecomp_tpu_torch.ops import stencil_kernel as S

ATOL = 1e-12
PERIODS = {"periodic": (True, True, True),
           "non-periodic": (False, False, False),
           "mixed": (True, False, True),
           "x-dirichlet": (False, True, True)}


def grids(gdims=(12, 10, 14), **kw):
    jg = cd.make_grid(cd.GridConfig(gdims=gdims, pdims=(1, 1), **kw),
                      devices=jax.devices()[:1])
    tg = ct.make_grid(ct.GridConfig(gdims=gdims, pdims=(1, 1), **kw), "cpu")
    return jg, tg


def fields(jg, tg, axis=0, seed=0, n=1):
    """``n`` standard-normal global fields as (jax, torch) pencil pairs."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.standard_normal(tg.config.gdims)
        out.append((cd.scatter_global(jg, x, axis),
                    ct.scatter_global(tg, x, axis)))
    return out


def face7():
    w = np.zeros((3, 3, 3))
    w[1, 1, 1] = -6.0
    for o in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
              (1, 1, 2)):
        w[o] = 1.0
    return w


def weights(kind, seed=1):
    return face7() if kind == "face7" else (
        np.random.default_rng(seed).standard_normal((3, 3, 3)))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("gdims", [(12, 10, 14), (9, 10, 11)])
@pytest.mark.parametrize("periods", list(PERIODS))
@pytest.mark.parametrize("wkind", ["face7", "dense"])
def test_stencil_apply_matches_jax(gdims, periods, wkind):
    jg, tg = grids(gdims)
    [(ju, tu)] = fields(jg, tg)
    w = weights(wkind)
    before = S.launch_count
    got = ct.stencil_apply(tg, tu, w, 0, PERIODS[periods])
    assert S.launch_count == before  # CPU tensors take the plain version
    close(got, cd.stencil_apply(jg, ju, w, 0, PERIODS[periods]))


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("periods", ["periodic", "mixed"])
def test_pencil_axes_and_axis_contiguous_layout(axis, periods):
    jg, tg = grids(transpose_axis_contiguous=(True, True, True))
    [(ju, tu)] = fields(jg, tg, axis)
    w = weights("dense", seed=2)
    p = PERIODS[periods]
    close(ct.stencil_apply(tg, tu, w, axis, p),
          cd.stencil_apply(jg, ju, w, axis, p))
    close(ct.laplacian7(tg, tu, axis, p), cd.laplacian7(jg, ju, axis, p))


@pytest.mark.parametrize("periods", list(PERIODS))
def test_laplacian7_and_diffusion_step_match_jax(periods):
    jg, tg = grids((9, 10, 11))
    [(ju, tu)] = fields(jg, tg, seed=3)
    p = PERIODS[periods]
    close(ct.laplacian7(tg, tu, 0, p), cd.laplacian7(jg, ju, 0, p))
    close(ct.diffusion_step(tg, tu, 0.1, 0, p),
          cd.diffusion_step(jg, ju, 0.1, 0, p))
    # a tensor dt takes the two-pass form, as a traced dt does in JAX
    traced = jax.jit(lambda v, d: cd.diffusion_step(jg, v, d, 0, p))
    close(ct.diffusion_step(tg, tu, torch.tensor(0.1, dtype=torch.float64),
                            0, p), traced(ju, 0.1))


@pytest.mark.parametrize("case", [("periodic", "dense"),
                                  ("x-dirichlet", "dense"),
                                  ("non-periodic", "face7")])
def test_matches_jax_pallas_kernel_in_interpret_mode(case, monkeypatch):
    # the JAX side runs its Mosaic kernel (interpret mode), not its generic
    # path: the fallback is poisoned for these tap sets
    from cudecomp_tpu.ops import stencil as jst

    def no_fallback(*a, **k):
        raise AssertionError("the JAX stencil took its halo_map fallback")

    monkeypatch.setenv("CUDECOMP_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jst, "halo_map", no_fallback)
    periods, wkind = case
    jg, tg = grids()
    [(ju, tu)] = fields(jg, tg, seed=4)
    w = weights(wkind, seed=5)
    p = PERIODS[periods]
    jst._stencil_apply_fn.cache_clear()
    try:
        close(ct.stencil_apply(tg, tu, w, 0, p),
              cd.stencil_apply(jg, ju, w, 0, p))
    finally:
        jst._stencil_apply_fn.cache_clear()


@pytest.mark.parametrize("periods", ["periodic", "mixed", "non-periodic"])
def test_gradients_match_jax_grad(periods):
    # the reflected-tap adjoint, periodic and Dirichlet
    jg, tg = grids()
    (ju, tu), (jc, tc) = fields(jg, tg, seed=6, n=2)
    w = weights("dense", seed=7)
    p = PERIODS[periods]
    want = jax.grad(lambda v: jnp.sum(cd.stencil_apply(jg, v, w, 0, p)
                                      * jc))(ju)
    x = tu.clone().requires_grad_(True)
    before = S.launch_count
    (got,) = torch.autograd.grad(
        (ct.stencil_apply(tg, x, w, 0, p) * tc).sum(), x)
    assert S.launch_count == before
    close(got, want)
    want = jax.grad(lambda v: jnp.sum(cd.diffusion_step(jg, v, 0.05, 0, p)
                                      * jc))(ju)
    (got,) = torch.autograd.grad(
        (ct.diffusion_step(tg, x, 0.05, 0, p) * tc).sum(), x)
    close(got, want)


def test_every_call_is_one_kernel_call(monkeypatch):
    # one K4 call per stencil_apply / laplacian7 / diffusion_step, one more
    # per backward; ghost-plane mode unless a y/z ghost dim meets a corner
    calls = []
    real = S.stencil27

    def spy(u, w, ghosts=None):
        calls.append("valid" if ghosts is None else "ghost")
        return real(u, w, ghosts)

    monkeypatch.setattr(S, "stencil27", spy)
    _, tg = grids()
    u = torch.randn(tg.buffer_shape(0), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    dense = weights("dense")
    ct.laplacian7(tg, u, 0, PERIODS["non-periodic"])
    ct.diffusion_step(tg, u, 0.1, 0, PERIODS["mixed"])
    ct.stencil_apply(tg, u, dense, 0, PERIODS["x-dirichlet"])
    ct.stencil_apply(tg, u, dense, 0, PERIODS["mixed"])
    assert calls == ["ghost", "ghost", "ghost", "valid"]
    x = u.clone().requires_grad_(True)
    out = ct.stencil_apply(tg, x, dense, 0, PERIODS["periodic"])
    torch.autograd.grad(out.sum(), x)
    assert calls[4:] == ["ghost", "ghost"]


@pytest.mark.parametrize("widths,periods", [
    ((1, 1, 1), "periodic"), ((2, 1, 0), "x-dirichlet"),
    ((0, 2, 2), "mixed"), (1, "non-periodic")])
def test_halo_map_box_sum_matches_jax(widths, periods):
    jg, tg = grids()
    [(ju, tu)] = fields(jg, tg, seed=8)
    wd = (widths,) * 3 if np.isscalar(widths) else widths

    def box_sum(ue):
        out = 0.0
        n = [ue.shape[d] - 2 * wd[d] for d in range(3)]
        for ox in range(2 * wd[0] + 1):
            for oy in range(2 * wd[1] + 1):
                for oz in range(2 * wd[2] + 1):
                    out = out + ue[ox:ox + n[0], oy:oy + n[1], oz:oz + n[2]]
        return out

    p = PERIODS[periods]
    close(ct.halo_map(tg, tu, box_sum, 0, widths, p),
          cd.halo_map(jg, ju, box_sum, 0, widths, p), atol=1e-11)


def test_halo_map_fn_may_change_the_component_dims():
    # a 3-component field in, its divergence (no component dim) out
    jg, tg = grids()
    rng = np.random.default_rng(9)
    x = rng.standard_normal((12, 10, 14, 3))
    ju = jnp.stack([cd.scatter_global(jg, x[..., c], 0) for c in range(3)],
                   axis=-1)
    tu = torch.stack([ct.scatter_global(tg, x[..., c], 0) for c in range(3)],
                     dim=-1)

    def div(ue):
        return (ue[2:, 1:-1, 1:-1, 0] - ue[:-2, 1:-1, 1:-1, 0]
                + ue[1:-1, 2:, 1:-1, 1] - ue[1:-1, :-2, 1:-1, 1]
                + ue[1:-1, 1:-1, 2:, 2] - ue[1:-1, 1:-1, :-2, 2])

    p = PERIODS["mixed"]
    got = ct.halo_map(tg, tu, div, 0, 1, p)
    assert tuple(got.shape) == (12, 10, 14)
    close(got, cd.halo_map(jg, ju, div, 0, 1, p))


def test_halo_map_errors():
    _, tg = grids()
    u = torch.zeros(tg.buffer_shape(0), dtype=torch.float64)
    with pytest.raises(ValueError, match="exceeds the local extent"):
        ct.halo_map(tg, u, lambda ue: ue, 0, (0, 11, 0))
    with pytest.raises(ValueError, match="expected the interior"):
        ct.halo_map(tg, u, lambda ue: ue, 0, 1)
    with pytest.raises(ValueError, match="invalid width"):
        ct.halo_map(tg, u, lambda ue: ue, 0, (1, -1, 0))
    with pytest.raises(ValueError, match="does not match"):
        ct.halo_map(tg, u[1:], lambda ue: ue, 0, 0)
    with pytest.raises(ValueError, match="3, 3, 3"):
        ct.stencil_apply(tg, u, np.zeros((3, 3)))
    with pytest.raises(ValueError, match="does not match"):
        ct.stencil_apply(tg, u[:, 1:], face7())


def test_uneven_shards_are_rejected():
    # 9 over 2 ranks along the dim that pencil 1 shards first
    grid = types.SimpleNamespace(
        config=ct.GridConfig(gdims=(9, 16, 16), pdims=(2, 2)),
        axis_names=("pr", "pc"))
    with pytest.raises(ValueError, match="divisible"):
        st._local_extents(grid, 1)
    assert st._local_extents(grid, 0) == (9, 8, 8)


def test_kernel_dtype_rule_and_device_dispatch():
    # inspected with meta tensors: a tensor off the CPU goes to the kernel
    # or raises; the kernel is built for float32, float64, bfloat16 and
    # float16 only
    w = face7()
    for dtype in (torch.complex64, torch.int32):
        with pytest.raises(ValueError, match="float32, float64, bfloat16 "
                                             "and float16"):
            S.stencil27(torch.empty(4, 4, 4, dtype=dtype, device="meta"), w,
                        (None, None, None))
    with pytest.raises(ValueError, match="CUDA tensors"):
        S.stencil27(torch.empty(4, 4, 4, device="meta"), w, (None,) * 3)
    assert S.kernel_elem_bytes(torch.float32) == 4
    assert S.kernel_elem_bytes(torch.float64) == 8
    assert S.kernel_elem_bytes(torch.bfloat16) == 2
    assert S.kernel_elem_bytes(torch.float16) == 2
    # the CPU takes the plain version, whatever the dtype
    u = torch.randn(4, 5, 6).to(torch.bfloat16)
    assert S.stencil27(u, w, (None,) * 3).dtype == torch.bfloat16


def _e_by_definition(u, ghosts):
    """The extended block E of ghost-plane mode, cell by cell from its
    definition: wrapping dims resolved first, a ghost plane for a cell
    past one non-wrapping edge, zero past two."""
    n = u.shape
    E = np.zeros(tuple(m + 2 for m in n))
    for i in range(-1, n[0] + 1):
        for j in range(-1, n[1] + 1):
            for k in range(-1, n[2] + 1):
                c, sides = [i, j, k], []
                for d in range(3):
                    if not 0 <= c[d] < n[d]:
                        if ghosts[d] is None:
                            c[d] %= n[d]
                        else:
                            sides.append((d, int(c[d] >= 0)))
                if not sides:
                    v = u[tuple(c)]
                elif len(sides) > 1:
                    v = 0.0
                else:
                    d, s = sides[0]
                    c[d] = 0
                    v = ghosts[d][s][tuple(c)]
                E[i + 1, j + 1, k + 1] = v
    return E


@pytest.mark.parametrize("shape", [(3, 4, 5), (1, 2, 3), (2, 1, 1)])
@pytest.mark.parametrize("wrap", [(True, True, True), (False, False, False),
                                  (False, True, True), (True, False, True),
                                  (True, True, False)])
def test_stencil27_ref_is_its_definition(shape, wrap):
    rng = np.random.default_rng(10)
    u = rng.standard_normal(shape)
    ghosts = []
    for d in range(3):
        plane = list(shape)
        plane[d] = 1
        ghosts.append(None if wrap[d] else (rng.standard_normal(plane),
                                            rng.standard_normal(plane)))
    w = weights("dense", seed=11)
    E = _e_by_definition(u, ghosts)
    want = sum(w[1 + dx, 1 + dy, 1 + dz]
               * E[1 + dx:1 + dx + shape[0], 1 + dy:1 + dy + shape[1],
                   1 + dz:1 + dz + shape[2]]
               for dx, dy, dz in S.OFFSETS)
    tg = [None if g is None else tuple(map(torch.from_numpy, g))
          for g in ghosts]
    got = S.stencil27_ref(torch.from_numpy(u), w, tg)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # valid mode over E is the same stencil
    np.testing.assert_allclose(
        S.stencil27_ref(torch.from_numpy(E), w).numpy(), want, rtol=0,
        atol=ATOL)


def test_clear_plan_caches_drops_the_stencil_caches():
    # a second grid with other weights must not reuse a stale entry
    _, g1 = grids()
    g2 = ct.make_grid(ct.GridConfig(gdims=(12, 10, 14), pdims=(1, 1),
                                    halo_method=ct.HaloMethod.PALLAS), "cpu")
    assert g1 != g2
    u = torch.randn(g1.buffer_shape(0), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(12))
    w1, w2 = weights("dense", seed=13), weights("dense", seed=14)
    a = ct.stencil_apply(g1, u, w1)
    ct.laplacian7(g1, u)
    assert st._stencil_apply_fn.cache_info().currsize >= 2
    assert st._diff_apply_fn.cache_info().currsize >= 1
    ct.clear_plan_caches()
    assert st._stencil_apply_fn.cache_info().currsize == 0
    assert st._diff_apply_fn.cache_info().currsize == 0
    b = ct.stencil_apply(g2, u, w2)
    assert torch.equal(a, S.stencil27_ref(u, w1, (None,) * 3))
    assert torch.equal(b, S.stencil27_ref(u, w2, (None,) * 3))
    assert not torch.equal(a, b)
