"""K5, the fused 2-axis DFT (``cudecomp_tpu_torch.ops.dft2``), against the
JAX package's Pallas ``dft2_fused`` run in interpret mode, against numpy,
and in the FFT's (1, 2) hook.  The CUDA kernel itself is checked against
``dft2_ref`` by the ``gpu`` tests in ``test_torch_kernels.py``."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudecomp_tpu.ops import mxu_fft as M

import cudecomp_tpu_torch as ct
from cudecomp_tpu_torch.ops import dft2 as D
from cudecomp_tpu_torch.ops.fft import DistributedFFT


def field(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape", [(16, 8, 128), (4, 16, 256)])
def test_dft2_ref_matches_pallas_dft2_fused(monkeypatch, shape, inverse):
    monkeypatch.setenv("CUDECOMP_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("CUDECOMP_TPU_FFT_FUSED2", "1")
    x = field(shape).astype(np.complex64)
    out = M.dft2_fused(jnp.asarray(x.real), jnp.asarray(x.imag), inverse)
    assert out is not None  # the JAX side really ran its kernel
    want = np.asarray(out[0]) + 1j * np.asarray(out[1])
    before = D.launch_count
    got = D.dft2(torch.from_numpy(x), inverse)
    assert D.launch_count == before  # CPU tensors take the plain version
    assert got.dtype == torch.complex64 and tuple(got.shape) == shape
    err = np.max(np.abs(got.numpy() - want))
    assert err <= 1e-5 * np.max(np.abs(want))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape", [(3, 8, 128), (2, 5, 7), (1, 1, 1)])
def test_dft2_ref_complex128_is_the_numpy_fft(shape, inverse):
    x = field(shape, seed=1)
    got = D.dft2_ref(torch.from_numpy(x), inverse).numpy()
    want = (np.fft.ifftn if inverse else np.fft.fftn)(x, axes=(1, 2))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_dft2_mats_match_the_jax_matrices():
    for n, inverse in itertools.product((8, 12, 128), (False, True)):
        c, s = D.dft2_mats(n, inverse, torch.device("cpu"))
        jc, js = M._dft_mats(n, inverse, "float32")
        assert c.dtype == torch.float32 and tuple(c.shape) == (n, n)
        np.testing.assert_array_equal(c.numpy(), jc)
        np.testing.assert_array_equal(s.numpy(), js)
        assert D.dft2_mats(n, inverse, torch.device("cpu"))[0] is c  # cached


def test_dft2_eligible_agrees_with_the_jax_gate(monkeypatch):
    monkeypatch.setenv("CUDECOMP_TPU_PALLAS_INTERPRET", "1")
    sizes = (1, 8, 16, 12, 128, 129, 256, 264, 384, 512)
    for n1, n2 in itertools.product(sizes, sizes):
        jx = jnp.zeros((2, n1, n2), jnp.float32)
        tx = torch.zeros((2, n1, n2), dtype=torch.complex64)
        for knob in ("0", "1"):
            monkeypatch.setenv("CUDECOMP_TPU_FFT_FUSED2", knob)
            assert D.dft2_eligible(tx) == M._dft2_gate(jx, n1, n2), (n1, n2)
    monkeypatch.setenv("CUDECOMP_TPU_FFT_FUSED2", "1")
    assert D.dft2_eligible(torch.zeros((2, 8, 128), dtype=torch.complex64))
    for t in (torch.zeros((2, 8, 128), dtype=torch.complex128),
              torch.zeros((2, 8, 128, 3), dtype=torch.complex64),
              torch.zeros((8, 128), dtype=torch.complex64)):
        assert not D.dft2_eligible(t)


def test_dft2_rejects_what_it_cannot_take():
    with pytest.raises(ValueError, match="3D"):
        D.dft2(torch.zeros((8, 128), dtype=torch.complex64))
    with pytest.raises(ValueError, match="complex64 or complex128"):
        D.dft2(torch.zeros((2, 8, 128)))
    with pytest.raises(ValueError, match="CUDA"):
        D.dft2(torch.zeros((2, 8, 128), dtype=torch.complex64,
                           device="meta"))


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_hook_routes_the_pair_through_dft2(monkeypatch, real, inverse):
    # a split-complex natural-layout plan at pdims (1, 1): one local 3D
    # stage, whose (1, 2) pair goes to dft2 only with the knob on
    gdims = (6, 8, 128)
    grid = ct.make_grid(ct.GridConfig(gdims=gdims, pdims=(1, 1)), "cpu")
    plan = DistributedFFT(grid=grid, real=real, split_complex=True)
    calls = []
    real_dft2 = D.dft2

    def spy(x, inv=False):
        calls.append((tuple(x.shape), inv))
        return real_dft2(x, inv)

    monkeypatch.setattr("cudecomp_tpu_torch.ops.fft.dft2", spy)
    rng = np.random.default_rng(2)
    f = rng.standard_normal(gdims).astype(np.float32)
    x = torch.from_numpy(f) if real else torch.complex(
        torch.from_numpy(f), torch.from_numpy(f[::-1].copy()))
    outs = {}
    for knob in ("0", "1"):
        monkeypatch.setenv("CUDECOMP_TPU_FFT_FUSED2", knob)
        calls.clear()
        if inverse:
            spec = plan.forward_planes(x) if real else plan.forward_planes(
                (x.real, x.imag))
            outs[knob] = plan.inverse_planes(spec)
        else:
            outs[knob] = plan.forward_planes(x if real else (x.real, x.imag))
        nx = gdims[0] // 2 + 1 if real else gdims[0]
        want = [] if knob == "0" else [((nx,) + gdims[1:], False)]
        if inverse and knob == "1":
            want.append(((nx,) + gdims[1:], True))
        assert calls == want
    a, b = outs["0"], outs["1"]
    a = a if isinstance(a, torch.Tensor) else torch.complex(*a)
    b = b if isinstance(b, torch.Tensor) else torch.complex(*b)
    assert torch.allclose(a, b, rtol=0, atol=1e-4 * float(a.abs().max()))


def test_fft_hook_needs_split_complex_and_a_3d_stage(monkeypatch):
    monkeypatch.setenv("CUDECOMP_TPU_FFT_FUSED2", "1")
    before = []
    monkeypatch.setattr("cudecomp_tpu_torch.ops.fft.dft2",
                        lambda x, inv=False: before.append(1) or x)
    grid = ct.make_grid(ct.GridConfig(gdims=(4, 8, 128), pdims=(1, 1)), "cpu")
    x = torch.zeros((4, 8, 128), dtype=torch.complex64)
    DistributedFFT(grid=grid).forward(x)                 # complex plan
    DistributedFFT(grid=grid, real=True, split_complex=True).forward(
        torch.zeros((4, 8, 128, 3)))                     # 4D: components
    assert before == []
