"""K5, the fused 2-axis DFT (``cudecomp_tpu_torch.ops.dft2``), against the
JAX package's Pallas ``dft2_fused`` run in interpret mode, against numpy,
and in the FFT's (1, 2) hook: its plain version ``dft2_ref`` and
``dft2_stages``, the CPU model of the kernel's cluster FFT, with the
layout ``dft2_plan`` picks.  The CUDA kernel itself is checked against
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


# every branch of the kernel: N1 = A M with A = 8 and M a power of two (1)
# or not (3, 25), A = 16 and M = 8 or 16, N2 = 16 B with B = 8 or 16, and
# clusters of 1, 2, 4, 8
STAGE_SHAPES = [(n1, n2) for n1 in (8, 24, 128, 200, 256) for n2 in (128, 256)]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("X", [1, 3])
@pytest.mark.parametrize("n1,n2", STAGE_SHAPES)
def test_dft2_stages_matches_pallas_dft2_fused(monkeypatch, n1, n2, X,
                                               inverse):
    # the kernel's algorithm in float32 against JAX's kernel in interpret
    # mode and against numpy in complex128, to 1e-5 x max|reference|; in
    # float64 against numpy to 1e-10
    monkeypatch.setenv("CUDECOMP_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("CUDECOMP_TPU_FFT_FUSED2", "1")
    x = field((X, n1, n2), seed=n1 + n2 + X)
    x32 = x.astype(np.complex64)
    out = M.dft2_fused(jnp.asarray(x32.real), jnp.asarray(x32.imag), inverse)
    assert out is not None  # the JAX side really ran its kernel
    jax_out = np.asarray(out[0]) + 1j * np.asarray(out[1])
    want = (np.fft.ifftn if inverse else np.fft.fftn)(x, axes=(1, 2))
    got = D.dft2_stages(torch.from_numpy(x32), inverse)
    assert got.dtype == torch.complex64 and tuple(got.shape) == x.shape
    for ref in (jax_out, want):
        err = np.max(np.abs(got.numpy() - ref))
        assert err <= 1e-5 * np.max(np.abs(ref)), err
    got64 = D.dft2_stages(torch.from_numpy(x), inverse).numpy()
    np.testing.assert_allclose(got64, want, rtol=0,
                               atol=1e-10 * np.max(np.abs(want)))


def test_dft2_plan_fits_the_shared_memory_budget():
    # every shape of the gate: C is the smallest cluster whose block share
    # fits half an SM (two blocks per SM), within the 227 KB a block may
    # hold; the chunk is the widest that divides the block's columns and
    # fits; C divides N1, so every block holds whole rows
    picked = set()
    for n1, n2 in itertools.product(range(8, 257, 8), (128, 256)):
        plan = D.dft2_plan(n1, n2)
        C, W = plan.cluster, plan.chunk
        assert C in (1, 2, 4, 8) and W in (16, 32) and n1 % C == 0
        assert (n2 // C) % W == 0
        assert plan.smem == D.smem_bytes(n1, n2, C, W)
        assert plan.smem <= D.SMEM_BUDGET < D.BLOCK_SMEM == 232_448
        assert 2 * (plan.smem + 1024) <= D.SM_SMEM
        if C > 1:
            assert D.smem_bytes(n1, n2, C // 2, 16) > D.SMEM_BUDGET
        if W == 16 and (n2 // C) % 32 == 0:
            assert D.smem_bytes(n1, n2, C, 32) > D.SMEM_BUDGET
        picked.add(C)
    assert picked == {1, 2, 4, 8}
    assert D.dft2_plan(256, 256) == (8, 16, 107_520)  # the main path's
    assert D.dft2_plan(8, 128).cluster == 1
    for n1, n2 in ((12, 128), (264, 128), (0, 128), (8, 64), (8, 384)):
        with pytest.raises(ValueError, match="K5 takes planes"):
            D.dft2_plan(n1, n2)


@pytest.mark.parametrize("L", [1, 2, 4, 8, 16, 32])
def test_fft_regs_is_the_dft_in_bit_reversed_order(L):
    # the kernel's in-register FFT, its twiddles W_L^j read from the W_32
    # table as the kernel reads its constant memory
    w32 = D.twiddles(D.INNER, torch.complex128, torch.device("cpu"))
    x = field((3, L), seed=L)
    got = D._fft_regs(torch.from_numpy(x), w32).numpy()
    want = np.fft.fft(x, axis=-1)
    np.testing.assert_allclose(got, want[:, D._bitrev(L).numpy()], rtol=0,
                               atol=1e-12 * L)


def test_twiddles_are_float64_tables_cast_once():
    for n in (8, 24, 32, 256):
        tw = D.twiddles(n, torch.complex64, torch.device("cpu"))
        want = np.exp(-2j * np.pi * np.arange(n) / n)
        assert tw.dtype == torch.complex64 and tuple(tw.shape) == (n,)
        np.testing.assert_array_equal(tw.numpy(), want.astype(np.complex64))
        assert D.twiddles(n, torch.complex64,
                          torch.device("cpu")) is tw  # cached
    assert [D.col_radix(n) for n in (8, 64, 120, 128, 200, 256)] == [
        8, 8, 8, 16, 8, 16]


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
    with pytest.raises(ValueError, match="K5 takes planes"):
        D.dft2_stages(torch.zeros((2, 12, 128), dtype=torch.complex64))
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
