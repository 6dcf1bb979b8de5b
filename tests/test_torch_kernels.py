"""The CUDA kernels of cudecomp_tpu_torch: K1 (the local permute), K4 (the
27-point stencil), K5 (the fused 2-axis DFT, whose plain version is held
to JAX in ``test_torch_dft2.py``), K2, K2s and K3 (the one-sided
exchanges, whose plans are held to JAX in ``test_torch_peer.py``) and K0
(the probe every library runs at load).

On the CPU the wrappers run their plain twins, which must be bit-equal to
the JAX package's Pallas kernels run in interpret mode (K4's plain version
is held to JAX in ``test_torch_stencil.py``).  The CUDA kernels themselves
are checked against their twins by the ``gpu`` tests, which skip without
a card.  JAX is imported inside the tests that compare with it,
so that on a machine without JAX the ``gpu`` tests run with
``python -m pytest --noconftest -m gpu tests/test_torch_kernels.py``.
"""

import ctypes
import stat
import sys
import types

import numpy as np
import pytest
import torch

import cudecomp_tpu_torch as ct
from cudecomp_tpu_torch.ops import cuda_kernels as K
from cudecomp_tpu_torch.ops import stencil_kernel as S
from cudecomp_tpu_torch.utils import cuda_build

DTYPES = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}


def make_pair(shape, dtype_key, seed=0):
    """The same values as a jax array and a torch tensor."""
    import jax.numpy as jnp
    jdt = {"f32": np.float32, "f64": np.float64, "bf16": jnp.bfloat16}[dtype_key]
    tdt = DTYPES[dtype_key]
    f = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(f).astype(jdt)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    return jx, tx


def as_np(t):
    return t.to(torch.float32).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def jax_np(a):
    import jax.numpy as jnp
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("perm", K.CYCLIC_PERMS)
@pytest.mark.parametrize("shape", [
    (16, 24, 32), (8, 16, 128),
    (7, 33, 65), (1, 5, 3),   # ragged: whole-extent Pallas blocks
])
def test_cyclic_permute_twin_matches_pallas(shape, perm, dtype):
    import jax.numpy as jnp
    from cudecomp_tpu.ops.pallas_kernels import (cyclic_permute_uses_kernel,
                                                 pallas_cyclic_permute)
    jx, tx = make_pair(shape, dtype)
    # the JAX side really runs its kernel (in interpret mode)
    assert cyclic_permute_uses_kernel(shape, perm, interpret=True,
                                      itemsize=jnp.dtype(jx.dtype).itemsize)
    want = jax_np(pallas_cyclic_permute(jx, perm, interpret=True))
    before = K.launch_count
    got = K.cyclic_permute(tx, perm)
    assert K.launch_count == before  # CPU tensors take the twin
    assert got.dtype == tx.dtype and got.is_contiguous()
    np.testing.assert_array_equal(as_np(got), want)
    np.testing.assert_array_equal(as_np(K.cyclic_permute_ref(tx, perm)), want)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,tiles", [
    ((256, 1152), (256, 384)),   # the non-square tiles of test_pallas.py
    ((256, 1152), (128, 1152)),
    ((64, 96), (32, 32)),
    ((33, 65), (32, 32)),        # ragged: pallas_transpose2d declines to x.T
    ((1, 40), (1, 40)),
])
def test_transpose2d_twin_matches_pallas(shape, tiles, dtype):
    from cudecomp_tpu.ops.pallas_kernels import pallas_transpose2d
    jx, tx = make_pair(shape, dtype, seed=1)
    want = jax_np(pallas_transpose2d(jx, tm=tiles[0], tn=tiles[1],
                                     interpret=True))
    before = K.launch_count
    got = K.transpose2d(tx)
    assert K.launch_count == before
    np.testing.assert_array_equal(as_np(got), want)
    np.testing.assert_array_equal(as_np(K.transpose2d_ref(tx)), want)


def test_trailing_dims_move_with_the_element():
    x = torch.arange(3 * 4 * 5 * 2, dtype=torch.float32).reshape(3, 4, 5, 2)
    for perm in K.CYCLIC_PERMS:
        got = K.cyclic_permute(x, perm)
        assert torch.equal(got, x.permute(perm + (3,)))
        c = torch.view_as_complex(x)
        assert torch.equal(torch.view_as_real(K.cyclic_permute(c, perm)), got)
    assert K.element_bytes(x, 3) == 8
    assert K.element_bytes(torch.zeros(2, 2, 3, dtype=torch.complex128), 2) == 48
    y = torch.arange(12.0).reshape(3, 4, 1)
    assert torch.equal(K.transpose2d(y), y.transpose(0, 1))


def test_word_bytes_divides_element_and_addresses():
    assert K.word_bytes(8, 256, 512) == 8       # c64 or f32 pair
    assert K.word_bytes(12, 256, 512) == 4      # 3-component f32
    assert K.word_bytes(48, 256, 512) == 16     # 3-component c128
    assert K.word_bytes(6, 256, 256) == 2       # 3-component bf16
    assert K.word_bytes(3, 256, 256) == 1
    assert K.word_bytes(8, 260, 512) == 4       # a view 4 bytes off
    assert K.word_bytes(16, 256, 264) == 8


def test_wrappers_reject_bad_input():
    x = torch.zeros(4, 5, 6)
    with pytest.raises(ValueError, match="cyclic_permute"):
        K.cyclic_permute(x, (0, 2, 1))
    with pytest.raises(ValueError, match="cyclic_permute"):
        K.cyclic_permute(torch.zeros(4, 5), (1, 2, 0))
    with pytest.raises(ValueError, match="transpose2d"):
        K.transpose2d(torch.zeros(4))


def test_cpu_dispatch_never_launches():
    # the whole slab path on CPU tensors: K1's twin runs, nothing launches
    K.reset_launch_count()
    cfg = ct.GridConfig(gdims=(8, 9, 10), pdims=(1, 1),
                        transpose_axis_contiguous=(True, True, True))
    grid = ct.make_grid(cfg, "cpu")
    x = torch.randn(grid.buffer_shape(0), dtype=torch.complex64)
    z = ct.transpose_y_to_z(grid, ct.transpose_x_to_y(grid, x))
    back = ct.transpose_y_to_x(grid, ct.transpose_z_to_y(grid, z))
    assert torch.equal(back, x)
    assert K.launch_count == 0


def test_cuda_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ct.make_grid(ct.GridConfig(gdims=(8, 8, 8), pdims=(1, 1)),
                     device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ct.init("cuda")
    assert ct.init("cpu") == torch.device("cpu")


# -- the build -----------------------------------------------------------------

def _fake_nvcc(tmp_path):
    """An executable that records its arguments and writes the -o file."""
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        f"open({str(log)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('lib')\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return nvcc, log


def test_build_compiles_once_per_source_hash(tmp_path, monkeypatch):
    src_dir = tmp_path / "csrc"
    src_dir.mkdir()
    (src_dir / "k.cu").write_text("// v1\n")
    nvcc, log = _fake_nvcc(tmp_path)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", src_dir)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: nvcc)

    p1 = cuda_build.build("k", ("k.cu",))
    assert p1.is_file() and p1.parent == tmp_path / "_build"
    args = log.read_text().splitlines()
    assert len(args) == 1
    assert "-gencode arch=compute_90a,code=sm_90a" in args[0]
    assert "-O3 -shared -Xcompiler -fPIC" in args[0]
    assert cuda_build.build("k", ("k.cu",)) == p1       # reused
    assert len(log.read_text().splitlines()) == 1

    (src_dir / "k.cu").write_text("// v2\n")            # edited: rebuilt
    p2 = cuda_build.build("k", ("k.cu",))
    assert p2 != p1 and p2.is_file() and not p1.exists()
    assert len(log.read_text().splitlines()) == 2
    assert not list((tmp_path / "_build").glob("*.tmp.so"))


def test_build_keeps_another_builders_library_in_flight(tmp_path,
                                                      monkeypatch):
    # ranks that share a card may build one library at once: a finished
    # build removes stale libraries, never another process's temporary
    src_dir = tmp_path / "csrc"
    src_dir.mkdir()
    (src_dir / "k.cu").write_text("// v1\n")
    nvcc, _ = _fake_nvcc(tmp_path)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", src_dir)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: nvcc)
    path = cuda_build.library_path("k", ("k.cu",))
    path.parent.mkdir()
    other = path.with_name(f"{path.stem}.99999.tmp.so")
    other.write_text("half-written")
    stale = path.with_name("libk-0123456789abcdef.so")
    stale.write_text("old")
    assert cuda_build.build("k", ("k.cu",)) == path
    assert other.exists() and not stale.exists()


def test_build_goes_to_the_user_cache_when_package_is_read_only(
        tmp_path, monkeypatch, capsys):
    src_dir = tmp_path / "csrc"
    src_dir.mkdir()
    (src_dir / "k.cu").write_text("// v1\n")
    nvcc, _ = _fake_nvcc(tmp_path)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", src_dir)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "pkg" / "_build")
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: nvcc)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    (tmp_path / "pkg").mkdir()
    assert cuda_build.build_dir() == tmp_path / "pkg" / "_build"
    monkeypatch.setattr(cuda_build.os, "access", lambda path, mode: False)
    cache = tmp_path / "cache" / "cudecomp_tpu_torch"
    assert cuda_build.build_dir() == cache
    p = cuda_build.build("k", ("k.cu",))
    assert p.is_file() and p.parent == cache
    assert not (tmp_path / "pkg" / "_build").exists()
    assert f"built {p}" in capsys.readouterr().err


def test_build_reports_nvcc_failure(tmp_path, monkeypatch):
    src_dir = tmp_path / "csrc"
    src_dir.mkdir()
    (src_dir / "k.cu").write_text("// broken\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'error: expected a ;' >&2\nexit 2\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", src_dir)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: nvcc)
    with pytest.raises(RuntimeError, match="expected a ;"):
        cuda_build.build("k", ("k.cu",))
    assert not list((tmp_path / "_build").iterdir())


def test_nvcc_path_without_toolkit(monkeypatch):
    import torch.utils.cpp_extension as cpp
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="CUDA toolkit"):
        cuda_build.nvcc_path()


def test_kernel_source_is_packaged():
    assert (cuda_build.CSRC_DIR / K.SOURCES[0]).is_file()
    assert cuda_build.library_path("transpose2d", K.SOURCES).parent == (
        cuda_build.PACKAGE_DIR / "_build")


# -- K0, the probe at load ------------------------------------------------------------

class _FakeLib:
    """A library whose probe entry copies (or not) on the host, or fails."""

    def __init__(self, copy=True, err=0):
        self.copy, self.err = copy, err

    def cudecomp_probe_copy(self, src, dst, n, stream):
        if self.copy:
            ctypes.memmove(dst, src, n * 4)
        return self.err

    def cudecomp_cuda_error_string(self, err):
        return b"too many resources requested for launch"


def test_probe_counts_and_compares_bit_for_bit():
    before = cuda_build.probe_launch_count
    cuda_build.probe(_FakeLib(), "k", device="cpu")
    assert cuda_build.probe_launch_count == before + 1
    with pytest.raises(RuntimeError, match="K0 probe of library 'k'.*differs"):
        cuda_build.probe(_FakeLib(copy=False), "k", device="cpu")
    with pytest.raises(RuntimeError, match="failed to launch: too many"):
        cuda_build.probe(_FakeLib(err=701), "k", device="cpu")
    assert cuda_build.probe_launch_count == before + 2  # a failed launch
    cuda_build.reset_probe_count()
    assert cuda_build.probe_launch_count == 0


def test_load_builds_with_the_probe_and_probes_once(monkeypatch):
    built, probed = [], []
    monkeypatch.setattr(cuda_build, "build",
                        lambda name, srcs: built.append(srcs) or "lib.so")
    monkeypatch.setattr(cuda_build.ctypes, "CDLL",
                        lambda path: types.SimpleNamespace(
                            **{fn: types.SimpleNamespace() for fn in (
                                "cudecomp_probe_copy", "cudecomp_probe_empty",
                                "cudecomp_cuda_error_string", "k_entry")}))
    monkeypatch.setattr(cuda_build, "probe",
                        lambda lib, name: probed.append(name))
    sig = (("k_entry", (ctypes.c_void_p, ctypes.c_int64), ctypes.c_int),)
    cuda_build.load.cache_clear()
    try:
        lib = cuda_build.load("k", ("k.cu",), sig)
        assert cuda_build.load("k", ("k.cu",), sig) is lib
    finally:
        cuda_build.load.cache_clear()
    assert built == [("probe.cu", "k.cu")] and probed == ["k"]
    assert lib.k_entry.argtypes == [ctypes.c_void_p, ctypes.c_int64]
    assert lib.k_entry.restype is ctypes.c_int
    assert lib.cudecomp_probe_copy.restype is ctypes.c_int
    assert lib.cudecomp_probe_empty.argtypes == [ctypes.c_void_p]
    assert lib.cudecomp_probe_empty.restype is ctypes.c_int


def test_every_library_carries_the_probe():
    for sources in (K.SOURCES, S.SOURCES):
        srcs = cuda_build.library_sources(sources)
        assert srcs[0] == cuda_build.PROBE_SOURCE
        assert all((cuda_build.CSRC_DIR / s).is_file() for s in srcs)


# -- on the card -------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


GPU_DTYPES = [torch.bfloat16, torch.float32, torch.float64, torch.complex64,
              torch.complex128]


def _cuda_field(shape, dtype, device):
    g = torch.Generator(device=device)
    g.manual_seed(0)
    if dtype.is_complex:
        return torch.view_as_complex(torch.randn(
            tuple(shape) + (2,), generator=g, device=device,
            dtype=dtype.to_real()))
    return torch.randn(shape, generator=g, device=device).to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", GPU_DTYPES)
@pytest.mark.parametrize("perm", K.CYCLIC_PERMS)
def test_gpu_cyclic_permute_matches_twin(cuda, dtype, perm):
    for shape in ((7, 33, 65), (1, 17, 9), (64, 32, 96), (5, 4, 1)):
        x = _cuda_field(shape, dtype, cuda)
        before = K.launch_count
        got = K.cyclic_permute(x, perm)
        torch.cuda.synchronize()
        assert K.launch_count == before + 1
        assert torch.equal(got, K.cyclic_permute_ref(x, perm))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", GPU_DTYPES)
def test_gpu_transpose2d_matches_twin(cuda, dtype):
    for shape in ((1, 1000), (1000, 1), (33, 65), (64, 4096)):
        x = _cuda_field(shape, dtype, cuda)
        assert torch.equal(K.transpose2d(x), K.transpose2d_ref(x))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,comp", [
    (torch.bfloat16, 3), (torch.float32, 3), (torch.float32, 5),
    (torch.float64, 3), (torch.complex128, 3)])
def test_gpu_any_element_size_matches_twin(cuda, dtype, comp):
    # elements of 6, 12, 20, 24 and 48 bytes move as several words
    for shape in ((7, 33, 65), (64, 32, 96)):
        x = _cuda_field(shape + (comp,), dtype, cuda)
        for perm in K.CYCLIC_PERMS:
            before = K.launch_count
            got = K.cyclic_permute(x, perm)
            assert K.launch_count == before + 1
            assert torch.equal(got, K.cyclic_permute_ref(x, perm))


@pytest.mark.gpu
def test_gpu_view_at_an_offset_matches_twin(cuda):
    # 8-byte elements at an address 4 bytes off move as two 4-byte words
    flat = _cuda_field((1 + 7 * 33 * 65 * 2,), torch.float32, cuda)
    x = flat[1:].view(7, 33, 65, 2)
    assert x.data_ptr() % 8 == 4
    for perm in K.CYCLIC_PERMS:
        assert torch.equal(K.cyclic_permute(x, perm),
                           K.cyclic_permute_ref(x, perm))


@pytest.mark.gpu
def test_gpu_component_transposes_launch_k1(cuda):
    # a 3-component f32 field (12-byte elements) through the public ops:
    # every cyclic net permute launches K1, and the result is the CPU's
    cfg = ct.GridConfig(gdims=(8, 6, 10), pdims=(1, 1),
                        transpose_axis_contiguous=(True, True, True))
    cpu, gpu = ct.make_grid(cfg, "cpu"), ct.make_grid(cfg, cuda)
    a = torch.randn(cpu.buffer_shape(0) + (3,),
                    generator=torch.Generator().manual_seed(0))
    b = a.to(gpu.device)
    for name in ("x_to_y", "y_to_z", "z_to_y", "y_to_x"):
        before = K.launch_count
        a = getattr(ct, f"transpose_{name}")(cpu, a)
        b = getattr(ct, f"transpose_{name}")(gpu, b)
        assert K.launch_count == before + 1, name
        assert torch.equal(b.cpu(), a), name


@pytest.mark.gpu
def test_gpu_rejects_what_k1_cannot_move(cuda):
    with pytest.raises(ValueError, match="contiguous"):
        K.cyclic_permute(torch.zeros(4, 6, 8, device=cuda)[:, :, ::2],
                         (1, 2, 0))
    with pytest.raises(ValueError, match="contiguous"):
        K.transpose2d(torch.zeros(6, 8, device=cuda)[:, ::2])


# -- K4 and K0 on the card ---------------------------------------------------------

def _k4_weights(kind, seed=0):
    if kind == "face7":
        w = np.zeros((3, 3, 3))
        w[1, 1, 1] = -6.0
        for o in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                  (1, 1, 2)):
            w[o] = 1.0
        return w
    return np.random.default_rng(seed).standard_normal((3, 3, 3))


def _k4_ghosts(u, wrap, gen):
    """Random ghost planes for each memory dim that does not wrap."""
    out = []
    for d in range(3):
        if wrap[d]:
            out.append(None)
            continue
        shape = list(u.shape)
        shape[d] = 1
        out.append(tuple(torch.randn(shape, generator=gen, device=u.device,
                                     dtype=torch.float64).to(u.dtype)
                         for _ in range(2)))
    return out


#: x sum|w| x max|input|; the 2-byte types round the float32 sum once, so
#: kernel and plain version may differ by one unit of the type's last place
K4_EPS = {torch.float32: 1e-6, torch.float64: 1e-14, torch.bfloat16: 8e-3,
          torch.float16: 1e-3}


def _k4_tol(u, w):
    return K4_EPS[u.dtype] * float(np.abs(w).sum()) * float(
        u.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(K4_EPS))
@pytest.mark.parametrize("wkind", ["face7", "dense"])
def test_gpu_stencil27_matches_ref(cuda, dtype, wkind):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    w = _k4_weights(wkind)
    for shape in ((7, 33, 65), (1, 5, 3), (2, 2, 2), (64, 32, 96),
                  (5, 40, 200)):
        u = torch.randn(shape, generator=gen, device=cuda,
                        dtype=torch.float64).to(dtype)
        ue = torch.randn(tuple(n + 2 for n in shape), generator=gen,
                         device=cuda, dtype=torch.float64).to(dtype)
        cases = [(ue, None)] + [
            (u, _k4_ghosts(u, wrap, gen))
            for wrap in ((True, True, True), (False, False, False),
                         (False, True, True))]
        for x, ghosts in cases:
            before = S.launch_count
            got = S.stencil27(x, w, ghosts)
            torch.cuda.synchronize()
            assert S.launch_count == before + 1
            want = S.stencil27_ref(x, w, ghosts)
            assert got.shape == want.shape == shape
            err = float((got.double() - want.double()).abs().max())
            assert err <= _k4_tol(x, w), (shape, ghosts is None, err)


@pytest.mark.gpu
def test_gpu_stencil27_rejects_what_it_cannot_take(cuda):
    w = _k4_weights("dense")
    for dtype in (torch.complex64, torch.int32):
        with pytest.raises(ValueError, match="float16 on CUDA tensors"):
            S.stencil27(torch.zeros(4, 4, 4, device=cuda, dtype=dtype), w,
                        (None, None, None))
    with pytest.raises(ValueError, match="contiguous"):
        S.stencil27(torch.zeros(4, 4, 8, device=cuda)[:, :, ::2], w,
                    (None, None, None))


@pytest.mark.gpu
def test_gpu_stencil27_smem_bytes_match_the_plan(cuda):
    # stencil_plan sizes K4's layout with the Python smem_bytes; the launch
    # sizes its shared memory with the C one: the two agree on every stage
    # count the entry takes, and it refuses the others
    lib = S._lib()
    for dtype, code in S.DTYPE_CODES.items():
        for stages in range(S.MIN_STAGES, S.MAX_STAGES + 1):
            assert lib.cudecomp_stencil27_smem_bytes(code, stages) == \
                S.smem_bytes(dtype, stages), (dtype, stages)
        for stages in (S.MIN_STAGES - 1, S.MAX_STAGES + 1):
            assert lib.cudecomp_stencil27_smem_bytes(code, stages) == -1
        for kind in ("face7", "dense"):
            plan = S.stencil_plan(_k4_weights(kind), False, 7, dtype,
                                  (512, 512, 512))
            assert lib.cudecomp_stencil27_smem_bytes(
                code, plan.stages) == plan.smem


@pytest.mark.gpu
def test_gpu_probe_runs_at_load(cuda):
    cuda_build.load.cache_clear()
    before = cuda_build.probe_launch_count
    S.build()
    K.build()
    assert cuda_build.probe_launch_count == before + 2
    S.build()  # a loaded library is not probed again
    assert cuda_build.probe_launch_count == before + 2


@pytest.mark.gpu
def test_gpu_probe_empty_kernel_launches(cuda):
    # the empty kernel that measures K0's launch floor: every library has it
    for lib in (K._lib(), S._lib()):
        assert lib.cudecomp_probe_empty(
            torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("periods", [(True, True, True), (False, True, True),
                                     (False, False, False)])
def test_gpu_stencil_path_launches_k4_once(cuda, periods):
    # the public entry points on a CUDA grid: one K4 launch each, one more
    # for the backward, and the CPU's numbers
    cfg = ct.GridConfig(gdims=(16, 12, 40), pdims=(1, 1))
    cpu, gpu = ct.make_grid(cfg, "cpu"), ct.make_grid(cfg, cuda)
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal(cfg.gdims))
    g = torch.from_numpy(rng.standard_normal(cfg.gdims))
    w = rng.standard_normal((3, 3, 3))
    calls = [lambda grid, v: ct.diffusion_step(grid, v, 0.1, 0, periods),
             lambda grid, v: ct.laplacian7(grid, v, 0, periods),
             lambda grid, v: ct.stencil_apply(grid, v, w, 0, periods)]
    for call in calls:
        before = S.launch_count
        got = call(gpu, a.to(cuda))
        assert S.launch_count == before + 1
        torch.testing.assert_close(got.cpu(), call(cpu, a), rtol=0,
                                   atol=1e-12)
    b = a.to(cuda).requires_grad_(True)
    before = S.launch_count
    (grad,) = torch.autograd.grad(
        (ct.stencil_apply(gpu, b, w, 0, periods) * g.to(cuda)).sum(), b)
    assert S.launch_count == before + 2
    want = ct.stencil_apply(cpu, g, w[::-1, ::-1, ::-1], 0, periods)
    torch.testing.assert_close(grad.cpu(), want, rtol=0, atol=1e-12)


# -- K5 on the card ------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("inverse", [False, True])
def test_gpu_dft2_matches_ref(cuda, inverse):
    # every kernel instance: N1 = 8 M with M = 1, 2, 4, 8 or not a power of
    # two (3, 25), N1 = 16 M with M = 8, 16; B = N2 / 16 of 8 or 16;
    # clusters of 1, 2, 4, 8
    from cudecomp_tpu_torch.ops import dft2 as D
    for shape in ((16, 8, 128), (3, 16, 256), (4, 32, 128), (2, 64, 256),
                  (2, 128, 128), (1, 256, 128), (2, 256, 256), (3, 24, 128),
                  (5, 200, 256)):
        x = _cuda_field(shape, torch.complex64, cuda)
        before = D.launch_count
        got = D.dft2(x, inverse)
        torch.cuda.synchronize()
        assert D.launch_count == before + 1
        for want in (D.dft2_ref(x, inverse),
                     (torch.fft.ifftn if inverse else torch.fft.fftn)(
                         x.to(torch.complex128), dim=(1, 2))):
            err = float((got.to(want.dtype) - want).abs().max())
            assert err <= 1e-5 * float(want.abs().max()), (shape, err)


@pytest.mark.gpu
def test_gpu_dft2_rejects_what_it_cannot_take(cuda):
    from cudecomp_tpu_torch.ops import dft2 as D
    with pytest.raises(ValueError, match="complex64"):
        D.dft2(torch.zeros(2, 8, 128, device=cuda, dtype=torch.complex128))
    with pytest.raises(ValueError, match="contiguous"):
        D.dft2(torch.zeros(2, 128, 8, device=cuda,
                           dtype=torch.complex64).transpose(1, 2))
    # shapes outside the gate: no plan, no launch
    before = D.launch_count
    for shape in ((2, 8, 512), (1, 2048, 128), (1, 12, 128), (1, 8, 64)):
        with pytest.raises(ValueError, match="K5 takes planes"):
            D.dft2(torch.zeros(shape, device=cuda, dtype=torch.complex64))
    # the C entry refuses a layout it cannot hold; the wrapper raises
    lib = D._lib()
    x = torch.zeros((1, 256, 256), device=cuda, dtype=torch.complex64)
    tw = D.twiddles(256, x.dtype, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for cluster, chunk in ((1, 16), (3, 16), (8, 48), (16, 16)):
        assert lib.cudecomp_dft2(x.data_ptr(), x.data_ptr(), tw.data_ptr(),
                                 tw.data_ptr(), 1, 256, 256, cluster, chunk,
                                 0, 1.0, stream) != 0
    assert D.launch_count == before


@pytest.mark.gpu
def test_gpu_spectral_poisson_launches_k5_twice(cuda, monkeypatch):
    # the knob on: a split-complex r2c solve on a CUDA grid launches K5 for
    # the forward and the inverse, and gives the CPU's numbers
    from cudecomp_tpu_torch.ops import dft2 as D
    monkeypatch.setenv("CUDECOMP_TPU_FFT_FUSED2", "1")
    cfg = ct.GridConfig(gdims=(16, 8, 128), pdims=(1, 1))
    cpu, gpu = ct.make_grid(cfg, "cpu"), ct.make_grid(cfg, cuda)
    f = torch.from_numpy(np.random.default_rng(4).standard_normal(
        cfg.gdims).astype(np.float32))
    before = D.launch_count
    got = ct.models.PoissonSolver(grid=gpu, split_complex=True).solve(
        f.to(cuda))
    assert D.launch_count == before + 2
    want = ct.models.PoissonSolver(grid=cpu, split_complex=True).solve(f)
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


@pytest.mark.gpu
def test_gpu_dft2_smem_bytes_match_the_plan(cuda):
    # dft2_plan picks K5's layout with the Python smem_bytes; the launch
    # sizes its shared memory with the C one: the two agree on every layout
    # of every gate shape
    from cudecomp_tpu_torch.ops import dft2 as D
    lib = D._lib()
    for n1 in range(8, 257, 8):
        for n2 in (128, 256):
            for cluster in D.CLUSTERS:
                for chunk in D.CHUNKS:
                    assert lib.cudecomp_dft2_smem_bytes(
                        n1, n2, cluster, chunk) == D.smem_bytes(
                        n1, n2, cluster, chunk), (n1, n2, cluster, chunk)
            plan = D.dft2_plan(n1, n2)
            assert lib.cudecomp_dft2_smem_bytes(
                n1, n2, plan.cluster, plan.chunk) == plan.smem


# -- K2, K2s and K3 on the card ------------------------------------------------

@pytest.mark.gpu
def test_gpu_a2a_smoke_is_bit_equal(cuda, tmp_path):
    # K2s: K2's single-rank program and K1, on a one-rank gloo group
    import torch.distributed as dist
    from cudecomp_tpu_torch.ops import peer_kernels as PK
    from cudecomp_tpu_torch.parallel import symmetric
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        before = PK.a2a_launch_count
        cuda_before = PK.a2a_cuda_launch_count
        assert PK.a2a_smoke(1024, device=cuda) is True
        assert PK.a2a_launch_count == before + 1
        for n in (1, 3, 1024):  # odd byte counts move in narrower words
            x = torch.arange(n * 7, device=cuda).to(torch.uint8)
            assert torch.equal(PK.a2a(x, None), x)
            assert torch.equal(PK.a2a(x[1:], None), x[1:])  # 1 byte off
        x = torch.randn(3 << 18, device=cuda)  # 3 MiB
        assert torch.equal(PK.a2a(x, None), x)
        # one CUDA launch per exchange at P = 1, and no workspace
        assert PK.a2a_cuda_launch_count - cuda_before == 8
        assert not symmetric._WORKSPACES
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_gpu_two_ranks_share_the_card_for_k2_and_k3(cuda, tmp_path):
    # two processes on cuda:0 over gloo: K2 (twice in a row, and in the
    # PALLAS_A2A transposes) and K3 (HaloMethod.PALLAS, periodic and not)
    # bit-equal to their plain versions on CPU copies; then K2 on blocks
    # that outgrow the workspace, which is replaced by a new one of the
    # larger size whose exchanges count from 0 (check_workspace_growth)
    from cudecomp_tpu_torch.utils.testing import (check_peer_ranks,
                                                  run_card_ranks)
    run_card_ranks(check_peer_ranks, 2, str(tmp_path / "pg"), (), 240,
                   "two ranks on one card")


@pytest.mark.gpu
def test_gpu_kernel_exchanges_never_take_their_plain_version(cuda,
                                                             monkeypatch):
    # at P > 1 a CUDA tensor launches K2 / K3 or raises: with the plain
    # versions poisoned and the library made to fail, both raise
    from cudecomp_tpu_torch.ops import halo as H
    from cudecomp_tpu_torch.ops import peer_kernels as PK
    from cudecomp_tpu_torch.parallel import collectives

    def plain(*a, **k):
        raise AssertionError("a kernel exchange took its plain version")

    fail = types.SimpleNamespace(
        cudecomp_peer_a2a=lambda *a: 700, cudecomp_peer_halo=lambda *a: 700,
        cudecomp_cuda_error_string=lambda e: b"an illegal memory access")
    ws = types.SimpleNamespace(rank=0, size=2, next_exchange=lambda: 0,
                               bases_dev=torch.zeros(2, dtype=torch.int64,
                                                     device=cuda),
                               bases_host=None, recv_bytes=1 << 20,
                               device=torch.device(cuda), launches={})
    monkeypatch.setattr(collectives, "exchange_all_to_all", plain)
    monkeypatch.setattr(H, "halo_ring", plain)
    monkeypatch.setattr(PK, "_lib", lambda: fail)
    monkeypatch.setattr(PK.symmetric, "workspace", lambda g, d, n: ws)
    monkeypatch.setattr(PK.dist, "get_world_size", lambda g=None: 2)
    monkeypatch.setattr(PK.dist, "get_rank", lambda g=None: 0)
    a2a0, halo0 = PK.a2a_launch_count, PK.halo_launch_count
    with pytest.raises(RuntimeError, match="K2 launch failed.*illegal"):
        collectives.EXCHANGES["pallas_a2a"](
            torch.zeros((8, 3), device=cuda), object(), 2, 4)
    cfg = ct.GridConfig(gdims=(8, 8, 8), pdims=(2, 1),
                        halo_method=ct.HaloMethod.PALLAS)
    grid = types.SimpleNamespace(config=cfg, axis_names=("pr", "pc"),
                                 group=lambda name: object())
    with pytest.raises(RuntimeError, match="K3 launch failed.*illegal"):
        H._update_dim(grid, torch.zeros((10, 6, 10), device=cuda), 1, True,
                      1, 1, 4, 0, 2, (4, 4))
    assert (PK.a2a_launch_count, PK.halo_launch_count) == (a2a0, halo0)
