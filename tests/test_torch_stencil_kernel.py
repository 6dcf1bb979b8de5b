"""K4's host side on the CPU: the layout rule (``stencil_plan``), the
packing of the C entry's arguments, the tensor-map cache, and the 2-byte
types, whose plain version rounds once and whose public stencil path is
held to JAX's generic bfloat16 and float16 path.  The kernel itself runs
only on the card (``test_torch_kernels.py``, ``chip_smoke.py``)."""

import ctypes
import itertools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import cudecomp_tpu as cd

import cudecomp_tpu_torch as ct
from cudecomp_tpu_torch.ops import stencil_kernel as S

DTYPES = [torch.float32, torch.float64, torch.bfloat16, torch.float16]
FACE = sorted(S.FACE_OFFSETS)
OTHER = [o for o in S.OFFSETS if o not in S.FACE_OFFSETS]


def weights_on(offsets, seed=0):
    """Nonzero weights on ``offsets`` only."""
    rng = np.random.default_rng(seed)
    w = np.zeros((3, 3, 3))
    for o in offsets:
        w[1 + o[0], 1 + o[1], 1 + o[2]] = rng.uniform(0.5, 2.0)
    return w


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_takes_the_face_instance_for_every_face_subset(dtype):
    for n in range(len(FACE) + 1):
        for subset in itertools.combinations(FACE, n):
            plan = S.stencil_plan(weights_on(subset), False, 7, dtype,
                                  (16, 16, 64))
            assert plan.instance == "face", subset


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_takes_the_dense_instance_for_any_other_tap(dtype):
    for o in OTHER:
        for base in ((), FACE):
            plan = S.stencil_plan(weights_on(base + [o] if base else [o]),
                                  True, 0, dtype, (16, 16, 64))
            assert plan.instance == "dense", o
    dense = np.random.default_rng(1).standard_normal((3, 3, 3))
    assert S.stencil_plan(dense, False, 7, dtype, (8, 8, 8)).instance == \
        "dense"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ext", [(1, 5, 3), (2, 2, 2), (7, 33, 65),
                                 (3, 9, 130), (512, 512, 512)])
@pytest.mark.parametrize("valid", [False, True])
def test_plan_fits_the_card(dtype, ext, valid):
    elem = S.KERNEL_DTYPES[dtype]
    plan = S.stencil_plan(weights_on(FACE), valid, 0 if valid else 7, dtype,
                          ext)
    mx, my, mz = ext
    # shared memory: a block fits, and MIN_BLOCKS blocks share an SM
    assert plan.smem == S.smem_bytes(dtype, plan.stages) <= S.BLOCK_SMEM
    assert S.MIN_BLOCKS[elem] * (plan.smem + 1024) <= S.SM_SMEM
    assert S.MIN_STAGES <= plan.stages <= S.MAX_STAGES
    # the grid covers the extents exactly once and fits the launch limits
    gz, gy, gx = plan.grid
    assert (gz - 1) * S.TILE_Z < mz <= gz * S.TILE_Z
    assert (gy - 1) * S.TILE_Y < my <= gy * S.TILE_Y
    assert (gx - 1) * plan.xchunk < mx <= gx * plan.xchunk
    assert gy <= 65535 and gx <= 65535
    # TMA only where the source's rows are 16-byte multiples
    assert (plan.loader == "tma") == ((mz + 2 * valid) * elem % 16 == 0)
    # a stage row is the tile and 16 bytes on each side
    assert S.pitch(elem) * elem == S.TILE_Z * elem + 32
    if ext == (512, 512, 512):
        # at least two blocks per SM of an H100
        assert gz * gy * gx >= 2 * S.SMS


def test_plan_rejects_what_k4_does_not_take():
    w = weights_on(FACE)
    for dtype in (torch.complex64, torch.int32):
        with pytest.raises(ValueError, match="K4 runs"):
            S.stencil_plan(w, False, 7, dtype, (8, 8, 8))
    with pytest.raises(ValueError, match="extents >= 1"):
        S.stencil_plan(w, False, 7, torch.float32, (0, 8, 8))
    with pytest.raises(ValueError, match="launch limits"):
        S.stencil_plan(w, False, 7, torch.float32, (1, 16 * 65536, 8))
    # unaligned pointers take cp.async
    assert S.stencil_plan(w, False, 7, torch.float32, (8, 8, 64),
                          aligned=False).loader == "cp.async"


class FakeLib:
    """Records the C entry's arguments and the tensor maps it encodes."""

    def __init__(self):
        self.calls, self.encoded = [], []

    def cudecomp_stencil27(self, *args):
        # the weights and maps, read while their buffers are alive
        self.weights = list((ctypes.c_double * 27).from_address(args[13]))
        self.maps = None if args[19] is None else bytes(
            (ctypes.c_ubyte * (3 * S.MAP_BYTES)).from_address(args[19]))
        self.calls.append(args)
        return 0

    def cudecomp_stencil27_encode_map(self, dst, ptr, d0, d1, d2, code):
        self.encoded.append((ptr, d0, d1, d2, code))
        ctypes.memset(dst, len(self.encoded), S.MAP_BYTES)
        return 0


@pytest.mark.parametrize("loader", ["tma", "cp.async"])
def test_launch_packs_the_c_entrys_arguments(loader):
    S._maps_cache.clear()
    lib = FakeLib()
    u = torch.zeros((4, 5, 8), dtype=torch.bfloat16)
    out = torch.empty_like(u)
    gx = (torch.zeros((1, 5, 8), dtype=u.dtype),
          torch.zeros((1, 5, 8), dtype=u.dtype))
    planes = [*gx, None, None, None, None]
    w = weights_on(FACE)
    plan = S.stencil_plan(w, False, 6, u.dtype, (4, 5, 8))._replace(
        loader=loader)
    assert S._launch(lib, u, out, planes, (4, 5, 8), 6, False, w, plan,
                     1234) == 0
    (args,) = lib.calls
    assert args[:2] == (u.data_ptr(), out.data_ptr())
    assert args[2:8] == (gx[0].data_ptr(), gx[1].data_ptr(), None, None,
                         None, None)
    assert args[8:13] == (4, 5, 8, 6, 0)
    assert lib.weights == w.ravel().tolist()
    assert args[14:19] == (S.DTYPE_CODES[torch.bfloat16], 1,
                           int(loader == "tma"), plan.xchunk, plan.stages)
    assert args[20] == 1234
    if loader == "cp.async":
        assert args[19] is None and not lib.encoded
    else:
        # the block and the two x ghost planes, (d0, d1, d2) innermost first
        assert lib.encoded == [(u.data_ptr(), 8, 5, 4, 2),
                               (gx[0].data_ptr(), 8, 5, 1, 2),
                               (gx[1].data_ptr(), 8, 5, 1, 2)]
        assert [lib.maps[i * S.MAP_BYTES] for i in range(3)] == [1, 2, 3]


def test_tensor_maps_are_encoded_once_per_block():
    S._maps_cache.clear()
    lib = FakeLib()
    u = torch.zeros((4, 5, 8))
    first = S.tensor_maps(lib, u, (None, None))
    assert len(lib.encoded) == 1  # a wrapping x encodes no ghost planes
    assert S.tensor_maps(lib, u, (None, None)) is first
    assert len(lib.encoded) == 1
    # another shape of the same storage is another map
    S.tensor_maps(lib, u.view(4, 10, 4), (None, None))
    assert len(lib.encoded) == 2
    for i in range(S.MAP_CACHE + 1):
        S.tensor_maps(lib, torch.zeros((1, 1, 4 + i)), (None, None))
    assert len(S._maps_cache) == S.MAP_CACHE
    lib.cudecomp_stencil27_encode_map = lambda *a: 1
    with pytest.raises(RuntimeError, match="refused"):
        S.tensor_maps(lib, torch.zeros((2, 2, 4)), (None, None))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("ghost", [False, True])
def test_two_byte_plain_version_rounds_once(dtype, ghost):
    # stencil27_ref of a 2-byte block is the float32 sum, rounded once
    rng = np.random.default_rng(4)
    u = torch.from_numpy(rng.standard_normal((5, 6, 7))).to(dtype)
    w = rng.standard_normal((3, 3, 3))
    ghosts = None
    if ghost:
        ghosts = [None, (torch.from_numpy(rng.standard_normal((5, 1, 7))).to(
            dtype),) * 2, None]
        w = weights_on(FACE)
    else:
        u = torch.nn.functional.pad(u, (1, 1, 1, 1, 1, 1))
    up = None if ghosts is None else [
        None if g is None else tuple(p.float() for p in g) for g in ghosts]
    got = S.stencil27_ref(u, w, ghosts)
    assert got.dtype == dtype
    assert torch.equal(got, S.stencil27_ref(u.float(), w, up).to(dtype))


PERIODS = {"periodic": (True, True, True),
           "non-periodic": (False, False, False),
           "mixed": (True, False, True),
           "x-dirichlet": (False, True, True)}
#: the type's epsilon (its spacing at 1)
EPS = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
JAX_DTYPES = {torch.bfloat16: (jnp.bfloat16, ml_dtypes.bfloat16),
              torch.float16: (jnp.float16, np.float16)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("gdims", [(8, 8, 8), (16, 12, 10)])
@pytest.mark.parametrize("periods", list(PERIODS))
def test_two_byte_stencil_path_matches_jax(dtype, gdims, periods):
    # JAX's generic path rounds every product and partial sum to the type;
    # the port (and K4) sums in float32 and rounds once.  The two differ by
    # the per-op rounding, held here to 2 eps x sum|w| x max|u| (seen: up to
    # 0.52 eps on these inputs).
    jdt, ndt = JAX_DTYPES[dtype]
    jg = cd.make_grid(cd.GridConfig(gdims=gdims, pdims=(1, 1)),
                      devices=jax.devices()[:1])
    tg = ct.make_grid(ct.GridConfig(gdims=gdims, pdims=(1, 1)), "cpu")
    x = np.random.default_rng(0).standard_normal(gdims).astype(ndt)
    ju = cd.scatter_global(jg, jnp.asarray(x, dtype=jdt), 0)
    tu = ct.scatter_global(tg, torch.from_numpy(x.astype(np.float32)).to(
        dtype), 0)
    w = np.random.default_rng(1).standard_normal((3, 3, 3))
    p = PERIODS[periods]
    umax = float(np.abs(x.astype(np.float64)).max())
    # one jit of the three JAX calls: eager JAX compiles every op apart
    want = jax.jit(lambda v: (cd.stencil_apply(jg, v, w, 0, p),
                              cd.laplacian7(jg, v, 0, p),
                              cd.diffusion_step(jg, v, 0.1, 0, p)))(ju)
    got = (ct.stencil_apply(tg, tu, w, 0, p), ct.laplacian7(tg, tu, 0, p),
           ct.diffusion_step(tg, tu, 0.1, 0, p))
    wsums = (np.abs(w).sum(), 12.0, abs(1 - 0.6) + 0.6)
    for got, want, wsum in zip(got, want, wsums):
        assert got.dtype == dtype and want.dtype == jdt
        err = np.abs(got.double().numpy()
                     - np.asarray(want).astype(np.float64)).max()
        assert err <= 2 * EPS[dtype] * wsum * umax, err


def test_two_byte_cuda_tensors_take_the_kernel():
    # bfloat16 and float16 pass K4's dtype rule (a meta tensor then fails
    # only for its device); complex and integer tensors raise on the rule
    for dtype in (torch.bfloat16, torch.float16):
        with pytest.raises(ValueError, match="CUDA tensors"):
            S.stencil27(torch.empty(4, 4, 4, dtype=dtype, device="meta"),
                        weights_on(FACE), (None,) * 3)
    for dtype in (torch.complex64, torch.int32):
        with pytest.raises(ValueError, match="float16 on CUDA tensors"):
            S.stencil27(torch.empty(4, 4, 4, dtype=dtype, device="meta"),
                        weights_on(FACE), (None,) * 3)


def test_ptxas_report_groups_lines_by_kernel(monkeypatch, tmp_path):
    # the tools and chip_smoke.py print each kernel's registers and spills
    # from nvcc -Xptxas -v; the report pairs each entry function with its
    # lines
    from cudecomp_tpu_torch.utils import cuda_build
    out = ("ptxas info    : Compiling entry function '_Z1kIfEv' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z1kIfEv\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n"
           "ptxas info    : Used 90 registers, used 1 barriers\n"
           "ptxas info    : Compiling entry function '_Z1kIdEv' for 'sm_90a'\n"
           "ptxas info    : Used 140 registers\n")
    calls = []
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: tmp_path / "nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "run", lambda cmd, **kw: (
        calls.append(cmd) or type("R", (), {"stderr": out})()))
    assert cuda_build.ptxas_report(("stencil27.cu",)) == [
        ["_Z1kIfEv", "0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                     "spill loads; Used 90 registers, used 1 barriers"],
        ["_Z1kIdEv", "Used 140 registers"]]
    (cmd,) = calls
    assert "-Xptxas" in cmd and "-v" in cmd and "-shared" not in cmd
