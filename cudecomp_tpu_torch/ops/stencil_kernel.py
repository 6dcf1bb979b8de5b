"""K4, the 27-point stencil kernel: a weighted 3x3x3 stencil in CUDA for
Hopper.

Replaces ``cudecomp_tpu/ops/stencil.py``: ``_stencil27_kernel``, launched
by ``_ghost_plane_call``.  Source: ``csrc/stencil27.cu``, built by
:mod:`cudecomp_tpu_torch.utils.cuda_build` at first use (K0 probes it at
load).

``out[i,j,k] = sum w[1+dx,1+dy,1+dz] * E[i+dx, j+dy, k+dz]`` over the
nonzero taps, in memory-dim order, with the taps summed in JAX's order
(``dx``, ``dy``, ``dz`` ascending) in the tensor's dtype (in float32 for
bfloat16 and float16, rounded once).  ``E`` is the block extended by one
cell per side of each dim, given in one of two input modes:

  * valid mode (``ghosts=None``): ``u`` is the extended block
    ``(mx+2, my+2, mz+2)``, and the output is ``(mx, my, mz)``;
  * ghost-plane mode: ``u`` is ``(mx, my, mz)`` and ``ghosts`` holds, per
    memory dim, either ``None`` (the dim wraps: its index is taken modulo
    the extent) or a ``(lo, hi)`` pair of ghost planes of that dim's
    one-cell thickness, ``(1, my, mz)``, ``(mx, 1, mz)`` or ``(mx, my, 1)``.
    Wrapping dims are resolved first (so an x-ghost plane is rolled along
    a wrapping y); a cell that lies in two ghost planes at once reads 0.

It is bound by device-memory bandwidth: one read and one write of the
field.  The design (a producer warp streams each plane of a 64 x 16 tile
and its ring into shared-memory stages by TMA, consumer warps read each
plane once into rolling accumulators of three output planes, no
block-wide barrier per plane) is described in the source.
:func:`stencil_plan` picks the layout of a call: the face instance for tap
sets within the centre and its faces, else the dense one; TMA where the
block's rows are 16-byte multiples at a 16-byte aligned address, else
``cp.async``; the x-chunk that fills the card in about one wave; the
stages.  The C entry refuses any other layout.

Dispatch: a tensor on the CPU takes the plain version
(:func:`stencil27_ref`), which defines what the kernel computes.  A CUDA
float32, float64, bfloat16 or float16 tensor launches the kernel or
raises; a CUDA tensor of another dtype raises ``ValueError``; nothing
falls back.  ``launch_count`` counts launches, so a run can show that it
went through the kernel.
"""

from __future__ import annotations

import collections
import ctypes
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from cudecomp_tpu_torch.utils import cuda_build

SOURCES = ("stencil27.cu",)
SIGNATURES = (
    ("cudecomp_stencil27",
     (ctypes.c_void_p,) * 8 + (ctypes.c_int64,) * 3
     + (ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p), ctypes.c_int),
    ("cudecomp_stencil27_smem_bytes", (ctypes.c_int, ctypes.c_int),
     ctypes.c_int64),
    ("cudecomp_stencil27_encode_map",
     (ctypes.c_void_p, ctypes.c_void_p) + (ctypes.c_int64,) * 3
     + (ctypes.c_int,), ctypes.c_int),
)
#: element bytes of the types the kernel is built for
KERNEL_DTYPES = {torch.float32: 4, torch.float64: 8, torch.bfloat16: 2,
                 torch.float16: 2}
#: the C entry's dtype codes
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2,
               torch.float16: 3}
OFFSETS = tuple((dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                for dz in (-1, 0, 1))
#: the centre and its six faces: the face instance's taps
FACE_OFFSETS = frozenset(o for o in OFFSETS if sum(map(abs, o)) <= 1)

# the layout of csrc/stencil27.cu
TILE_Z, TILE_Y = 64, 16        # outputs of a block's tile
ROWS = TILE_Y + 2              # ring rows of a stage
SIDE = 2 * (TILE_Z + 2) + 2 * ROWS  # patch cells of an edge tile
THREADS = 160                  # four consumer warps and one producer
MIN_STAGES, MAX_STAGES = 2, 16
STAGES = {4: 8, 8: 6, 2: 10}   # per element bytes
#: blocks per SM the kernel's register budget is cut for
MIN_BLOCKS = {4: 4, 8: 2, 2: 4}
BLOCK_SMEM = 232_448           # 227 KB: the most one block may hold
SM_SMEM = 233_472              # 228 KB of an SM, 1 KB of it per block
SMS = 132                      # H100 SXM
XCHUNK = 32                    # x planes a block marches through, at most
MAP_BYTES = 128                # one CUtensorMap
MAP_CACHE = 64                 # tensor-map sets kept per process

#: kernel launches since the last :func:`reset_launch_count`
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def _lib() -> ctypes.CDLL:
    return cuda_build.load("stencil27", SOURCES, SIGNATURES)


def build() -> Path:
    """Compile (if needed) and load K4 (K0 probes it); returns the
    library's path."""
    _lib()
    return cuda_build.library_path("stencil27",
                                   cuda_build.library_sources(SOURCES))


def as_weights(weights) -> np.ndarray:
    """The (3, 3, 3) float64 weight array; raises on another shape."""
    w = np.asarray(weights, dtype=np.float64)
    if w.shape != (3, 3, 3):
        raise ValueError(f"weights must be (3, 3, 3); got {w.shape}")
    return w


def taps(weights):
    """The nonzero taps ``((dx, dy, dz), w)`` in JAX's summation order."""
    w = as_weights(weights)
    return tuple((o, float(w[1 + o[0], 1 + o[1], 1 + o[2]]))
                 for o in OFFSETS if w[1 + o[0], 1 + o[1], 1 + o[2]] != 0.0)


def kernel_elem_bytes(dtype: torch.dtype) -> int:
    """Element bytes K4 is built for; ``ValueError`` for another dtype."""
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"K4 runs float32, float64, bfloat16 and float16 "
                         f"on CUDA tensors, got {dtype}")
    return KERNEL_DTYPES[dtype]


def pitch(elem: int) -> int:
    """Cells of a stage row: the tile and 16 bytes on each side (a TMA box
    starts at a 16-byte boundary of a row; the ring is one cell of each
    side)."""
    return TILE_Z + 2 * (16 // elem)


def stage_bytes(elem: int) -> int:
    """One stage: the ring rows of one plane and the side slots of an edge
    tile's patch cells, rounded up to 128 bytes."""
    return -(-((ROWS * pitch(elem) + SIDE) * elem) // 128) * 128


def smem_bytes(dtype: torch.dtype, stages: int) -> int:
    """Shared memory of one K4 block with ``stages`` stages
    (``csrc/stencil27.cu: smem_bytes``, which the launch uses; a ``gpu``
    test holds the two equal): the stages, then a "full" and an "empty"
    8-byte mbarrier per stage."""
    return stages * stage_bytes(kernel_elem_bytes(dtype)) + 16 * stages


class StencilPlan(NamedTuple):
    """How K4 runs one call: ``instance`` ("face" or "dense"), ``loader``
    ("tma" or "cp.async"), ``xchunk`` planes per block, ``stages``,
    ``smem`` bytes per block and the ``grid`` (z tiles, y tiles,
    x-chunks)."""
    instance: str
    loader: str
    xchunk: int
    stages: int
    smem: int
    grid: tuple


def stencil_plan(weights, valid: bool, wrap, dtype: torch.dtype, ext,
                 aligned: bool = True, sms: int = SMS) -> StencilPlan:
    """K4's layout for one call on output extents ``ext`` = (mx, my, mz).

    The face instance when every nonzero tap is the centre or a face, the
    dense one otherwise.  TMA when the source's rows are a multiple of 16
    bytes (ghost-plane mode: ``mz``; valid mode: ``mz + 2``) and its
    pointers are 16-byte aligned (``aligned``), ``cp.async`` otherwise.
    x-chunks of about :data:`XCHUNK` planes, shorter where that leaves the
    ``sms`` SMs less than one wave of blocks (:data:`MIN_BLOCKS` each):
    many short chunks let the blocks of the slower edge tiles spread over
    the card instead of setting the time of a single wave.  ``wrap`` (the
    wrapping memory dims) describes the call but moves no choice: wrapped
    and ghost cells cost the same patch.  Raises ValueError for extents
    the grid cannot cover."""
    elem = kernel_elem_bytes(dtype)
    mx, my, mz = (int(n) for n in ext)
    if min(mx, my, mz) < 1:
        raise ValueError(f"K4 needs output extents >= 1, got {ext}")
    del wrap
    face = all(o in FACE_OFFSETS for o, _ in taps(weights))
    tma = aligned and ((mz + 2 if valid else mz) * elem) % 16 == 0
    gz, gy = -(-mz // TILE_Z), -(-my // TILE_Y)
    resident = sms * MIN_BLOCKS[elem]
    chunks = min(mx, max(-(-mx // XCHUNK), -(-resident // (gz * gy))))
    xchunk = -(-mx // chunks)
    grid = (gz, gy, -(-mx // xchunk))
    if gz > 2**31 - 1 or gy > 65535 or grid[2] > 65535:
        raise ValueError(f"K4's grid {grid} exceeds the launch limits for "
                         f"extents {ext}")
    stages = STAGES[elem]
    return StencilPlan("face" if face else "dense",
                       "tma" if tma else "cp.async", xchunk, stages,
                       smem_bytes(dtype, stages), grid)


def _check(u: torch.Tensor, ghosts):
    """(mx, my, mz) of the output; raises on shapes the kernel cannot take."""
    if u.dim() != 3:
        raise ValueError(f"stencil27 takes a 3D block, got {tuple(u.shape)}")
    if ghosts is None:
        ext = tuple(n - 2 for n in u.shape)
        if min(ext) < 1:
            raise ValueError(f"valid mode needs an extended block of extents "
                             f">= 3, got {tuple(u.shape)}")
        return ext
    if len(ghosts) != 3:
        raise ValueError("ghosts must give one entry per memory dim")
    ext = tuple(u.shape)
    if min(ext) < 1:
        raise ValueError(f"stencil27 needs extents >= 1, got {ext}")
    for d, g in enumerate(ghosts):
        if g is None:
            continue
        plane = list(ext)
        plane[d] = 1
        if len(g) != 2 or any(tuple(p.shape) != tuple(plane) for p in g):
            raise ValueError(f"ghost planes of dim {d} must be a (lo, hi) "
                             f"pair of shape {tuple(plane)}")
    return ext


def _extend_ref(u: torch.Tensor, ghosts) -> torch.Tensor:
    """The extended block E of ghost-plane mode: each dim in turn, wrapped
    or between its ghost planes; a ghost plane is itself extended along the
    dims before it (wrapped, or zero where those dims are ghost dims)."""
    for d, g in enumerate(ghosts):
        if g is None:
            n = u.shape[d]
            lo, hi = u.narrow(d, n - 1, 1), u.narrow(d, 0, 1)
        else:
            lo, hi = g
            for e in range(d):
                if ghosts[e] is None:
                    lo = torch.cat([lo.narrow(e, lo.shape[e] - 1, 1), lo,
                                    lo.narrow(e, 0, 1)], dim=e)
                    hi = torch.cat([hi.narrow(e, hi.shape[e] - 1, 1), hi,
                                    hi.narrow(e, 0, 1)], dim=e)
                else:
                    pad = [0, 0] * (2 - e) + [1, 1]
                    lo = torch.nn.functional.pad(lo, pad)
                    hi = torch.nn.functional.pad(hi, pad)
        u = torch.cat([lo.to(u.dtype), u, hi.to(u.dtype)], dim=d)
    return u


def stencil27_ref(u: torch.Tensor, weights, ghosts=None) -> torch.Tensor:
    """Plain version of :func:`stencil27`: the shifted-slice sum of JAX's
    generic path (``stencil.py:465-477``) over the extended block, in
    ``u``'s dtype; for bfloat16 and float16 in float32, rounded once, as
    the kernel computes them."""
    ext = _check(u, ghosts)
    if u.element_size() == 2 and u.is_floating_point():
        up = None if ghosts is None else [
            None if g is None else tuple(p.float() for p in g)
            for g in ghosts]
        return stencil27_ref(u.float(), weights, up).to(u.dtype)
    ue = u if ghosts is None else _extend_ref(u, ghosts)
    out = None
    for (dx, dy, dz), wv in taps(weights):
        term = wv * ue[1 + dx:1 + dx + ext[0], 1 + dy:1 + dy + ext[1],
                       1 + dz:1 + dz + ext[2]]
        out = term if out is None else out + term
    if out is None:
        return u.new_zeros(ext)
    return out.to(u.dtype).contiguous()


_maps_cache: "collections.OrderedDict" = collections.OrderedDict()


def _map_key(t: torch.Tensor):
    return None if t is None else (t.data_ptr(), tuple(t.shape), t.dtype)


def tensor_maps(lib, src: torch.Tensor, gx) -> ctypes.Array:
    """The three TMA tensor maps of a launch (the source block, the x
    ghost planes below and above, or zeros where x wraps), encoded by the
    library and cached per (pointer, shape, dtype), as K2 caches its
    launch records.  Raises when the driver refuses a map."""
    key = (_map_key(src),) + tuple(_map_key(g) for g in gx)
    buf = _maps_cache.get(key)
    if buf is not None:
        _maps_cache.move_to_end(key)
        return buf
    buf = (ctypes.c_ubyte * (3 * MAP_BYTES))()
    code = DTYPE_CODES[src.dtype]
    for i, t in enumerate((src,) + tuple(gx)):
        if t is None:
            continue
        d2, d1, d0 = t.shape
        err = lib.cudecomp_stencil27_encode_map(
            ctypes.addressof(buf) + i * MAP_BYTES, t.data_ptr(), d0, d1, d2,
            code)
        if err != 0:
            raise RuntimeError(f"K4: cuTensorMapEncodeTiled refused a "
                               f"{tuple(t.shape)} {t.dtype} block at "
                               f"{t.data_ptr():#x} (CUresult {err})")
    _maps_cache[key] = buf
    while len(_maps_cache) > MAP_CACHE:
        _maps_cache.popitem(last=False)
    return buf


def _launch(lib, u, out, planes, ext, wrap, valid, w, plan, stream) -> int:
    """Packs the C entry's arguments and calls it; returns its error."""
    wbuf = (ctypes.c_double * 27)(*w.ravel().tolist())
    maps = (tensor_maps(lib, u, planes[:2]) if plan.loader == "tma"
            else None)
    return lib.cudecomp_stencil27(
        u.data_ptr(), out.data_ptr(),
        *[p.data_ptr() if p is not None else None for p in planes],
        *ext, wrap, int(valid), ctypes.addressof(wbuf),
        DTYPE_CODES[u.dtype], int(plan.instance == "face"),
        int(plan.loader == "tma"), plan.xchunk, plan.stages,
        None if maps is None else ctypes.addressof(maps), stream)


def stencil27(u: torch.Tensor, weights, ghosts=None,
              plan: StencilPlan = None) -> torch.Tensor:
    """The weighted 3x3x3 stencil of ``u`` (see the module docstring for
    the two input modes); a new ``(mx, my, mz)`` tensor.  ``plan``
    overrides :func:`stencil_plan`'s layout (the tools compare layouts);
    the C entry refuses one it cannot run."""
    global launch_count
    if u.device.type == "cpu":
        return stencil27_ref(u, weights, ghosts)
    kernel_elem_bytes(u.dtype)
    if u.device.type != "cuda":
        raise ValueError(f"K4 runs on CUDA tensors, got one on {u.device}")
    ext = _check(u, ghosts)
    planes = [None] * 6
    wrap = 0
    for d, g in enumerate(ghosts or (None,) * 3):
        if g is None:
            wrap |= 1 << d
        else:
            planes[2 * d:2 * d + 2] = g
    given = [u] + [p for p in planes if p is not None]
    for t in given:
        if t.device != u.device or t.dtype != u.dtype:
            raise ValueError("ghost planes must match the block's device "
                             "and dtype")
        if not t.is_contiguous():
            raise ValueError("K4 takes contiguous tensors; call "
                             ".contiguous() first")
    w = as_weights(weights)
    if plan is None:
        plan = stencil_plan(w, ghosts is None, wrap, u.dtype, ext,
                            aligned=all(t.data_ptr() % 16 == 0
                                        for t in given),
                            sms=_sm_count(u.device))
    out = torch.empty(ext, dtype=u.dtype, device=u.device)
    lib = _lib()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = _launch(lib, u, out, planes, ext, wrap, ghosts is None, w,
                      plan, stream)
    if err != 0:
        msg = lib.cudecomp_cuda_error_string(err).decode()
        raise RuntimeError(f"K4 launch failed for extents {ext} "
                           f"({u.dtype}, {plan}): {msg} ({err})")
    launch_count += 1
    return out


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
