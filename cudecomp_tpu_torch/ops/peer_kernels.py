"""K2 (the one-sided all-to-all), K2s (its single-rank smoke) and K3 (the
one-sided halo ring) in CUDA for Hopper, one library (``csrc/peer.cu``):
the counterpart of the RDMA kernels of ``cudecomp_tpu/ops/pallas_kernels.py``.

  * K2, :func:`a2a`: ``exchange_pallas_a2a`` (``:183``) running
    ``_a2a_kernel`` (``:84``), ``TransposeMethod.PALLAS_A2A``;
  * K2s: ``mosaic_smoke`` (``:241``), here :func:`a2a_smoke`, K2 at P = 1
    beside K1, checked bit for bit;
  * K3, :func:`halo_exchange`: ``halo_exchange_pallas`` (``:571``) running
    ``_halo_kernel`` (``:517``), ``HaloMethod.PALLAS``.

The kernels move bytes between workspaces of torch symmetric memory that
every rank of the process group maps
(:mod:`cudecomp_tpu_torch.parallel.symmetric`), so the ranks may be
processes that share one card.  What each rank moves is a pure
**plan** (:func:`a2a_plan`, :func:`halo_plan`): its peer set, its puts
(bytes of its tensor -> a peer's receive region, or K2's self block
straight to its output) and its unpacks (its own receive region -> its
tensor).  The CUDA launch uploads the plan as a table and runs it;
:func:`apply_plans` runs the plans of all P ranks in one process over
lists of P tensors, so the addressing is tested without a card.  At P = 1
K2 has no peer: its plan is one move, which runs as one launch with no
barrier and no workspace.

The host path of an exchange is cached on its workspace per plan and
pointer alignment (:class:`_Launch`: the plan's device tables, the word
size and the ctypes arguments), so a call costs a lookup, the epoch
increment and one ctypes call.

:func:`a2a` and :func:`halo_exchange` launch their kernel on a CUDA tensor
or raise.  The callers choose the plain versions for CPU tensors, as the
JAX package does off the TPU (``pallas_kernels.py:196-197``):
``parallel/collectives.exchange_pallas_a2a`` takes ``exchange_all_to_all``
and ``ops/halo.py`` its ``ppermute`` ring.  ``a2a_launch_count`` and
``halo_launch_count`` count exchanges (one exchange, its CUDA launches
together, is one launch); ``a2a_cuda_launch_count`` adds up the kernels
that K2's C entries report they launched (1 per exchange at P = 1, 4 at
P > 1).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.distributed as dist

from cudecomp_tpu_torch.ops import cuda_kernels
from cudecomp_tpu_torch.parallel import symmetric
from cudecomp_tpu_torch.utils import cuda_build

SOURCES = ("peer.cu",)
_LAUNCHED = ctypes.POINTER(ctypes.c_int)  # out: the kernels launched
_EXCHANGE_ARGS = (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                  ctypes.c_int, ctypes.c_uint64, ctypes.c_void_p,
                  ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, _LAUNCHED)
SIGNATURES = (
    ("cudecomp_peer_a2a", (ctypes.c_void_p, ctypes.c_void_p)
     + _EXCHANGE_ARGS, ctypes.c_int),
    ("cudecomp_peer_copy", (ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                            _LAUNCHED),
     ctypes.c_int),
    ("cudecomp_peer_halo", (ctypes.c_void_p,) + _EXCHANGE_ARGS,
     ctypes.c_int),
)
#: K2 exchanges (K2s included) since the last :func:`reset_launch_counts`
a2a_launch_count = 0
#: K2's CUDA launches, as its C entries report them, since the last
#: :func:`reset_launch_counts`
a2a_cuda_launch_count = 0
#: K3 exchanges since the last :func:`reset_launch_counts`
halo_launch_count = 0


def reset_launch_counts() -> None:
    global a2a_launch_count, a2a_cuda_launch_count, halo_launch_count
    a2a_launch_count = 0
    a2a_cuda_launch_count = 0
    halo_launch_count = 0


def _lib() -> ctypes.CDLL:
    return cuda_build.load("peer", SOURCES, SIGNATURES)


def build():
    """Compile (if needed) and load K2 and K3 (K0 probes them); returns the
    library's path."""
    _lib()
    return cuda_build.library_path("peer",
                                   cuda_build.library_sources(SOURCES))


# -- plans ---------------------------------------------------------------------

#: a put's ``peer`` when it writes the rank's own output tensor
OWN = -1


class Move(NamedTuple):
    """``rows`` runs of ``row_bytes`` bytes, ``src_stride`` apart at byte
    ``src`` of the source and ``dst_stride`` apart at byte ``dst`` of the
    destination.  In a put the source is the rank's tensor and the
    destination the receive region of rank ``peer``, or the rank's output
    tensor when ``peer`` is :data:`OWN`; in an unpack the source is the
    rank's own receive region and the destination its tensor."""
    peer: int
    src: int
    src_stride: int
    dst: int
    dst_stride: int
    rows: int
    row_bytes: int


class Plan(NamedTuple):
    """What one rank moves in one exchange.  ``peers``: the group ranks it
    signals and waits for (those it puts to are those that put to it; none
    means no barrier); ``recv_bytes``: the receive region it needs."""
    peers: Tuple[int, ...]
    puts: Tuple[Move, ...]
    unpacks: Tuple[Move, ...]
    recv_bytes: int


def a2a_plan(P: int, me: int, block_bytes: int) -> Plan:
    """K2's plan for group rank ``me`` of ``P`` (``_a2a_kernel``): the self
    block goes straight to the output (the local DMA, ``:104-110``), block
    ``p`` to rank p's receive region, in slot ``me - (me > p)`` of its P-1
    senders, in the Pallas kernel's order me, me+1, ... (``:105-124``);
    after the barrier the P-1 received blocks are copied out, two runs
    around the self block.  At P = 1 there is no peer, no barrier and no
    receive region (``:88``)."""
    bb = block_bytes
    puts = tuple(Move(OWN, me * bb, bb, me * bb, bb, 1, bb) if p == me
                 else Move(p, p * bb, bb, (me - (me > p)) * bb, bb, 1, bb)
                 for p in ((me + s) % P for s in range(P)))
    unpacks = tuple(Move(me, src, n, dst, n, 1, n)
                    for src, dst, n in ((0, 0, me * bb),
                                        (me * bb, (me + 1) * bb,
                                         (P - 1 - me) * bb)) if n)
    peers = tuple(range(P)) if P > 1 else ()
    return Plan(peers, puts, unpacks, (P - 1) * bb)


def halo_plan(shape: Sequence[int], itemsize: int, i_d: int, h: int, m: int,
              splits: Sequence[int], me: int, periodic: bool) -> Plan:
    """K3's plan for group rank ``me`` along array dim ``i_d`` of a
    contiguous buffer of ``shape`` (``_halo_kernel``): the high interior
    slab [v, v+h) (v = ``splits[me]``) goes to slot 0 of the right
    neighbour's receive region, for its low halo [0, h); the low slab
    [h, 2h) to slot 1 of the left neighbour's, for its high halo
    [h+m, 2h+m).  A slab is ``prod(shape[:i_d])`` rows of ``h`` planes.
    Without ``periodic`` nothing crosses the edge between rank P-1 and
    rank 0, and their edge halos keep their values (``halo.h:217-224``)."""
    P = len(splits)
    inner = itemsize * math.prod(shape[i_d + 1:])
    rows = math.prod(shape[:i_d])
    row, stride = h * inner, shape[i_d] * inner
    slab = rows * row
    v = splits[me]
    left, right = (me - 1) % P, (me + 1) % P
    has_left, has_right = periodic or me > 0, periodic or me < P - 1
    puts, unpacks = [], []
    if has_right:
        puts.append(Move(right, v * inner, stride, 0, row, rows, row))
        unpacks.append(Move(me, slab, row, (h + m) * inner, stride, rows, row))
    if has_left:
        puts.append(Move(left, h * inner, stride, slab, row, rows, row))
        unpacks.append(Move(me, 0, row, 0, stride, rows, row))
    peers = tuple(sorted({mv.peer for mv in puts}))
    return Plan(peers, tuple(puts), tuple(unpacks), 2 * slab)


def _byte_rows(buf: torch.Tensor, off: int, stride: int, rows: int,
               row_bytes: int) -> torch.Tensor:
    return buf.as_strided((rows, row_bytes), (stride, 1),
                          buf.storage_offset() + off)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    if not t.is_contiguous():
        raise ValueError("a plan addresses contiguous tensors")
    return t.reshape(-1).view(torch.uint8)


def apply_plans(plans: Sequence[Plan], srcs: Sequence[torch.Tensor],
                dsts: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """The plain executor: run the plans of all P ranks of a group in one
    process.  ``srcs[r]`` is rank r's tensor, ``dsts[r]`` the tensor its
    unpacks and its :data:`OWN` puts write (``srcs[r]`` itself for K3,
    which works in place).  Returns ``dsts``."""
    recv = [torch.zeros(p.recv_bytes, dtype=torch.uint8,
                        device=srcs[r].device) for r, p in enumerate(plans)]
    for r, plan in enumerate(plans):
        src = _bytes(srcs[r])
        for mv in plan.puts:
            dst = _bytes(dsts[r]) if mv.peer == OWN else recv[mv.peer]
            _byte_rows(dst, mv.dst, mv.dst_stride, mv.rows,
                       mv.row_bytes).copy_(
                _byte_rows(src, mv.src, mv.src_stride, mv.rows, mv.row_bytes))
    for r, plan in enumerate(plans):
        dst = _bytes(dsts[r])
        for mv in plan.unpacks:
            _byte_rows(dst, mv.dst, mv.dst_stride, mv.rows,
                       mv.row_bytes).copy_(
                _byte_rows(recv[r], mv.src, mv.src_stride, mv.rows,
                           mv.row_bytes))
    return dsts


# -- the CUDA launch -----------------------------------------------------------

def move_tables(plan: Plan, me: int, device) -> Tuple[torch.Tensor, ...]:
    """The plan's puts and unpacks as the tables the kernels read
    (``csrc/peer.cu``: one row per move of src rank, src, src stride, dst
    rank, dst, dst stride, rows, row bytes; rank -1 is the caller's
    tensor), on ``device``."""
    puts = [(-1, mv.src, mv.src_stride, mv.peer, mv.dst, mv.dst_stride,
             mv.rows, mv.row_bytes) for mv in plan.puts]
    unpacks = [(me, mv.src, mv.src_stride, -1, mv.dst, mv.dst_stride,
                mv.rows, mv.row_bytes) for mv in plan.unpacks]
    return tuple(torch.tensor(rows or [(0,) * 8], dtype=torch.int64,
                              device=device) for rows in (puts, unpacks))


def word_bytes(plan: Plan, *ptrs: int) -> int:
    """The widest word that divides every offset, stride and run of the
    plan and every address of the caller's tensors."""
    return cuda_kernels.word_bytes(
        math.gcd(*(x for mv in plan.puts + plan.unpacks
                   for x in (mv.src, mv.src_stride, mv.dst, mv.dst_stride,
                             mv.row_bytes))), *ptrs)


def _alignment(*ptrs: int) -> int:
    """The widest word (up to 16 bytes) that divides every address."""
    return math.gcd(16, *ptrs)


class _Launch(NamedTuple):
    """One plan made ready to run on a workspace: its device tables (kept
    alive here) and the ctypes arguments before and after the epoch."""
    tables: Tuple[torch.Tensor, ...]
    head: tuple
    tail: tuple


def _prepare(plan: Plan, ws, align: int) -> _Launch:
    tables = move_tables(plan, ws.rank, ws.device)
    wb = word_bytes(plan, align)
    max_words = max(mv.rows * mv.row_bytes
                    for mv in plan.puts + plan.unpacks) // wb
    peers = (ctypes.c_int * len(plan.peers))(*plan.peers)
    return _Launch(tables,
                   (ws.bases_dev.data_ptr(), ws.rank, peers, len(plan.peers)),
                   (tables[0].data_ptr(), len(plan.puts),
                    tables[1].data_ptr(), len(plan.unpacks), max_words, wb))


def _check_tensor(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA tensors, got one on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous tensor")


def _raise_on(err: int, lib, what: str, rank: int, size: int) -> None:
    if err != 0:
        msg = lib.cudecomp_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed on group rank {rank} of "
                           f"{size}: {msg} ({err})")


def _launch(entry: str, what: str, tensors, key, make_plan, ws) -> int:
    """Run the plan of ``key`` on workspace ``ws`` through the C entry
    ``entry``, whose leading arguments are the data pointers of
    ``tensors``; ``make_plan()`` builds the plan the first time the key
    (with the pointers' alignment) is seen.  Returns the CUDA launches
    that the entry reports it made."""
    lib = _lib()
    ptrs = [t.data_ptr() for t in tensors]
    full = (key, _alignment(*ptrs))
    launch = ws.launches.get(full)
    if launch is None:
        launch = ws.launches[full] = _prepare(make_plan(), ws, full[1])
    launched = ctypes.c_int(0)
    with torch.cuda.device(ws.device):
        stream = torch.cuda.current_stream(ws.device).cuda_stream
        err = getattr(lib, entry)(*ptrs, *launch.head, ws.next_exchange(),
                                  *launch.tail, stream,
                                  ctypes.byref(launched))
    _raise_on(err, lib, what, ws.rank, ws.size)
    return launched.value


# -- K2 and K2s ----------------------------------------------------------------

def a2a(blocks: torch.Tensor, group) -> torch.Tensor:
    """K2: the one-sided all-to-all of the CUDA tensor ``blocks`` (P equal
    blocks along dim 0, block p for group rank p) over ``group``; returns a
    new tensor holding in block q what rank q sent.  At P = 1 it is K2s's
    program: one copy, no barrier, no workspace."""
    global a2a_launch_count, a2a_cuda_launch_count
    P = dist.get_world_size(group)
    if blocks.dim() < 1 or blocks.shape[0] % P:
        raise ValueError(f"K2 needs {P} equal blocks along dim 0, got shape "
                         f"{tuple(blocks.shape)}")
    _check_tensor(blocks, "K2")
    out = torch.empty_like(blocks)
    if blocks.numel() == 0:
        return out
    bb = blocks.numel() * blocks.element_size() // P
    if P == 1:
        lib = _lib()
        wb = cuda_kernels.word_bytes(bb, blocks.data_ptr(), out.data_ptr())
        launched = ctypes.c_int(0)
        with torch.cuda.device(blocks.device):
            stream = torch.cuda.current_stream(blocks.device).cuda_stream
            err = lib.cudecomp_peer_copy(blocks.data_ptr(), out.data_ptr(),
                                         bb // wb, wb, stream,
                                         ctypes.byref(launched))
        _raise_on(err, lib, "K2", 0, 1)
        launches = launched.value
    else:
        ws = symmetric.workspace(group, blocks.device, (P - 1) * bb)
        launches = _launch("cudecomp_peer_a2a", "K2", (blocks, out),
                           ("a2a", bb), lambda: a2a_plan(P, ws.rank, bb), ws)
    a2a_launch_count += 1
    a2a_cuda_launch_count += launches
    return out


def a2a_smoke(n: int = 1024, group=None, device="cuda") -> bool:
    """K2s (``mosaic_smoke``): K2's single-rank program on an (n, 256)
    float32 ramp over a one-rank ``group`` (the default group when None),
    and K1's tiled transpose of it; True when both are bit-equal to what
    they must be.  On the CPU both take their plain versions (K2's is
    :func:`apply_plans`)."""
    if dist.get_world_size(group) != 1:
        raise ValueError("a2a_smoke runs on a one-rank process group")
    x = torch.arange(n * 256, dtype=torch.float32,
                     device=device).reshape(n, 256)
    if x.device.type == "cpu":
        got = apply_plans([a2a_plan(1, 0, x.numel() * x.element_size())],
                          [x], [torch.empty_like(x)])[0]
    else:
        got = a2a(x, group)
    return torch.equal(got, x) and torch.equal(cuda_kernels.transpose2d(x),
                                               x.t())


# -- K3 ------------------------------------------------------------------------

def halo_exchange(arr: torch.Tensor, group, i_d: int, h: int, m: int,
                  splits: Sequence[int], periodic: bool) -> None:
    """K3: update the two halos of array dim ``i_d`` of the CUDA tensor
    ``arr`` in place (``halo_exchange_pallas``), width ``h``, max split
    ``m``, rank r's valid extent ``splits[r]``."""
    global halo_launch_count
    P = dist.get_world_size(group)
    if len(splits) != P:
        raise ValueError(f"{len(splits)} splits for a group of {P} ranks")
    _check_tensor(arr, "K3")
    plan = halo_plan(tuple(arr.shape), arr.element_size(), i_d, h, m, splits,
                     dist.get_rank(group), periodic)
    ws = symmetric.workspace(group, arr.device, plan.recv_bytes)
    _launch("cudecomp_peer_halo", "K3", (arr,), plan, lambda: plan, ws)
    halo_launch_count += 1
