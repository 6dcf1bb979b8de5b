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
signal and no workspace.

How the ranks of an exchange wait for each other is a pure function too,
:func:`sync_schedule`: each rank's stream operations for exchange e, in
order, the puts into half e % 2 of the peers' receive regions, a signal
of e + 1 to every other rank of the group, a wait for theirs and the
unpacks.  The signal and the wait are stream memory operations of the
driver, not kernels: no kernel spins while a rank waits.  The tests run
the schedules of all ranks under random interleavings
(``tests/test_torch_peer_sync.py``).  A stream wait has no timer, so a
:class:`Watchdog` thread watches two CUDA events around each exchange
and ends the process, naming the rank and the epoch, when one has waited
:data:`WAIT_BOUND_S` seconds for its peers.

The host path of an exchange is cached on its workspace per plan and
pointer alignment (:class:`_Launch`: the plan's device tables, the word
size and the ctypes arguments), so a call costs a lookup, the epoch
increment, two event records and one ctypes call.

:func:`a2a` and :func:`halo_exchange` launch their kernels on a CUDA
tensor or raise.  The callers choose the plain versions for CPU tensors,
as the JAX package does off the TPU (``pallas_kernels.py:196-197``):
``parallel/collectives.exchange_pallas_a2a`` takes ``exchange_all_to_all``
and ``ops/halo.py`` its ``ppermute`` ring.  ``a2a_launch_count`` and
``halo_launch_count`` count exchanges (one exchange, its CUDA launches
together, is one launch); ``a2a_cuda_launch_count`` and
``halo_cuda_launch_count`` add up the kernels that the C entries report
they launched (1 per K2 exchange at P = 1, 2 per exchange at P > 1), and
``a2a_memop_count`` and ``halo_memop_count`` the stream memory operations
(2 (P - 1) per exchange at P > 1).
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
import sys
import threading
import time
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.distributed as dist

from cudecomp_tpu_torch.ops import cuda_kernels
from cudecomp_tpu_torch.parallel import symmetric
from cudecomp_tpu_torch.utils import cuda_build

SOURCES = ("peer.cu",)
_INT_OUT = ctypes.POINTER(ctypes.c_int)  # out: kernels, memory operations
_EXCHANGE_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64,
                  ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                  ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                  ctypes.c_int64, ctypes.c_void_p, _INT_OUT, _INT_OUT)
SIGNATURES = (
    ("cudecomp_peer_sync_caps", (_INT_OUT,), ctypes.c_int),
    ("cudecomp_peer_a2a", (ctypes.c_void_p, ctypes.c_void_p)
     + _EXCHANGE_ARGS, ctypes.c_int),
    ("cudecomp_peer_copy", (ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                            _INT_OUT),
     ctypes.c_int),
    ("cudecomp_peer_halo", (ctypes.c_void_p,) + _EXCHANGE_ARGS,
     ctypes.c_int),
)
#: csrc/peer.cu returns DRIVER_ERROR + the CUresult of a failed stream
#: memory operation
DRIVER_ERROR = 10000
_SYNC_STATUS = {1: "a driver entry point of the stream memory operations is "
                   "missing",
                2: "a device attribute query failed",
                3: "the device has no 64-bit stream memory operations "
                   "(CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS)"}
#: the receive region of a workspace is two halves, one per epoch parity
HALVES = 2
#: K2 exchanges (K2s included) since the last :func:`reset_launch_counts`
a2a_launch_count = 0
#: K2's kernels, as its C entries report them, since the last
#: :func:`reset_launch_counts`
a2a_cuda_launch_count = 0
#: K2's stream memory operations, as its C entry reports them
a2a_memop_count = 0
#: K3 exchanges since the last :func:`reset_launch_counts`
halo_launch_count = 0
#: K3's kernels and stream memory operations, as its C entry reports them
halo_cuda_launch_count = 0
halo_memop_count = 0


def reset_launch_counts() -> None:
    global a2a_launch_count, a2a_cuda_launch_count, a2a_memop_count
    global halo_launch_count, halo_cuda_launch_count, halo_memop_count
    a2a_launch_count = a2a_cuda_launch_count = a2a_memop_count = 0
    halo_launch_count = halo_cuda_launch_count = halo_memop_count = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The library, built and probed, on a device that can run its stream
    memory operations; raises otherwise (no exchange could run)."""
    lib = cuda_build.load("peer", SOURCES, SIGNATURES)
    caps = (ctypes.c_int * 2)()
    status = lib.cudecomp_peer_sync_caps(caps)
    if status:
        raise RuntimeError(f"K2 and K3 cannot synchronise on "
                           f"{torch.cuda.get_device_name()}: "
                           f"{_SYNC_STATUS.get(status, status)}")
    return lib


def build():
    """Compile (if needed) and load K2 and K3 (K0 probes them; the device
    must offer 64-bit stream memory operations); returns the library's
    path."""
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
    moves bytes with (K2: the whole group, itself included; K3: the
    neighbours it puts to, which are those that put to it; none at P = 1);
    the ranks it signals and waits for are :func:`sync_peers`'s.
    ``recv_bytes``: the receive region it needs."""
    peers: Tuple[int, ...]
    puts: Tuple[Move, ...]
    unpacks: Tuple[Move, ...]
    recv_bytes: int


def a2a_plan(P: int, me: int, block_bytes: int) -> Plan:
    """K2's plan for group rank ``me`` of ``P`` (``_a2a_kernel``): the self
    block goes straight to the output (the local DMA, ``:104-110``), block
    ``p`` to rank p's receive region, in slot ``me - (me > p)`` of its P-1
    senders, in the Pallas kernel's order me, me+1, ... (``:105-124``);
    after the wait the P-1 received blocks are copied out, two runs
    around the self block.  At P = 1 there is no peer, no signal and no
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


# -- the synchronisation -------------------------------------------------------

class StreamOp(NamedTuple):
    """One operation of a rank's stream in exchange ``epoch``
    (``csrc/peer.cu``).  ``kind``: ``"puts"`` and ``"unpacks"`` (one
    kernel each, running ``moves`` in half ``half`` of the receive
    regions), ``"signal"`` (stream writes of ``value`` into this rank's
    slot of the pads of ``ranks``) or ``"wait"`` (stream waits until the
    slots of ``ranks`` in this rank's pad are >= ``value``)."""
    kind: str
    epoch: int
    half: int
    moves: Tuple[Move, ...] = ()
    ranks: Tuple[int, ...] = ()
    value: int = 0


def sync_peers(P: int, me: int) -> Tuple[int, ...]:
    """The ranks that rank ``me`` of ``P`` signals and waits for in every
    exchange: every other rank of the group, whatever the plan (see
    :func:`sync_schedule`)."""
    return tuple(r for r in range(P) if r != me)


def sync_schedule(plan: Plan, me: int, P: int, e: int) -> Tuple[StreamOp, ...]:
    """Rank ``me``'s stream operations, in order, for exchange ``e`` of
    ``plan`` over ``P`` ranks, as ``csrc/peer.cu`` issues them: the puts
    into half ``e % 2`` of the peers' receive regions, a signal of
    ``e + 1`` to every other rank, a wait for their ``e + 1`` and the
    unpacks from half ``e % 2``.  At P = 1 (K2s) the puts alone.

    Two halves instead of an entry barrier: a put of exchange e into rank
    q's half must follow q's unpack of e - 2 from it, and it follows this
    rank's wait of e - 1, which q's signal of e - 1, issued after that
    unpack, satisfies.  The wait of e - 1 covers q only if every exchange
    waits for every rank, so that exchanges of other plans (K2 and K3, a
    non-periodic edge) may share the workspace."""
    half = e % HALVES
    puts = StreamOp("puts", e, half, plan.puts)
    if P == 1:
        return (puts,)
    peers = sync_peers(P, me)
    return (puts, StreamOp("signal", e, half, ranks=peers, value=e + 1),
            StreamOp("wait", e, half, ranks=peers, value=e + 1),
            StreamOp("unpacks", e, half, plan.unpacks))


#: seconds an exchange may wait for its peers, counted from when its stream
#: has run everything before it, before the watchdog ends the process
WAIT_BOUND_S = 20.0
#: how often the watchdog looks at the exchanges in flight
POLL_S = 0.1
#: the exit status of a process that the watchdog ends
LOST_PEER_EXIT = 70


def _end_process(message: str) -> None:
    sys.stderr.write(message + "\n")
    sys.stderr.flush()
    os._exit(LOST_PEER_EXIT)


class _Pending:
    __slots__ = ("what", "rank", "size", "epoch", "peers", "reached", "done",
                 "since")

    def __init__(self, what, rank, size, epoch, peers, reached, done):
        self.what, self.rank, self.size, self.epoch = what, rank, size, epoch
        self.peers, self.reached, self.done = peers, reached, done
        self.since = None  # the clock when ``reached`` was first seen


class Watchdog:
    """Ends the process when an exchange has waited longer than
    :data:`WAIT_BOUND_S` seconds for its peers: a lost peer, or one that
    never makes the exchange.  A stream wait has no timer of its own, so
    each exchange is tracked by two events, ``reached`` (recorded before
    its puts) and ``done`` (after its unpacks); an exchange whose
    ``reached`` has completed and whose ``done`` has not, ``bound_s``
    seconds after ``reached`` was first seen, calls ``fail`` with a
    message naming the group rank, the group size, the epoch and the
    peers.  So the process ends between ``bound_s`` and ``bound_s`` +
    2 ``POLL_S`` seconds after its stream reached the exchange (20 to 20.2
    s by default; the puts' time counts in it).  ``poll`` looks
    once; ``track`` starts a daemon thread that polls every
    :data:`POLL_S` seconds.  ``clock``, ``fail`` and the events (anything
    with ``query()``) are parameters, so that the CPU tests drive it."""

    def __init__(self, bound_s=None, clock=time.monotonic, fail=_end_process):
        self.bound_s, self.clock, self.fail = bound_s, clock, fail
        self._pending = []
        self._lock = threading.Lock()
        self._thread = None

    def track(self, what, rank, size, epoch, peers, reached, done,
              thread=True) -> None:
        with self._lock:
            self._pending.append(_Pending(what, rank, size, epoch, peers,
                                          reached, done))
            if thread and self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="cudecomp-peer-watchdog",
                    daemon=True)
                self._thread.start()

    def poll(self) -> bool:
        """Look once; True when an exchange has waited past the bound
        (``fail`` was called)."""
        now = self.clock()
        bound = WAIT_BOUND_S if self.bound_s is None else self.bound_s
        with self._lock:
            pending = list(self._pending)
        finished = set()
        for p in pending:
            if p.done.query():
                finished.add(id(p))
                continue
            if p.since is None and p.reached.query():
                p.since = now
            if p.since is not None and now - p.since > bound:
                self.fail(f"cudecomp peer exchange: {p.what} on group rank "
                          f"{p.rank} of {p.size} waited {now - p.since:.1f}"
                          f" s (bound {bound:g} s) at epoch {p.epoch} for "
                          f"ranks {list(p.peers)} to signal: a peer is lost "
                          f"or never made this exchange; ending the process")
                return True
        with self._lock:
            self._pending = [p for p in self._pending
                             if id(p) not in finished]
        return False

    def _run(self) -> None:
        while not self.poll():
            time.sleep(POLL_S)


#: the watchdog of this process's exchanges
WATCHDOG = Watchdog()


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
    alive here), the ranks it signals and waits for, and the ctypes
    arguments before and after the epoch."""
    tables: Tuple[torch.Tensor, ...]
    peers: Tuple[int, ...]
    head: tuple
    tail: tuple


def _prepare(plan: Plan, ws, align: int) -> _Launch:
    tables = move_tables(plan, ws.rank, ws.device)
    wb = word_bytes(plan, align)
    max_words = max(mv.rows * mv.row_bytes
                    for mv in plan.puts + plan.unpacks) // wb
    peers = sync_peers(ws.size, ws.rank)
    return _Launch(tables, peers,
                   (ws.bases_dev.data_ptr(), ws.bases_host, ws.rank,
                    (ctypes.c_int * len(peers))(*peers), len(peers)),
                   (tables[0].data_ptr(), len(plan.puts),
                    tables[1].data_ptr(), len(plan.unpacks), max_words, wb,
                    ws.recv_bytes // HALVES))


def _workspace(group, device, recv_bytes: int):
    """The group's workspace, with room for two receive regions of
    ``recv_bytes`` (one per epoch parity)."""
    return symmetric.workspace(group, device, HALVES * recv_bytes)


def _check_tensor(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA tensors, got one on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous tensor")


def _raise_on(err: int, lib, what: str, rank: int, size: int) -> None:
    if err == 0:
        return
    if err >= DRIVER_ERROR:
        msg = (f"a stream memory operation failed with CUresult "
               f"{err - DRIVER_ERROR}")
    else:
        msg = lib.cudecomp_cuda_error_string(err).decode()
    raise RuntimeError(f"{what} launch failed on group rank {rank} of "
                       f"{size}: {msg} ({err})")


def _launch(entry: str, what: str, tensors, key, make_plan, ws):
    """Run the plan of ``key`` on workspace ``ws`` through the C entry
    ``entry``, whose leading arguments are the data pointers of
    ``tensors``; ``make_plan()`` builds the plan the first time the key
    (with the pointers' alignment) is seen.  The exchange is tracked by
    :data:`WATCHDOG`.  Returns the kernels and the stream memory
    operations that the entry reports it issued."""
    lib = _lib()
    ptrs = [t.data_ptr() for t in tensors]
    full = (key, _alignment(*ptrs))
    launch = ws.launches.get(full)
    if launch is None:
        launch = ws.launches[full] = _prepare(make_plan(), ws, full[1])
    launched, memops = ctypes.c_int(0), ctypes.c_int(0)
    epoch = ws.next_exchange()
    with torch.cuda.device(ws.device):
        s = torch.cuda.current_stream(ws.device)
        reached, done = torch.cuda.Event(), torch.cuda.Event()
        reached.record(s)
        err = getattr(lib, entry)(*ptrs, *launch.head, epoch, *launch.tail,
                                  s.cuda_stream, ctypes.byref(launched),
                                  ctypes.byref(memops))
        done.record(s)
    _raise_on(err, lib, what, ws.rank, ws.size)
    WATCHDOG.track(what, ws.rank, ws.size, epoch, launch.peers, reached,
                   done)
    return launched.value, memops.value


# -- K2 and K2s ----------------------------------------------------------------

def a2a(blocks: torch.Tensor, group) -> torch.Tensor:
    """K2: the one-sided all-to-all of the CUDA tensor ``blocks`` (P equal
    blocks along dim 0, block p for group rank p) over ``group``; returns a
    new tensor holding in block q what rank q sent.  At P = 1 it is K2s's
    program: one copy, no signal, no workspace."""
    global a2a_launch_count, a2a_cuda_launch_count, a2a_memop_count
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
        launches, memops = launched.value, 0
    else:
        ws = _workspace(group, blocks.device, (P - 1) * bb)
        launches, memops = _launch(
            "cudecomp_peer_a2a", "K2", (blocks, out), ("a2a", bb),
            lambda: a2a_plan(P, ws.rank, bb), ws)
    a2a_launch_count += 1
    a2a_cuda_launch_count += launches
    a2a_memop_count += memops
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
    global halo_launch_count, halo_cuda_launch_count, halo_memop_count
    P = dist.get_world_size(group)
    if len(splits) != P:
        raise ValueError(f"{len(splits)} splits for a group of {P} ranks")
    _check_tensor(arr, "K3")
    plan = halo_plan(tuple(arr.shape), arr.element_size(), i_d, h, m, splits,
                     dist.get_rank(group), periodic)
    ws = _workspace(group, arr.device, plan.recv_bytes)
    launches, memops = _launch("cudecomp_peer_halo", "K3", (arr,), plan,
                               lambda: plan, ws)
    halo_launch_count += 1
    halo_cuda_launch_count += launches
    halo_memop_count += memops
