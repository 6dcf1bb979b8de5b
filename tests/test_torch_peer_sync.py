"""The synchronisation of K2 and K3 (``csrc/peer.cu``) on the CPU.

``ops.peer_kernels.sync_schedule`` gives each rank's stream operations for
one exchange: the puts into half e % 2 of the peers' receive regions, a
signal of e + 1 to every other rank, a wait for theirs, the unpacks.  Here
the schedules of all P ranks of a group run together over a sequence of
exchanges on one workspace, one operation (or one move of a kernel) at a
time, in random interleavings: a signal writes the peers' pad slots, a
wait runs only once its slots have the value, and every byte of a receive
region carries the epoch of the put that filled it.  Three things must
hold in every interleaving:

  * no put lands in a slot before its owner has unpacked that slot's
    previous epoch;
  * every unpack reads its own epoch's data;
  * every exchange's result equals ``apply_plans``, bit for bit.

The schedules that leave out the design's parts (peers-only signals, one
receive half, no wait) must break them, which shows that the checks can
fail.  A rank whose signal is lost leaves its peers waiting, and the
watchdog ends the process naming the rank and the epoch.  The gpu test at
the end shows the watchdog on the card.
"""

import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from cudecomp_tpu_torch.ops import peer_kernels as PK

ROOT = Path(__file__).resolve().parents[1]
SEEDS = 30


class Race(AssertionError):
    pass


def _index(off, stride, rows, row_bytes):
    return (off + stride * np.arange(rows)[:, None]
            + np.arange(row_bytes)[None, :]).ravel()


def _bytes(t):
    return t.reshape(-1).view(torch.uint8).numpy()


def simulate(exchanges, P, rng, schedule=PK.sync_schedule, drop=None):
    """Run ``exchanges`` (a list of (plans, srcs, dsts), one tensor per
    rank) in order on one workspace of ``P`` ranks, the ranks' stream
    operations interleaved by ``rng``; ``drop`` = (rank, epoch) loses that
    rank after its puts of that epoch: its signal never comes.  Raises
    :class:`Race` on a put or an unpack out of order; returns the (rank,
    epoch) of every rank left waiting."""
    half = max(p.recv_bytes for plans, _, _ in exchanges for p in plans)
    recv = [np.zeros(PK.HALVES * half, np.uint8) for _ in range(P)]
    tag = [np.full(PK.HALVES * half, -1, np.int64) for _ in range(P)]
    pad = np.zeros((P, P), np.int64)  # pad[owner, sender]
    queues = [[op for e, (plans, _, _) in enumerate(exchanges)
               for op in schedule(plans[r], r, P, e)]
              for r in range(P)]
    if drop is not None:  # the rank is lost after its puts of that epoch
        r, e = drop
        queues[r] = [op for op in queues[r] if op.epoch < e
                     or (op.epoch == e and op.kind == "puts")]
    pos, left = [0] * P, [None] * P

    def runnable(r):
        if pos[r] == len(queues[r]):
            return False
        op = queues[r][pos[r]]
        return op.kind != "wait" or all(pad[r, p] >= op.value
                                        for p in op.ranks)

    def put(r, op, mv):
        _, srcs, dsts = exchanges[op.epoch]
        data = _bytes(srcs[r])[_index(mv.src, mv.src_stride, mv.rows,
                                      mv.row_bytes)]
        at = _index(mv.dst, mv.dst_stride, mv.rows, mv.row_bytes)
        if mv.peer == PK.OWN:
            _bytes(dsts[r])[at] = data
            return
        at = at + op.half * half
        held = tag[mv.peer][at]
        if (held != -1).any():
            raise Race(f"rank {r}'s put of epoch {op.epoch} lands in rank "
                       f"{mv.peer}'s half {op.half} before it unpacked "
                       f"epoch {held.max()}")
        tag[mv.peer][at] = op.epoch
        recv[mv.peer][at] = data

    def unpack(r, op, mv):
        at = _index(mv.src, mv.src_stride, mv.rows, mv.row_bytes)
        at = at + op.half * half
        held = tag[r][at]
        if (held != op.epoch).any():
            raise Race(f"rank {r}'s unpack of epoch {op.epoch} reads "
                       f"epochs {sorted(set(held.tolist()))}")
        tag[r][at] = -1
        _, _, dsts = exchanges[op.epoch]
        _bytes(dsts[r])[_index(mv.dst, mv.dst_stride, mv.rows,
                               mv.row_bytes)] = recv[r][at]

    while True:
        ready = [r for r in range(P) if runnable(r)]
        if not ready:
            break
        r = ready[rng.integers(len(ready))]
        op = queues[r][pos[r]]
        if op.kind in ("puts", "unpacks"):
            if left[r] is None:  # the kernel's blocks run in any order
                left[r] = [op.moves[i] for i in rng.permutation(len(op.moves))]
            if left[r]:
                (put if op.kind == "puts" else unpack)(r, op, left[r].pop())
            if not left[r]:
                left[r] = None
                pos[r] += 1
        else:
            if op.kind == "signal":
                for p in op.ranks:
                    assert pad[p, r] <= op.value  # a slot only grows
                    pad[p, r] = op.value
            pos[r] += 1
    return [(r, queues[r][pos[r]].epoch) for r in range(P)
            if pos[r] < len(queues[r])]


# -- the exchanges ------------------------------------------------------------

def k2(P, rng):
    bb = 8 * int(rng.integers(1, 4))
    srcs = [torch.from_numpy(rng.integers(0, 256, P * bb, dtype=np.uint8))
            for _ in range(P)]
    return ([PK.a2a_plan(P, r, bb) for r in range(P)], srcs,
            [torch.zeros_like(s) for s in srcs])


def k3(P, rng, periodic, i_d=1):
    h, m = 1, 3
    splits = (m,) * (P - 1) + (m - 1,)  # uneven, as tests/test_pallas.py
    shape = [2, 3, 2]
    shape[i_d] = m + 2 * h
    bufs = [torch.from_numpy(rng.integers(0, 256, (*shape, 4),
                                          dtype=np.uint8)).view(torch.int32)
            .squeeze(-1) for _ in range(P)]
    plans = [PK.halo_plan(tuple(shape), 4, i_d, h, m, splits, r, periodic)
             for r in range(P)]
    return plans, bufs, bufs  # in place


SCENARIOS = {
    "k2": lambda P, rng: [k2(P, rng) for _ in range(4)],
    "k3-periodic": lambda P, rng: [k3(P, rng, True, i) for i in (0, 1, 2, 1)],
    "k3-open": lambda P, rng: [k3(P, rng, False, i) for i in (1, 0, 2, 1)],
    # K2 and K3 with other peer sets on one workspace
    "mixed": lambda P, rng: [k2(P, rng), k3(P, rng, False), k2(P, rng),
                             k3(P, rng, True), k3(P, rng, False), k2(P, rng)],
}


def expected(exchanges):
    out = []
    for plans, srcs, dsts in exchanges:
        s = [t.clone() for t in srcs]
        d = s if srcs[0] is dsts[0] else [torch.zeros_like(t) for t in dsts]
        out.append([t.clone() for t in PK.apply_plans(plans, s, d)])
    return out


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("P", [2, 3, 4])
def test_schedule_matches_apply_plans_in_every_interleaving(P, scenario):
    for seed in range(SEEDS):
        rng = np.random.default_rng(seed)
        exchanges = SCENARIOS[scenario](P, rng)
        want = expected(exchanges)
        assert simulate(exchanges, P, rng) == []
        for (_, _, dsts), w in zip(exchanges, want):
            for got, exp in zip(dsts, w):
                assert torch.equal(got, exp), (P, scenario, seed)


def test_schedule_operations():
    plan = PK.a2a_plan(3, 1, 8)
    ops = PK.sync_schedule(plan, 1, 3, 5)
    assert [op.kind for op in ops] == ["puts", "signal", "wait", "unpacks"]
    assert {op.half for op in ops} == {1} and {op.epoch for op in ops} == {5}
    assert ops[0].moves == plan.puts and ops[3].moves == plan.unpacks
    assert ops[1].ranks == ops[2].ranks == (0, 2)
    assert ops[1].value == ops[2].value == 6
    # a non-periodic edge still signals and waits for every other rank
    edge = PK.halo_plan((8, 4), 4, 0, 1, 2, (2, 2, 2), 0, False)
    assert edge.peers == (1,)
    assert PK.sync_schedule(edge, 0, 3, 0)[1].ranks == (1, 2)
    # K2s: the copy alone
    one = PK.sync_schedule(PK.a2a_plan(1, 0, 8), 0, 1, 4)
    assert [op.kind for op in one] == ["puts"] and one[0].half == 0


def test_launch_arguments_follow_the_schedule():
    # the C entry gets the schedule's peers and half the receive region
    ws = types.SimpleNamespace(rank=2, size=4, device=torch.device("cpu"),
                               bases_dev=torch.zeros(4, dtype=torch.int64),
                               bases_host=object(), recv_bytes=6 << 20)
    plan = PK.halo_plan((8, 6, 4), 4, 1, 1, 4, (4,) * 4, 2, False)
    launch = PK._prepare(plan, ws, 16)
    assert launch.peers == (0, 1, 3) == PK.sync_peers(4, 2)
    assert list(launch.head[3]) == [0, 1, 3] and launch.head[4] == 3
    assert launch.head[1] is ws.bases_host
    assert launch.tail[-1] == 3 << 20


# -- the checks can fail ------------------------------------------------------

def _peers_only(plan, me, P, e):
    # signals and waits for the plan's peers alone
    peers = tuple(p for p in plan.peers if p != me)
    return tuple(op._replace(ranks=peers) if op.kind in ("signal", "wait")
                 else op for op in PK.sync_schedule(plan, me, P, e))


def _one_half(plan, me, P, e):
    return tuple(op._replace(half=0)
                 for op in PK.sync_schedule(plan, me, P, e))


def _no_wait(plan, me, P, e):
    return tuple(op for op in PK.sync_schedule(plan, me, P, e)
                 if op.kind != "wait")


@pytest.mark.parametrize("schedule,P,scenario,says", [
    (_peers_only, 3, "mixed", "before it unpacked"),
    (_one_half, 2, "k2", "before it unpacked"),
    (_no_wait, 2, "k2", "reads epochs"),
])
def test_a_schedule_without_its_parts_races(schedule, P, scenario, says):
    seen = []
    for seed in range(200):
        rng = np.random.default_rng(seed)
        try:
            simulate(SCENARIOS[scenario](P, rng), P, rng, schedule)
        except Race as e:
            seen.append(str(e))
            break
    assert seen and says in seen[0], seen


# -- a lost peer --------------------------------------------------------------

class Flag:
    def __init__(self, value):
        self.value = value

    def query(self):
        return self.value


@pytest.mark.parametrize("P,lost,epoch", [(2, 0, 0), (3, 1, 1), (4, 3, 2)])
def test_a_lost_signal_ends_the_waiting_ranks(P, lost, epoch):
    rng = np.random.default_rng(P)
    exchanges = SCENARIOS["mixed"](P, rng)
    stuck = simulate(exchanges, P, rng, drop=(lost, epoch))
    # every other rank waits at that epoch for the signal that never comes
    assert dict(stuck) == {r: epoch for r in range(P) if r != lost}
    # each waiting rank's stream reached the exchange and never ends it:
    # the watchdog fails it after the bound, naming the rank and the epoch
    now = [0.0]
    failures = []
    dog = PK.Watchdog(bound_s=20.0, clock=lambda: now[0],
                      fail=failures.append)
    for r, e in stuck:
        dog.track("K2", r, P, e, PK.sync_peers(P, r), Flag(True),
                  Flag(False), thread=False)
    for t in (0.0, 10.0, 20.0):
        now[0] = t
        assert dog.poll() is False and not failures
    now[0] = 20.0 + PK.POLL_S
    assert dog.poll() is True
    r, e = stuck[0]
    assert f"group rank {r} of {P}" in failures[0]
    assert f"at epoch {e} " in failures[0]
    assert "20.1 s (bound 20 s)" in failures[0]


def test_watchdog_forgets_finished_exchanges_and_waits_for_the_stream():
    now = [0.0]
    failures = []
    dog = PK.Watchdog(bound_s=1.0, clock=lambda: now[0], fail=failures.append)
    done = Flag(False)
    dog.track("K3", 0, 2, 7, (1,), Flag(True), done, thread=False)
    # an exchange whose stream is still busy before it is never late
    dog.track("K3", 0, 2, 8, (1,), Flag(False), Flag(False), thread=False)
    assert dog.poll() is False
    done.value = True
    now[0] = 100.0
    assert dog.poll() is False and not failures
    assert [p.epoch for p in dog._pending] == [8]


def test_watchdog_thread_fails_a_late_exchange(monkeypatch):
    monkeypatch.setattr(PK, "POLL_S", 0.01)
    failures = []
    dog = PK.Watchdog(bound_s=0.05, fail=failures.append)
    dog.track("K2", 1, 3, 4, (0, 2), Flag(True), Flag(False))
    deadline = time.monotonic() + 10
    while not failures and time.monotonic() < deadline:
        time.sleep(0.01)
    assert failures and "group rank 1 of 3" in failures[0]
    dog._thread.join(5)
    assert not dog._thread.is_alive()  # it stops once it has failed


def test_the_watchdog_ends_the_process():
    code = ("from cudecomp_tpu_torch.ops import peer_kernels as PK; "
            "PK._end_process('K2 on group rank 1 of 2 at epoch 3')")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == PK.LOST_PEER_EXIT
    assert "group rank 1 of 2 at epoch 3" in res.stderr


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_lost_peer_ends_the_waiting_rank(cuda, tmp_path):
    # two processes on cuda:0; rank 1 makes the workspace and never the
    # exchange: rank 0's stream waits, and the watchdog ends its process
    # within the bound, naming the rank and the epoch
    PK.build()
    bound = 3.0
    code = ("import sys; from cudecomp_tpu_torch.utils.testing import "
            "lost_peer_rank; lost_peer_rank(int(sys.argv[1]), sys.argv[2], "
            "float(sys.argv[3]))")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r),
                               str(tmp_path / "pg"), str(bound)], cwd=ROOT,
                              stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    try:
        _, err = procs[0].communicate(timeout=bound + 120)
    finally:
        for p in procs:
            p.kill()
            p.wait(30)
    assert procs[0].returncode == PK.LOST_PEER_EXIT, err
    assert "K2 on group rank 0 of 2" in err and "at epoch 0 " in err, err
