"""K2 (the one-sided all-to-all), K2s (its single-rank smoke) and K3 (the
one-sided halo ring) of cudecomp_tpu_torch, on the CPU.

The kernels run only on a card (``test_torch_kernels.py``, ``gpu`` tests).
What they move is a pure plan per rank (``ops.peer_kernels``), and the
plain executor runs all P ranks' plans in one process: here it must be bit
for bit the JAX package's Pallas kernels run in interpret mode on a 1D CPU
mesh, as ``tests/test_pallas.py`` runs them.  The plans against the real
exchange over a gloo group run in the 4-rank spawn of
``test_torch_slice.py`` (``kind="peer"``).
"""

import contextlib
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

import cudecomp_tpu_torch as ct
from cudecomp_tpu_torch.ops import halo as H
from cudecomp_tpu_torch.ops import peer_kernels as PK
from cudecomp_tpu_torch.parallel import collectives, mesh, symmetric
from cudecomp_tpu_torch.utils.testing import expected_halo_buffer


def _jax_1d(fn, n, local_spec_dim, host):
    """``fn`` per device of an n-device 1D CPU mesh, ``host`` sharded along
    ``local_spec_dim``; returns the global numpy result."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    from cudecomp_tpu.parallel.collectives import shard_map_fn
    m = Mesh(np.array(jax.devices()[:n]), ("x",))
    spec = P(*([None] * local_spec_dim + ["x"]))
    return np.asarray(shard_map_fn(fn, m, (spec,), spec)(host))


def _split(host, n, dim):
    return [torch.from_numpy(np.ascontiguousarray(c))
            for c in np.split(host, n, axis=dim)]


@pytest.mark.parametrize("n,B,cols", [(1, 5, 3), (2, 4, 5), (3, 2, 7),
                                      (4, 3, 1)])
def test_a2a_plan_matches_pallas_a2a(n, B, cols):
    from cudecomp_tpu.ops.pallas_kernels import exchange_pallas_a2a
    rng = np.random.default_rng(n)
    host = rng.standard_normal((n * n * B, cols)).astype(np.float32)
    host[::B] *= 0  # zero rows, as the uneven transpose pads its blocks
    want = _jax_1d(lambda v: exchange_pallas_a2a(v, "x", n, B,
                                                 interpret=True), n, 0, host)
    srcs = _split(host, n, 0)
    bb = B * cols * 4
    plans = [PK.a2a_plan(n, r, bb) for r in range(n)]
    # the self block goes straight to the output: P-1 receive slots
    assert all(p.recv_bytes == (n - 1) * bb for p in plans)
    outs = PK.apply_plans(plans, srcs, [torch.empty_like(s) for s in srcs])
    np.testing.assert_array_equal(torch.cat(outs).numpy(), want)


HALO_CASES = [
    # n, h, m, splits, local shape (the halo dim's extent is m + 2h), i_d
    (2, 1, 4, (4, 4), (None, 5), 0),
    (3, 2, 5, (5, 4, 4), (3, None, 4), 1),        # strided slabs, uneven
    (4, 1, 5, (5, 5, 5, 3), (None, 4), 0),        # tests/test_pallas.py:130
    (4, 1, 3, (3, 3, 2, 2), (2, 3, None, 2), 2),  # a trailing component dim
]


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("n,h,m,splits,shape,i_d", HALO_CASES)
def test_halo_plan_matches_pallas_halo(n, h, m, splits, shape, i_d,
                                       periodic):
    from cudecomp_tpu.ops.pallas_kernels import halo_exchange_pallas
    local = tuple(m + 2 * h if s is None else s for s in shape)
    glob = tuple(n * s if d == i_d else s for d, s in enumerate(local))
    host = np.random.default_rng(n * 10 + h).standard_normal(glob)
    want = _jax_1d(lambda v: halo_exchange_pallas(
        v, "x", n, h, m, i_d, periodic, interpret=True, splits=splits),
        n, i_d, host)
    bufs = _split(host, n, i_d)
    plans = [PK.halo_plan(local, 8, i_d, h, m, splits, r, periodic)
             for r in range(n)]
    PK.apply_plans(plans, bufs, bufs)
    np.testing.assert_array_equal(torch.cat(bufs, dim=i_d).numpy(), want)


def test_plans_cover_their_regions_once():
    # K2: the peers' puts tile every receive region of P-1 slots exactly
    # once, each rank's self block goes to its own output block, and the
    # unpacks copy the slots out around it; K3: the unpacks write exactly
    # the halo planes, and each put lands in a slot of the neighbour that
    # unpacks it into the facing halo
    for P in (1, 2, 3, 5):
        bb = 24
        plans = [PK.a2a_plan(P, r, bb) for r in range(P)]
        for q, p in enumerate(plans):
            dsts = sorted(mv.dst for o in plans for mv in o.puts
                          if mv.peer == q)
            assert dsts == [r * bb for r in range(P - 1)]
            own = [mv for mv in p.puts if mv.peer == PK.OWN]
            assert [(mv.src, mv.dst, mv.row_bytes) for mv in own] == [
                (q * bb, q * bb, bb)]
            out = sorted((mv.dst, mv.dst + mv.row_bytes) for mv in p.unpacks)
            assert out == [(a, b) for a, b in ((0, q * bb),
                                               ((q + 1) * bb, P * bb)) if b > a]
            assert p.peers == (tuple(range(P)) if P > 1 else ())
    splits, h, m = (4, 3, 3), 1, 4
    for periodic in (True, False):
        plans = [PK.halo_plan((2, m + 2 * h, 3), 4, 1, h, m, splits, r,
                              periodic) for r in range(3)]
        for r, p in enumerate(plans):
            assert all(r in plans[q].peers for q in p.peers)
            halo_rows = sorted(mv.dst // 12 for mv in p.unpacks)
            want = ([0] if periodic or r > 0 else []) + (
                [h + m] if periodic or r < 2 else [])
            assert halo_rows == want
    assert PK.halo_plan((8, 4), 4, 0, 1, 2, (2, 2), 0, False).peers == (1,)


def test_move_tables_and_words():
    plan = PK.halo_plan((3, 6, 4), 4, 1, 1, 4, (4, 4), 1, True)
    puts, unpacks = PK.move_tables(plan, 1, torch.device("cpu"))
    assert puts.dtype == torch.int64 and tuple(puts.shape) == (2, 8)
    assert puts[:, 0].tolist() == [-1, -1]       # from the caller's tensor
    assert unpacks[:, 3].tolist() == [-1, -1]    # into the caller's tensor
    assert unpacks[:, 0].tolist() == [1, 1]
    assert sorted(puts[:, 3].tolist()) == [0, 0]  # P = 2: both to rank 0
    # rows of 16 bytes, strides of 96: 16-byte words on aligned tensors
    assert PK.word_bytes(plan, 256) == 16 and PK.word_bytes(plan, 260) == 4
    assert PK.word_bytes(PK.a2a_plan(2, 0, 12), 256) == 4


@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_a2a_smoke_plain_path_matches_mosaic_smoke(one_rank_group):
    from cudecomp_tpu.ops.pallas_kernels import mosaic_smoke
    before = PK.a2a_launch_count
    assert PK.a2a_smoke(64, device="cpu") is True
    assert mosaic_smoke(n=64, interpret=True) is True
    assert PK.a2a_launch_count == before  # CPU tensors take the plain path
    # K2s's program is K2's at P = 1: one self block, copied out whole
    x = torch.arange(64 * 256, dtype=torch.float32).reshape(64, 256)
    out = PK.apply_plans([PK.a2a_plan(1, 0, x.numel() * 4)], [x],
                         [torch.empty_like(x)])[0]
    assert torch.equal(out, x)
    with pytest.raises(ValueError, match="expected 2 peers x 2"):
        collectives.exchange_pallas_a2a(torch.zeros(3, 2), None, 2, 2)
    with pytest.raises(ValueError, match="1 equal blocks"):
        PK.a2a(torch.zeros(()), None)
    with pytest.raises(ValueError, match="K2 runs on CUDA tensors"):
        PK.a2a(x, None)  # the wrapper launches or raises; callers choose


def _poison(monkeypatch):
    def plain(*a, **k):
        raise AssertionError("a kernel exchange took its plain version")

    monkeypatch.setattr(collectives, "exchange_all_to_all", plain)
    monkeypatch.setattr(H, "halo_ring", plain)
    monkeypatch.setattr(PK.dist, "get_world_size", lambda g=None: 2)
    monkeypatch.setattr(PK.dist, "get_rank", lambda g=None: 0)


def test_off_the_cpu_the_exchanges_are_the_kernels(monkeypatch):
    # a tensor off the CPU goes to K2 or K3, never to a plain version; a
    # meta tensor, which no kernel takes, raises before any launch
    _poison(monkeypatch)
    blocks = torch.empty((8, 3), device="meta")
    with pytest.raises(ValueError, match="K2 runs on CUDA tensors"):
        collectives.EXCHANGES["pallas_a2a"](blocks, object(), 2, 4)
    assert collectives.EXCHANGES["pallas_a2a"](blocks[:4], object(), 1,
                                               4) is not None  # n == 1
    with pytest.raises(ValueError, match="K3 runs on CUDA tensors"):
        PK.halo_exchange(torch.empty((4, 6), device="meta"), object(), 1, 1,
                         4, (4, 4), True)
    with pytest.raises(ValueError, match="3 splits for a group of 2"):
        PK.halo_exchange(torch.empty((4, 6)), object(), 1, 1, 4, (4, 4, 4),
                         True)
    with pytest.raises(ValueError, match="K3 runs on CUDA tensors"):
        PK.halo_exchange(torch.empty((4, 6)), object(), 1, 1, 4, (4, 4), True)


def _fake_workspace(rank=0, size=2, device="cpu"):
    ws = symmetric.Workspace.__new__(symmetric.Workspace)
    ws.device, ws.group, ws.launches = torch.device(device), None, {}
    ws.rank, ws.size, ws.exchanges = rank, size, 0
    ws.bases_dev = torch.zeros(size, dtype=torch.int64)
    ws.bases_host, ws.recv_bytes = object(), 4 << 20
    return ws


def test_release_drops_the_workspace_tables(monkeypatch):
    # a workspace keeps the plans run on it, made ready to launch with their
    # device tables, and they go when it is released
    monkeypatch.setattr(symmetric.torch.cuda, "synchronize", lambda d: None)
    monkeypatch.setattr(symmetric.dist, "barrier", lambda group: None)
    ws = _fake_workspace(device="cuda:0")
    ws.device = torch.device("cpu")  # the tables, made on the CPU here
    plan = PK.a2a_plan(2, 0, 16)
    ws.launches[("a2a", 16), 16] = PK._prepare(plan, ws, 16)
    ws.device = torch.device("cuda", 0)
    symmetric._WORKSPACES[("test", 0)] = ws
    symmetric.release_workspaces()
    assert ws.launches == {} and not symmetric._WORKSPACES


@pytest.mark.parametrize("P,me", [(2, 0), (2, 1), (4, 2)])
def test_a2a_launch_is_prepared_once_per_plan(P, me):
    # what one K2 exchange passes to the C entry besides the tensors, the
    # epoch and the stream: the workspace bases (device and host), the
    # rank, the ranks it signals and waits for (every other one), the two
    # device tables with their lengths, the largest move in words, the
    # word size and half the receive region
    ws = _fake_workspace(me, P)
    bb = 3 * 1024
    plan = PK.a2a_plan(P, me, bb)
    launch = PK._prepare(plan, ws, 16)
    bases, host, rank, peers, npeers = launch.head
    others = [p for p in range(P) if p != me]
    assert (bases, host, rank, list(peers), npeers) == (
        ws.bases_dev.data_ptr(), ws.bases_host, me, others, P - 1)
    assert launch.peers == tuple(others)
    puts, nputs, unpacks, nunpacks, max_words, wb, half = launch.tail
    assert (puts, unpacks) == tuple(t.data_ptr() for t in launch.tables)
    assert (nputs, nunpacks) == (P, len(plan.unpacks))
    assert wb == 16 and max_words == max(me, P - 1 - me, 1) * bb // 16
    assert half == ws.recv_bytes // PK.HALVES
    assert PK._prepare(plan, ws, 4).tail[-2] == 4  # a 4-byte aligned tensor
    assert PK._alignment(256, 512 + 8) == 8 and PK._alignment(64) == 16


def test_launch_returns_the_launches_its_entry_reports(monkeypatch):
    # the kernel and memory-operation counts are what the C entry writes
    # to its out-arguments, not numbers the wrapper derives from the plan;
    # each exchange goes to the watchdog between its two events
    calls = []

    def entry(*args):
        calls.append(args)
        args[-2]._obj.value = 3
        args[-1]._obj.value = 2
        return 0

    class Event:
        def record(self, stream):
            self.stream = stream

        def query(self):
            return True

    monkeypatch.setattr(PK, "_lib", lambda: types.SimpleNamespace(
        cudecomp_peer_a2a=entry))
    monkeypatch.setattr(PK.torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(PK.torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(PK.torch.cuda, "Event", Event)
    dog = PK.Watchdog()
    monkeypatch.setattr(PK, "WATCHDOG", dog)
    tracked = []
    monkeypatch.setattr(dog, "track", lambda *a: tracked.append(a))
    ws = _fake_workspace(0, 2)
    blocks = torch.zeros(8)
    out = torch.empty_like(blocks)
    for _ in range(2):
        assert PK._launch("cudecomp_peer_a2a", "K2", (blocks, out),
                          ("a2a", 16), lambda: PK.a2a_plan(2, 0, 16),
                          ws) == (3, 2)
    assert len(ws.launches) == 1 and ws.exchanges == 2
    assert [c[7] for c in calls] == [0, 1]  # the epochs
    assert [a[:5] for a in tracked] == [("K2", 0, 2, e, (1,)) for e in (0, 1)]


def test_gloo_refuses_tensors_off_the_cpu(monkeypatch):
    monkeypatch.setattr(collectives.dist, "get_backend", lambda g=None:
                        "gloo")
    x = torch.empty((4, 2), device="meta")
    with pytest.raises(ValueError, match="PALLAS_A2A"):
        collectives.exchange_all_to_all(x, object(), 2, 2)
    with pytest.raises(ValueError, match="gloo exchanges CPU tensors"):
        collectives.ppermute_group(x, object(), [(0, 1), (1, 0)])


def test_nccl_refuses_ranks_that_share_a_card(monkeypatch):
    uuids = {"cuda:0": "GPU-a"}
    monkeypatch.setattr(mesh.dist, "get_backend", lambda g=None: "nccl")
    monkeypatch.setattr(mesh.dist, "get_world_size", lambda g=None: 4)
    monkeypatch.setattr(mesh.torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(uuid=uuids[str(d)]))

    def gather(out, obj):
        out[:] = [obj] * len(out)

    monkeypatch.setattr(mesh.dist, "all_gather_object", gather)
    with pytest.raises(RuntimeError, match="NCCL refuses two ranks"):
        mesh.check_cards(torch.device("cuda", 0))
    mesh.check_cards(torch.device("cpu"))  # no card, no check
    monkeypatch.setattr(mesh.dist, "get_backend", lambda g=None: "gloo")
    mesh.check_cards(torch.device("cuda", 0))  # gloo: sharing is the rule


def test_workspaces_live_on_an_indexed_cuda_device():
    with pytest.raises(ValueError, match="indexed CUDA device"):
        symmetric.workspace(object(), "cpu", 1024)
    with pytest.raises(ValueError, match="indexed CUDA device"):
        symmetric.workspace(object(), "cuda", 1024)


def test_expected_halo_buffer_matches_the_one_rank_engine():
    # the halo oracle of chip_smoke.py against update_halos on one rank,
    # with a non-periodic dim and a padded (uneven-style) extent elsewhere
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((6, 5, 7)))
    grid = ct.make_grid(ct.GridConfig(gdims=(6, 5, 7), pdims=(1, 1)), "cpu")
    he = (1, 2, 1)
    for periods in ((True, True, True), (True, False, True),
                    (False, False, False)):
        buf = ct.scatter_global(grid, x, 1, halo_extents=he)
        ct.update_halos(grid, buf, 1, he, periods)
        assert torch.equal(buf, expected_halo_buffer(grid, x, 1, he, periods))
