"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m bench_torch.run --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder and
``cudecomp_tpu_torch``.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number the
check compared, with its limit); the checks are also the last lines of
standard error.  With ``--trace 0`` the metrics are the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics.

The run measures NVIDIA GPUs: it exits with status 2, and prints no
result, when CUDA is not available or the host has fewer cards than the
cell asks for.  ``--device cpu`` (a rehearsal, asked for by name, with
``--gdims`` to shrink the configuration) runs the same code on the CPU;
its numbers are not device numbers.

A cell on several cards runs one process per card (rank r on ``cuda:r``,
an NCCL default group over ``tcp://localhost``); its metrics are the
slowest rank's and its memory the fullest rank's.  Each rank is a
``python3 -m bench_torch.run`` process of its own session, which hands its
result back through a pipe; whatever way the run ends, every rank's
process group is killed and waited for, and the run, a subreaper, reaps
and kills any process that outlived its parent before it exits.  Every
build and kernel cache goes to fixed directories inside the checkout
(``bench_torch/_cache``).
"""

from __future__ import annotations

import time

T0_WALL = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pickle  # noqa: E402
import queue  # noqa: E402
import selectors  # noqa: E402
import signal  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
CACHE = Path(__file__).resolve().parent / "_cache"
RANK_TIMEOUT_S = 330


def _caches() -> None:
    """Fixed cache directories inside the checkout, for this process and
    every rank it starts."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cpu: a rehearsal on the host, only when asked")
    p.add_argument("--gdims", default=None,
                   help="X,Y,Z: replace the configuration's grid "
                        "(with --device cpu only)")
    p.add_argument("--impl", choices=("program", "control"),
                   default="program", help=argparse.SUPPRESS)
    # set by _spawn for a rank's own process: JSON of rank, world, port,
    # the result pipe's fd, the run's start and the rank's entry
    p.add_argument("--as-rank", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.gdims is not None and args.device != "cpu":
        p.error("--gdims rehearses on the CPU only")
    return args


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, args, cell, results, t0_wall):
    """One rank of a run (the whole run when ``world`` is 1)."""
    import torch

    from bench_torch import harness

    try:
        group = stop_group = None
        if args.device == "cuda":
            torch.cuda.set_device(rank)
            device = torch.device("cuda", rank)
        else:
            device = torch.device("cpu")
        if world > 1:
            import torch.distributed as dist
            dist.init_process_group(
                "nccl" if args.device == "cuda" else "gloo",
                init_method=f"tcp://localhost:{port}", world_size=world,
                rank=rank)
            stop_group = (dist.new_group(backend="gloo")
                          if args.device == "cuda" else dist.group.WORLD)
        ctx = harness.Context(device=device, rank=rank, world=world,
                              seed=args.seed, impl=args.impl, group=group)
        out = harness.run_rank(cell, ctx, args.seconds, bool(args.trace),
                               t0_wall, stop_group)
        results.put(out)
        if world > 1:
            torch.distributed.barrier(group=stop_group)
            torch.distributed.destroy_process_group()
    except BaseException:
        results.put({"rank": rank, "error": traceback.format_exc()})
        raise


class _PipeResults:
    """A rank's result, pickled into the pipe ``_spawn`` reads; the pipe is
    closed after the first result."""

    def __init__(self, fd: int):
        self.fd = fd

    def put(self, out: dict) -> None:
        if self.fd is None:
            return
        data = pickle.dumps(out)
        view = memoryview(data)
        while view:
            view = view[os.write(self.fd, view):]
        os.close(self.fd)
        self.fd = None


def _signal_group(pgid: int, sig) -> None:
    try:
        os.killpg(pgid, sig)
    except ProcessLookupError:
        pass


def _end_group(proc: subprocess.Popen, grace: float) -> None:
    """Wait ``grace`` seconds for the rank, then end it (SIGTERM, ten
    seconds later SIGKILL); last kill whatever of its process group is
    left, and wait for the rank."""
    try:
        proc.wait(timeout=grace)
    except subprocess.TimeoutExpired:
        _signal_group(proc.pid, signal.SIGTERM)
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass
    _signal_group(proc.pid, signal.SIGKILL)
    proc.wait()


def _spawn(world, args, argv, rank_main):
    """Run the ranks as processes; their outputs by rank.  A rank that
    fails ends the others; every rank's process group ends with the
    call."""
    port = _free_port()
    entry = f"{rank_main.__module__}:{rank_main.__qualname__}"
    procs, pipes = [], {}
    sel = selectors.DefaultSelector()
    got, deadline = {}, time.time() + RANK_TIMEOUT_S
    try:
        for r in range(world):
            rfd, wfd = os.pipe()
            spec = json.dumps({"rank": r, "world": world, "port": port,
                               "fd": wfd, "t0_wall": T0_WALL,
                               "entry": entry})
            try:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "bench_torch.run", *argv,
                     "--as-rank", spec], cwd=CHECKOUT, pass_fds=(wfd,),
                    start_new_session=True))
            finally:
                os.close(wfd)
            pipes[rfd] = (r, bytearray())
            sel.register(rfd, selectors.EVENT_READ)
        while pipes and time.time() < deadline:
            for key, _ in sel.select(timeout=1.0):
                r, buf = pipes[key.fd]
                chunk = os.read(key.fd, 1 << 16)
                if chunk:
                    buf.extend(chunk)
                    continue
                sel.unregister(key.fd)
                os.close(key.fd)
                del pipes[key.fd]
                if buf:
                    got[r] = pickle.loads(bytes(buf))
            if any("error" in o for o in got.values()):
                break
            if any(p.poll() not in (None, 0) for p in procs):
                break
    finally:
        for fd in list(pipes):
            sel.unregister(fd)
            os.close(fd)
        sel.close()
        whole = len(got) == world and not any("error" in o
                                               for o in got.values())
        for p in procs:
            _end_group(p, 30 if whole else 1)
    errors = [o["error"] for o in got.values() if "error" in o]
    if errors or len(got) < world:
        raise RuntimeError("a rank failed:\n" + "\n".join(errors)
                           if errors else f"{world - len(got)} ranks gave "
                           f"no result")
    return [got[r] for r in range(world)]


def _as_rank(args) -> int:
    """A rank's own process: run its entry with the pipe as its results."""
    spec = json.loads(args.as_rank)
    _caches()
    if str(CHECKOUT) not in sys.path:
        sys.path.insert(0, str(CHECKOUT))
    module, _, name = spec["entry"].partition(":")
    rank_main = getattr(importlib.import_module(module), name)
    results = _PipeResults(spec["fd"])
    try:
        rank_main(spec["rank"], spec["world"], spec["port"], args,
                  _cell(args), results, spec["t0_wall"])
    except BaseException:
        results.put({"rank": spec["rank"], "error": traceback.format_exc()})
        return 1
    finally:
        results.put({"rank": spec["rank"], "error": "no result"})
    return 0


def _cell(args):
    from bench_torch import harness

    cell = harness.load_cell(CHECKOUT / "BENCHMARK.json", args.workload)
    if args.gdims is not None:
        cell.config["gdims"] = [int(v) for v in args.gdims.split(",")]
    return cell


def _subreaper() -> None:
    """Make this process the reaper of every orphan it leaves (Linux)."""
    try:
        import ctypes
        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)
    except (OSError, AttributeError):
        pass


def _children() -> list:
    """The pids whose parent is this process (from ``/proc``)."""
    me, out = os.getpid(), []
    for d in Path("/proc").glob("[0-9]*"):
        try:
            stat = (d / "stat").read_text()
        except OSError:
            continue
        if int(stat[stat.rindex(")") + 2:].split()[1]) == me:
            out.append(int(d.name))
    return out


def _reap_all() -> None:
    """Kill and wait for every child still there, orphans of the ranks'
    processes included."""
    deadline = time.time() + 30
    while time.time() < deadline:
        kids = _children()
        if not kids:
            return
        for pid in kids:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        for pid in kids:
            try:
                os.waitpid(pid, 0)
            except ChildProcessError:
                pass


class NoDevice(RuntimeError):
    """The host lacks the cards the cell asks for."""


def result(argv=None, rank_main=_rank_main) -> dict:
    """Run the cell ``argv`` asks for; its result line, as a dict.
    ``rank_main`` runs each rank (a module-level function with
    :func:`_rank_main`'s arguments)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse(argv)
    _caches()
    if str(CHECKOUT) not in sys.path:
        sys.path.insert(0, str(CHECKOUT))
    import torch

    from bench_torch import harness

    bench = harness.load_json(CHECKOUT / "BENCHMARK.json")
    cell = _cell(args)
    world = cell.chips
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise NoDevice("CUDA is not available: this benchmark measures "
                           "NVIDIA GPUs")
        if torch.cuda.device_count() < world:
            raise NoDevice(f"cell {cell.name} needs {world} GPUs, the host "
                           f"has {torch.cuda.device_count()}")
    # the program: a checkout without it fails here, before any work
    import cudecomp_tpu_torch  # noqa: F401

    if world == 1:
        results = queue.Queue()
        rank_main(0, 1, None, args, cell, results, T0_WALL)
        parts = [results.get()]
    else:
        parts = _spawn(world, args, argv, rank_main)
    device = torch.device(args.device)
    line = harness.merge(parts, bench, cell, device, world, bool(args.trace))
    if args.device == "cuda":
        line["device"]["power_limit_w"] = _power_limit()
    checks = line.pop("checks")
    line["checks"] = checks       # the checks come last
    return line


def main(argv=None) -> int:
    args = parse(argv)
    if args.as_rank is not None:
        return _as_rank(args)
    _subreaper()
    try:
        line = result(argv)
    except NoDevice as e:
        print(e, file=sys.stderr)
        return 2
    finally:
        _reap_all()
    for k, c in line["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {k} {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


def _power_limit():
    """The card's power limit in watts (``nvidia-smi``), or None."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


if __name__ == "__main__":
    sys.exit(main())
