"""A run ends every process it starts: the ranks of a cell on several
cards, and whatever a rank starts, on a sound run and on a failed one."""

import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

from bench_torch import run

ROOT = Path(__file__).resolve().parents[2]
FFT = ["--seconds", "0.3", "--device", "cpu", "--seed", "2147483659",
       "--gdims", "16,16,8"]
# sleeps of these lengths mark the processes a rank leaves behind
MARKS = ("987651", "987652", "987653")


def _marked():
    """Pids of live processes whose command line carries a mark."""
    out = []
    for d in Path("/proc").glob("[0-9]*"):
        try:
            cmd = (d / "cmdline").read_bytes().split(b"\0")
            state = (d / "stat").read_text().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if state != "Z" and any(m.encode() in cmd for m in MARKS):
            out.append(int(d.name))
    return out


@pytest.fixture
def no_marked_left():
    assert _marked() == []
    yield
    left = _marked()
    for pid in left:
        os.kill(pid, signal.SIGKILL)
    assert left == []


def _multi_cell():
    import json
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return next(w["name"] for w in bench["workloads"] if w["chips"] > 1)


def rank_leaving_processes(*args):
    """A rank that starts a child and a detached grandchild and leaves
    both running."""
    subprocess.Popen(["sleep", MARKS[0]])
    subprocess.Popen(["bash", "-c", f"sleep {MARKS[1]} & disown; exit 0"])
    run._rank_main(*args)


def rank_failing_with_a_child(*args):
    """Rank 1 fails after starting a child; the others wait for it in
    their first collective."""
    subprocess.Popen(["sleep", MARKS[2]])
    if args[0] == 1:
        raise RuntimeError("planted failure")
    run._rank_main(*args)


def test_a_sound_run_ends_what_its_ranks_started(no_marked_left):
    line = run.result(["--workload", _multi_cell(), *FFT],
                      rank_main=rank_leaving_processes)
    assert line["correct"] is True


def test_a_failed_rank_ends_every_rank(no_marked_left):
    with pytest.raises(RuntimeError, match="planted failure"):
        run.result(["--workload", _multi_cell(), *FFT],
                   rank_main=rank_failing_with_a_child)


def test_no_rank_outlives_a_run_of_the_command():
    """No rank process and no helper of it is left once ``python3 -m
    bench_torch.run`` has exited."""
    seed = "2147483671"
    args = [a if a != FFT[5] else seed for a in FFT]
    p = subprocess.run(
        [sys.executable, "-m", "bench_torch.run", "--workload",
         _multi_cell(), *args], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    left = []
    for d in Path("/proc").glob("[0-9]*"):
        try:
            cmd = (d / "cmdline").read_bytes().split(b"\0")
        except OSError:
            continue
        if seed.encode() in cmd:
            left.append(int(d.name))
    assert left == []
