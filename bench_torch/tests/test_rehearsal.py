"""Whole runs at a tiny size on the CPU (``--device cpu``, asked for by
name), the exit codes of runs that cannot measure, and the imports."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = {"c2c1024.ac": "16,16,16", "c2c1024.natural": "16,32,8",
         "tg512.rk4": "32,32,32"}


def _run(args, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "-m", "bench_torch.run", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_a_cell_runs_on_the_cpu_when_asked(workload, trace):
    p = _run(["--workload", workload, "--seed", str(2 ** 31 + 12345),
              "--seconds", "0.5", "--trace", str(trace), "--device", "cpu",
              "--gdims", CELLS[workload]])
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "cpu"
    if trace:
        assert "breakdown" in line
    else:
        assert "setup_s" in line["metrics"]
    tail = p.stderr.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") and t.endswith(" ok") for t in tail)


def test_no_cuda_is_exit_2_and_no_result():
    p = _run(["--workload", "c2c1024.ac", "--seed", "1", "--seconds", "1",
              "--trace", "0"])
    assert p.returncode == 2
    assert p.stdout.strip() == ""


def test_gdims_only_on_the_cpu():
    p = _run(["--workload", "c2c1024.ac", "--seed", "1", "--seconds", "1",
              "--gdims", "8,8,8"])
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_checkout_without_the_program_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_torch", tmp_path / "bench_torch",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _run(["--workload", "c2c1024.ac", "--seed", "1", "--seconds", "0.5",
              "--device", "cpu", "--gdims", "8,8,8"], cwd=tmp_path, env=env)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_nothing_imports_jax_or_the_jax_package():
    code = (
        "import pkgutil, importlib, sys, runpy\n"
        "import bench_torch\n"
        "for m in pkgutil.walk_packages(bench_torch.__path__,\n"
        "                               'bench_torch.'):\n"
        "    if '.tests' not in m.name:\n"
        "        importlib.import_module(m.name)\n"
        "from bench_torch import run\n"
        "run.result(['--workload', 'tg512.rk4', '--seed', '3', '--seconds',"
        " '0.2', '--trace', '1', '--device', 'cpu', '--gdims', '16,16,16'])\n"
        "run.result(['--workload', 'c2c1024.ac', '--seed', '3', '--seconds',"
        " '0.2', '--trace', '1', '--device', 'cpu', '--gdims', '8,8,8'])\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'cudecomp_tpu' or m.startswith('cudecomp_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().endswith("clean")
