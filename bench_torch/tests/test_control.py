"""The control, the bfloat16 reference in the program's place, at a size
a test run holds: it has to fail each cell's check, on three seeds, and
the program has to pass it on the same seeds.  ``readings.py`` makes the
same readings at the cells' own sizes on the card."""

from pathlib import Path

import pytest
import torch

from bench_torch import harness, readings

ROOT = Path(__file__).resolve().parents[2]
SIZES = {"c2c1024.ac": [16, 16, 16], "c2c1024.natural": [16, 32, 8],
         "tg512.rk4": [32, 32, 32]}


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_the_control_fails_and_the_program_passes(workload):
    cell = harness.load_cell(ROOT / "BENCHMARK.json", workload)
    cell.config["gdims"] = SIZES[workload]
    limits = cell.config["limits"]
    cpu = torch.device("cpu")
    for seed in (1, 2, 2 ** 33 + 7):
        prog = readings.reading(cell, seed, "program", 0.2, cpu)
        assert all(v <= limits[k] for k, v in prog["checks"].items()), prog
        ctrl = readings.reading(cell, seed, "control", 0.2, cpu)
        assert any(not (v <= limits[k]) for k, v in ctrl["checks"].items()), \
            ctrl
