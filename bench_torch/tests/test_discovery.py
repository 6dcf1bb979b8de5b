"""BENCHMARK.json against the contract's shape, and every cell's files
found by name."""

import json
import re
from pathlib import Path

import pytest

from bench_torch import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["bench_torch"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + CELLS
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    kind = "metrics" if "layer" in metric else "end_to_end"
    assert (ROOT / "bench_torch" / kind / f"{metric['name']}.py").is_file()
    if kind == "end_to_end":
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        moved = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
        for cell in metric["workloads"]:
            assert cell in CELLS
            assert cell in moved.get("workloads", CELLS)
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"


@pytest.mark.parametrize("workload", CELLS)
def test_cells_resolve(workload):
    cell = harness.load_cell(ROOT / "BENCHMARK.json", workload)
    assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
    assert cell.per_layer
    driver = cell.traffic["driver"]
    assert (ROOT / "bench_torch" / "drivers" / f"{driver}.py").is_file()
    assert (ROOT / "bench_torch" / cell.config["reference"]).is_file()
    assert cell.config["limits"]


def test_configs_name_their_files():
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("bench_torch/")
        data = json.loads(path.read_text())
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]
        assert set(data["reduced"]) <= set(data.get("source_values", {}))
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
