"""The port's sweep runner (``cudecomp_tpu_torch/sweep.py``) against the
JAX runner (``benchmarks/run_sweep.py``): the same rows for the same case
matrix (4 gloo ranks against JAX's 8 CPU devices), the same CSV columns;
and the runner's own parts: the YAML-subset reader against
``yaml.safe_load``, its refusals, ``CannotRun`` rows, worlds, the grid
cache and the exit codes."""

import csv
import importlib.util
import json
import time
from pathlib import Path

import pytest
import torch
import yaml
from hypothesis import given, settings, strategies as st

from cudecomp_tpu_torch import CannotRun, sweep

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted((ROOT / "benchmarks").glob("*.yaml"))
# the matrix of sweep_config.yaml, and cases with halos and padding
BASE = yaml.safe_load((ROOT / "benchmarks/sweep_config.yaml").read_text())
EXTRA = dict(gdims=[[9, 10, 11]], pdims=[[2, 2], [1, 4]],
             method=["all_to_all", "ring_pipelined"], dtype=["float64"],
             axis_contiguous=[False, True],
             halo_extents=[[1, 1, 1], [0, 0, 0]],
             padding=[[0, 0, 0], [1, 0, 2]])
CASES = list(sweep.parse_case_matrix(BASE)) + [
    c for c in sweep.parse_case_matrix(EXTRA)
    if c["halo_extents"] != [0, 0, 0] or c["padding"] != [0, 0, 0]]
SHAPE = ("gdims", "axis_contiguous", "halo_extents", "padding")


def _jax_runner():
    spec = importlib.util.spec_from_file_location(
        "jax_run_sweep", ROOT / "benchmarks" / "run_sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_rows():
    """JAX's ``run_case`` on every case (its timers stubbed: only the
    columns that are no times are compared), a raise made a row as its
    ``main`` makes it."""
    from cudecomp_tpu import performance as jperf
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jperf, "segment_roundtrip", lambda *a, **k: {
            "total_ms": 0.0, "a2a_ms": 0.0, "local_ms": 0.0,
            "a2a_gbps": 0.0})
        mp.setattr(jperf, "time_scanned", lambda *a, **k: [0.0])
        runner = _jax_runner()
        rows = []
        for case in CASES:
            try:
                rows.append(runner.run_case(case, 0, 1, True, 1))
            except Exception as e:  # JAX's main: the case's row
                rows.append(sweep.error_row(case, e))
    finally:
        mp.undo()
    return rows


@pytest.fixture(scope="module")
def port_rows():
    """The port's rows of every case: one spawn of 4 gloo ranks."""
    t0 = time.perf_counter()
    got = sweep.run_world(4, list(enumerate(CASES)),
                          dict(n_warmup=0, n_trials=1, check=True, iters=1),
                          "cpu")
    rows = [row for _, row in sorted(got, key=lambda ir: ir[0])]
    return rows, time.perf_counter() - t0


def test_the_matrix_has_halos_padding_and_every_method():
    assert len(CASES) == 72 + 24
    assert {c["method"] for c in CASES} == {"all_to_all", "ring",
                                            "ring_pipelined"}
    assert any(c["halo_extents"] != [0, 0, 0] for c in CASES)
    assert any(c["padding"] != [0, 0, 0] for c in CASES)
    assert {c["dtype"] for c in CASES} == {"float32", "float64"}


@pytest.mark.parametrize("columns", [("status",), ("pdims",), ("method",),
                                     ("dtype",), SHAPE],
                         ids=["status", "pdims", "method", "dtype", "shape"])
def test_rows_match_jax_row_for_row(jax_rows, port_rows, columns):
    rows, _ = port_rows
    assert len(rows) == len(jax_rows) == len(CASES)
    for case, got, want in zip(CASES, rows, jax_rows):
        assert [got[c] for c in columns] == [want[c] for c in columns], case


def test_every_case_is_ok_and_timed(port_rows, jax_rows):
    rows, seconds = port_rows
    bad = [r for r in rows if r["status"] != "ok"]
    assert not bad, bad[:3]
    for got, want in zip(rows, jax_rows):
        assert got["timing"] == {"segment": "segment",
                                 "scanned_chain": "chain"}[want["timing"]]
        assert float(got["roundtrip_ms"]) >= 0
        assert (got["a2a_ms"] != "") == (got["timing"] == "segment")
    assert seconds < 300  # one spawn for all 96 cases (about 15 s alone)


def test_csv_header_is_jax_row_keys(jax_rows, port_rows, tmp_path):
    assert sweep.COLUMNS == list(jax_rows[0])
    out = tmp_path / "s.csv"
    sweep.write_csv(port_rows[0][:3], out)
    with open(out) as f:
        reader = csv.DictReader(f)
        assert reader.fieldnames == list(jax_rows[0])
        assert len(list(reader)) == 3


# -- the config reader -------------------------------------------------------------

@pytest.mark.parametrize("path", CONFIGS, ids=[p.name for p in CONFIGS])
def test_reader_gives_what_safe_load_gives(path):
    assert len(CONFIGS) == 3
    assert sweep.read_config(path) == yaml.safe_load(path.read_text())


_RESERVED = {"yes", "no", "on", "off", "null", "true", "false"}
WORDS = st.from_regex(r"[a-z_][a-z0-9_]{0,8}", fullmatch=True).filter(
    lambda w: w.lower() not in _RESERVED)
SCALARS = st.one_of(
    st.integers(-10 ** 6, 10 ** 6).map(str),
    st.floats(-1e6, 1e6, allow_nan=False).map(lambda x: f"{x:.6e}"),
    st.floats(-1e3, 1e3, allow_nan=False).map(lambda x: f"{x:.3f}"),
    st.sampled_from(["true", "false", "True", "FALSE"]), WORDS)
FLOWS = st.lists(SCALARS, max_size=4).map(lambda v: f"[{', '.join(v)}]")
ITEMS = st.lists(st.one_of(SCALARS, FLOWS), min_size=1, max_size=4)
VALUES = st.one_of(SCALARS, FLOWS, ITEMS)


@st.composite
def documents(draw):
    keys = draw(st.lists(WORDS, min_size=1, max_size=6, unique=True))
    indent = draw(st.sampled_from(["", "  ", "    "]))
    lines = []
    for k in keys:
        if draw(st.booleans()):
            lines.append("# " + draw(WORDS))
        v = draw(VALUES)
        note = "  # " + draw(WORDS) if draw(st.booleans()) else ""
        if isinstance(v, list):
            lines.append(f"{k}:{note}")
            lines += [f"{indent}- {item}" for item in v]
        else:
            lines.append(f"{k}: {v}{note}")
        if draw(st.booleans()):
            lines.append("")
    return "\n".join(lines) + "\n"


@settings(max_examples=200, deadline=None)
@given(documents())
def test_reader_matches_safe_load_on_generated_matrices(text):
    assert sweep.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text,line", [
    ("gdims:\n  a: 1\n", 2),                 # a nested mapping
    ("method: 'ring'\n", 1),                 # a quoted string
    ("tol: 1e-5\n", 1),                      # no dot: YAML reads a string
    ("x: [[1, 2], [3]]\n", 1),               # a nested flow list
    ("x: {a: 1}\n", 1),                      # a flow mapping
    ("x: &a 1\n", 1),                        # an anchor
    ("x:\n\t- 1\n", 2),                      # a tab
    ("x: 1\n  - 2\n", 2),                    # an item under a scalar
    ("x:\n  - 1\n    - 2\n", 3),             # another indent
    ("x: 1\nx: 2\n", 2),                     # a repeated key
    ("on: 1\n", 1),                          # a key YAML reads as True
    ("x: yes\n", 1),                         # a value YAML reads as True
    ("x: [1, 2,]\n", 1),                     # an empty flow item
    ("x: 010\n", 1),                         # YAML 1.1 octal
    ("- 1\n", 1),                            # a top-level list
])
def test_reader_refuses_what_is_outside_the_subset(text, line):
    with pytest.raises(ValueError, match=f"line {line}:"):
        sweep.parse_yaml(text)


def test_empty_config_reads_as_none_and_json_reads_as_json(tmp_path):
    assert sweep.parse_yaml("# nothing\n\n") is None
    p = tmp_path / "m.json"
    p.write_text(json.dumps({"gdims": [[8, 8, 8]], "pdims": [[1, 1]]}))
    assert sweep.read_config(p) == {"gdims": [[8, 8, 8]], "pdims": [[1, 1]]}


# -- cases, worlds and rows ---------------------------------------------------------

def _case(**kw):
    case = dict(gdims=[8, 8, 8], pdims=[1, 1], method="all_to_all",
                dtype="float32", axis_contiguous=True,
                halo_extents=[0, 0, 0], padding=[0, 0, 0])
    case.update(kw)
    return case


@pytest.mark.parametrize("exc,prefix", [
    (CannotRun("ranks that share a card"), "CannotRun: "),
    (ValueError("bad halo"), "")], ids=["CannotRun", "other"])
def test_a_raising_case_is_an_error_row(monkeypatch, tmp_path, capsys, exc,
                                        prefix):
    def boom(*a, **k):
        raise exc
    monkeypatch.setattr(sweep, "run_case", boom)
    out = tmp_path / "rows.json"
    sweep.world_body(0, [(3, _case())], dict(n_warmup=0, n_trials=1,
                                             check=True, iters=1), "cpu",
                     str(out))
    ((i, row),) = json.loads(out.read_text())
    assert i == 3 and row["status"] == "ERROR"
    assert row["error"] == f"{prefix}{exc}"
    # the JAX runner's error-row form
    assert (row["pdims"], row["halo_extents"]) == ("[1, 1]", "[0, 0, 0]")
    assert list(row) == sweep.COLUMNS
    assert "-> ERROR" in capsys.readouterr().out


def test_cases_run_in_one_spawn_per_world(monkeypatch):
    calls = []

    def fake_world(world, cases, opts, device, body):
        calls.append((world, [i for i, _ in cases]))
        return [(i, {"status": "ok", "world": world}) for i, _ in cases]

    monkeypatch.setattr(sweep, "run_world", fake_world)
    cfg = {"gdims": [[8, 8, 8]], "pdims": [[1, 1], [2, 1], [0, 0], [1, 2],
                                           [4, 2]],
           "method": ["all_to_all", "ring"]}
    rows = sweep.run_sweep(cfg, "cpu", ranks=4)
    assert calls == [(1, [0, 1]), (2, [2, 3, 6, 7]), (4, [4, 5])]
    assert [r.get("world") for r in rows] == [1, 1, 2, 2, 4, 4, 2, 2,
                                              None, None]
    assert all(r["status"] == "ERROR" and r["error"].startswith(
        "CannotRun: needs 8 ranks") for r in rows[8:])


def test_one_grid_per_world_key(monkeypatch):
    made = []
    real = sweep.make_grid
    monkeypatch.setattr(sweep, "make_grid",
                        lambda *a, **k: made.append(a[0]) or real(*a, **k))
    grids = {}
    rows = [sweep.run_case(_case(dtype=d, axis_contiguous=ac), 0, 1, True, 1,
                           "cpu", grids)
            for ac in (True, False) for d in ("float32", "float64")]
    assert len(made) == 2 and len(grids) == 2
    assert [r["status"] for r in rows] == ["ok"] * 4
    assert {r["timing"] for r in rows} == {"segment"}
    row = sweep.run_case(_case(halo_extents=[1, 0, 2]), 0, 1, True, 1, "cpu",
                         grids)
    assert row["timing"] == "chain" and row["halo_extents"] == "1x0x2"
    assert len(made) == 2


def test_main_exit_codes(monkeypatch, tmp_path, capsys):
    empty = tmp_path / "empty.yaml"
    empty.write_text("# no keys\n")
    assert sweep.main([str(empty), "-o", str(tmp_path / "a.csv")]) == 2
    no_cases = tmp_path / "none.yaml"
    no_cases.write_text("gdims:\n  - [8, 8, 8]\nmethod: []\n")
    assert sweep.main([str(no_cases), "--device", "cpu"]) == 2
    cfg = tmp_path / "one.yaml"
    cfg.write_text("gdims:\n  - [8, 8, 8]\npdims:\n  - [1, 1]\n"
                   "n_warmup: 0\nn_trials: 1\niters: 1\n")
    out = tmp_path / "one.csv"
    assert sweep.main([str(cfg), "-o", str(out), "--device", "cpu",
                       "--ranks", "1"]) == 0
    with open(out) as f:
        (row,) = list(csv.DictReader(f))
    assert row["status"] == "ok" and row["pdims"] == "(1, 1)"
    monkeypatch.setattr(sweep, "run_sweep",
                        lambda *a: [dict(row, status="FAIL")])
    assert sweep.main([str(cfg), "-o", str(out), "--device", "cpu"]) == 1


def test_the_card_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        sweep.run_sweep({"gdims": [[8, 8, 8]]}, "cuda")
