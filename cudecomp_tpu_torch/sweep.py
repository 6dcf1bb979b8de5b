"""The sweep runner: configured cartesian sweeps of the transpose round
trip, with CSV capture.

The port of ``benchmarks/run_sweep.py``, the counterpart of the
reference's ``tests/test_runner.py`` and ``benchmark/benchmark_runner.py``:
a config names lists of grid sizes, process grids, transpose methods,
dtypes, layouts, halo extents and paddings; every combination is one case
(:func:`parse_case_matrix`).  A case (:func:`run_case`) scatters the
global-linear-index field (the reference suite's ``initializePencil``
pattern), runs X2Y;Y2Z;Z2Y;Y2X and compares the gathered result with the
field bit for bit, then times the round trip.  One CSV row per case, with
the JAX runner's columns in its order (:data:`COLUMNS`), so that
``benchmarks/plot_heatmaps.py`` reads the port's CSV unchanged.

A case's pdims product is its world (``--ranks`` for pdims (0, 0), which
the autotuner picks).  The cases of one world run in one spawn of that
many ranks: gloo ranks on the CPU (``--device cpu``), or ranks that share
``cuda:0`` over gloo (``--device cuda``, the default).  Within a world
one grid serves every case of the same gdims, pdims, layout and method:
a mesh keeps its process groups for the life of the process.  A case that
raises is an ``ERROR`` row naming the error, as in the JAX runner;
``config.CannotRun`` keeps its class name there, so that a limit of the
machine (such as the rings on ranks that share one card) reads apart from
a fault.  Rank 0's times go into the row.

Usage::

    python -m cudecomp_tpu_torch.sweep CONFIG [-o out.csv]
        [--device {cuda,cpu}] [--ranks R]

The machine with the card has no PyYAML, so :func:`parse_yaml` reads the
subset of YAML that the configs under ``benchmarks/`` use; a ``.json``
config is read with ``json``.  Exit status: 1 if any row is not ``ok``, 2
for an empty or non-mapping config or an empty matrix.
"""

from __future__ import annotations

import argparse
import csv
import itertools
import json
import re
import sys
import tempfile
import traceback
from pathlib import Path

import numpy as np
import torch

from cudecomp_tpu_torch.config import AutotuneOptions, CannotRun, GridConfig
from cudecomp_tpu_torch.grid import make_grid
from cudecomp_tpu_torch.ops import transpose as tr
from cudecomp_tpu_torch.performance import (as_torch_dtype,
                                            segment_roundtrip, time_fn)
from cudecomp_tpu_torch.utils import testing
from cudecomp_tpu_torch.utils.arrays import gather_global, scatter_global

KEYS = ["gdims", "pdims", "method", "dtype", "axis_contiguous",
        "halo_extents", "padding"]
#: the CSV's columns: the JAX runner's row keys, in its order
COLUMNS = ["gdims", "pdims", "method", "dtype", "axis_contiguous",
           "halo_extents", "padding", "status", "error", "roundtrip_ms",
           "a2a_ms", "local_ms", "timing"]
#: seconds one world's spawn may take
WORLD_TIMEOUT = 1800


def parse_case_matrix(cfg):
    """Every combination of the config's lists, one dict per case, in the
    JAX runner's order (an absent key is ``[None]``)."""
    lists = {k: cfg.get(k, [None]) for k in KEYS}
    for combo in itertools.product(*(lists[k] for k in KEYS)):
        yield dict(zip(KEYS, combo))


# -- the config reader -------------------------------------------------------------

_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_]*):(?:[ ]+(.*))?")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?")
_WORD = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
_BOOLS = {"true": True, "True": True, "TRUE": True,
          "false": False, "False": False, "FALSE": False}
# words that YAML reads as booleans or null: outside the subset
_RESERVED = {"yes", "Yes", "YES", "no", "No", "NO", "on", "On", "ON",
             "off", "Off", "OFF", "null", "Null", "NULL"}


def _fail(n: int, line: str, why: str):
    raise ValueError(f"line {n}: {why}: {line!r} (the sweep reads a block "
                     f"mapping of scalars and of block lists of scalars or "
                     f"flow lists)")


def _scalar(text: str, n: int, line: str):
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    if text in _BOOLS:
        return _BOOLS[text]
    if _WORD.fullmatch(text) and text not in _RESERVED:
        return text
    _fail(n, line, f"{text!r} is no int, float, true/false or bare word")


def _value(text: str, n: int, line: str):
    if text.startswith("["):
        if not text.endswith("]"):
            _fail(n, line, "an unclosed flow list")
        inner = text[1:-1].strip()
        if not inner:
            return []
        parts = [p.strip() for p in inner.split(",")]
        if not all(parts):
            _fail(n, line, "an empty flow-list item")
        return [_scalar(p, n, line) for p in parts]
    return _scalar(text, n, line)


def _strip_comment(line: str) -> str:
    m = re.search(r"(?:^|\s)#", line)
    return (line[:m.start()] if m else line).rstrip()


def parse_yaml(text: str):
    """The config in ``text``, read as the YAML subset of the configs
    under ``benchmarks/``: a block mapping whose values are scalars, flow
    lists or block lists; list items that are scalars or flow lists like
    ``[8, 8, 8]``; ``#`` comments; ints, floats, ``true``/``false`` and
    bare words.  Anything else raises ``ValueError`` naming the line.  An
    empty document is None, as ``yaml.safe_load`` gives."""
    out = {}
    open_key, indent = None, None  # the key whose block list may follow
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw:
            _fail(n, raw, "a tab")
        line = _strip_comment(raw)
        if not line.strip():
            continue
        rest = line.lstrip(" ")
        if line[0] == " " or rest.startswith("-"):
            if rest != "-" and not rest.startswith("- "):
                _fail(n, raw, "an indented line that is no list item")
            if open_key is None:
                _fail(n, raw, "a list item under no key")
            lead = len(line) - len(rest)
            if indent is not None and lead != indent:
                _fail(n, raw, "a list item at another indent")
            indent = lead
            item = rest[1:].strip()
            if not item:
                _fail(n, raw, "an empty list item")
            out[open_key] = (out[open_key] or []) + [_value(item, n, raw)]
            continue
        m = _KEY.fullmatch(line)
        if not m:
            _fail(n, raw, "no 'key:' line")
        key, text_value = m.group(1), (m.group(2) or "").strip()
        if key in _RESERVED or key in _BOOLS:
            _fail(n, raw, f"the key {key!r}, which YAML reads as no string")
        if key in out:
            _fail(n, raw, f"a second {key!r}")
        indent = None
        if text_value:
            out[key], open_key = _value(text_value, n, raw), None
        else:
            out[key], open_key = None, key
    return out or None


def read_config(path):
    """The config at ``path``: JSON for a ``.json`` file, else
    :func:`parse_yaml`."""
    text = Path(path).read_text()
    if str(path).endswith(".json"):
        return json.loads(text)
    return parse_yaml(text)


# -- one case ----------------------------------------------------------------------

def _extents(v):
    return tuple(v or (0, 0, 0))


def run_case(case, n_warmup, n_trials, check, iters=8, device="cuda",
             grids=None) -> dict:
    """One case on this rank (collective over the world at P > 1): its
    CSV row.  ``grids`` caches the grids of a world by (gdims, pdims,
    layout, method)."""
    gdims = tuple(case["gdims"])
    pdims = tuple(case["pdims"]) if case["pdims"] else (0, 0)
    key = (gdims, pdims, bool(case["axis_contiguous"]), case["method"])
    grid = None if grids is None else grids.get(key)
    if grid is None:
        kw = {}
        if case["axis_contiguous"]:
            kw["transpose_axis_contiguous"] = (True, True, True)
        if case["method"]:
            kw["transpose_method"] = case["method"]
        cfg = GridConfig(gdims=gdims, pdims=pdims, **kw)
        opts = AutotuneOptions(n_warmup=1, n_trials=2)
        grid = make_grid(cfg, device,
                         autotune_options=opts if pdims == (0, 0) else None)
        if grids is not None:
            grids[key] = grid

    dtype = np.dtype(case["dtype"] or "float32")
    he, pad = _extents(case["halo_extents"]), _extents(case["padding"])
    row = dict(gdims="x".join(map(str, gdims)), pdims=f"{grid.pdims}",
               method=grid.config.transpose_method.value, dtype=str(dtype),
               axis_contiguous=bool(case["axis_contiguous"]),
               halo_extents="x".join(map(str, he)),
               padding="x".join(map(str, pad)), status="ok", error="",
               roundtrip_ms="", a2a_ms="", local_ms="", timing="")

    x_global = testing.global_index_field(gdims, dtype=as_torch_dtype(dtype))
    buf = scatter_global(grid, x_global, 0, halo_extents=he, padding=pad)

    def roundtrip(b):
        y = tr.transpose_x_to_y(grid, b, input_halo_extents=he,
                                input_padding=pad)
        z = tr.transpose_y_to_z(grid, y)
        y2 = tr.transpose_z_to_y(grid, z)
        return tr.transpose_y_to_x(grid, y2, output_halo_extents=he,
                                   output_padding=pad)

    if check:
        # gloo gathers CPU tensors
        got = gather_global(grid, roundtrip(buf).cpu(), 0, halo_extents=he,
                            padding=pad)
        if not torch.equal(got, x_global):
            row["status"] = "FAIL"
            row["error"] = "roundtrip mismatch"
            return row

    if he == (0, 0, 0) and pad == (0, 0, 0):
        seg = segment_roundtrip(grid, as_torch_dtype(dtype), iters=iters,
                                n_warmup=n_warmup, n_trials=n_trials,
                                record=False)
        row["roundtrip_ms"] = f"{seg['total_ms']:.4f}"
        row["a2a_ms"] = f"{seg['a2a_ms']:.4f}"
        row["local_ms"] = f"{seg['local_ms']:.4f}"
        row["timing"] = "segment"
    else:
        ts = time_fn(roundtrip, buf, n_warmup=n_warmup, n_trials=n_trials,
                     iters=iters, device=grid.device)
        row["roundtrip_ms"] = f"{1e3 * min(ts):.4f}"
        row["timing"] = "chain"
    return row


def error_row(case, exc: BaseException) -> dict:
    """The ``ERROR`` row of a case that raised ``exc`` (the JAX runner's
    form; a ``CannotRun`` is named)."""
    err = f"CannotRun: {exc}" if isinstance(exc, CannotRun) else str(exc)
    return dict(gdims="x".join(map(str, case["gdims"])),
                pdims=str(case["pdims"]), method=str(case["method"]),
                dtype=str(case["dtype"]),
                axis_contiguous=bool(case["axis_contiguous"]),
                halo_extents=str(case["halo_extents"]),
                padding=str(case["padding"]), status="ERROR",
                error=err[:200], roundtrip_ms="", a2a_ms="", local_ms="",
                timing="")


def case_line(row) -> str:
    return (f"{row['gdims']:>12s} pdims={row['pdims']:8s} "
            f"{row['method']:12s} {row['dtype']:10s} -> {row['status']} "
            f"{row['roundtrip_ms']}")


# -- one world ---------------------------------------------------------------------

def world_body(rank: int, cases, opts: dict, device: str,
               out_path: str) -> None:
    """Every ``(index, case)`` of one world on this rank, each failure its
    case's row; rank 0 prints each row and writes ``[(index, row)]`` to
    ``out_path`` as JSON."""
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(device)
    grids, rows = {}, []
    for i, case in cases:
        try:
            row = run_case(case, device=dev, grids=grids, **opts)
        except Exception as e:  # a case's failure is its row; go on
            if rank == 0 and not isinstance(e, CannotRun):
                traceback.print_exc()
            row = error_row(case, e)
        if rank == 0:
            print(case_line(row), flush=True)
        rows.append((i, row))
    if rank == 0:
        Path(out_path).write_text(json.dumps(rows))


def run_world(world: int, cases, opts: dict, device: str,
              body=world_body) -> list:
    """``[(index, row)]`` of ``cases`` run on ``world`` spawned ranks, each
    running ``body`` (:func:`world_body`, or a module-level function with
    its arguments that calls it)."""
    with tempfile.TemporaryDirectory() as tmp:
        out, init = str(Path(tmp, "rows.json")), str(Path(tmp, "pg"))
        args = (cases, opts, device, out)
        what = f"the sweep's world of {world}"
        run = (testing.run_card_ranks if device == "cuda"
               else testing.run_cpu_ranks)
        run(body, world, init, args, WORLD_TIMEOUT, what)
        return [tuple(r) for r in json.loads(Path(out).read_text())]


def case_world(case, ranks: int) -> int:
    """The ranks a case runs on: its pdims product, or ``ranks`` for
    pdims (0, 0)."""
    pd = tuple(case["pdims"]) if case["pdims"] else (0, 0)
    return ranks if pd == (0, 0) else pd[0] * pd[1]


def run_sweep(cfg: dict, device: str = "cuda", ranks: int = 4,
              body=world_body) -> list:
    """Every case of ``cfg``'s matrix, each world spawned once (its ranks
    running ``body``, see :func:`run_world`); the rows in the matrix's
    order.  A case that needs more than ``ranks`` ranks is an ``ERROR``
    row (``CannotRun``)."""
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the sweep on the card needs CUDA")
        from cudecomp_tpu_torch.ops import cuda_kernels, peer_kernels
        cuda_kernels.build()  # once here, not in every rank
        peer_kernels.build()
    opts = dict(n_warmup=cfg.get("n_warmup", 2),
                n_trials=cfg.get("n_trials", 5),
                check=cfg.get("check_correctness", True),
                iters=cfg.get("iters", 8))
    cases = list(parse_case_matrix(cfg))
    rows = [None] * len(cases)
    worlds = {}
    for i, case in enumerate(cases):
        w = case_world(case, ranks)
        if w > ranks:
            rows[i] = error_row(case, CannotRun(
                f"needs {w} ranks, the sweep runs at most {ranks}"))
            print(case_line(rows[i]), flush=True)
        else:
            worlds.setdefault(w, []).append((i, case))
    for w, wcases in sorted(worlds.items()):
        for i, row in run_world(w, wcases, opts, device, body):
            rows[i] = row
    return rows


def write_csv(rows, path) -> None:
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=COLUMNS)
        w.writeheader()
        w.writerows(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m cudecomp_tpu_torch.sweep",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("-o", "--output", default="sweep_results.csv")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ranks", type=int, default=4,
                    help="the ranks of pdims (0, 0) cases, and the most any "
                         "case may use")
    args = ap.parse_args(argv)

    cfg = read_config(args.config)
    if not isinstance(cfg, dict):
        print(f"error: empty or non-mapping config {args.config}",
              file=sys.stderr)
        return 2
    rows = run_sweep(cfg, args.device, args.ranks)
    if not rows:
        print("error: config produced zero cases (empty matrix key?)",
              file=sys.stderr)
        return 2
    write_csv(rows, args.output)
    n_bad = sum(r["status"] != "ok" for r in rows)
    print(f"\n{len(rows)} cases, {n_bad} failures -> {args.output}")
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())
