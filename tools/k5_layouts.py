#!/usr/bin/env python3
"""K5 under each cluster layout that fits a block, and with parts of its
work taken out, on one card.

    python3 tools/k5_layouts.py [--x 129] [--ablate] [--out FILE]

Prints what ``nvcc -Xptxas -v`` reports for every template instance of
``cudecomp_tpu_torch/csrc/dft2.cu`` (registers, spills, stack), then runs
``chip_smoke.py``'s phase-4 checks of K5 (its shapes, forward and inverse,
against ``dft2_ref`` and complex128 ``torch.fft.fftn``).  Then, at
``(x, 256, 256)`` complex64 (the r2c spectrum of a 256^3 field by
default), it times K5 with every (cluster, chunk) layout whose block fits
227 KB, the layout ``dft2_plan`` picks first.

With ``--ablate`` it also builds copies of ``dft2.cu``, each with one part
of the work taken out by a text edit, and times them with the picked
layout:

  * ``no_fft``: the in-register FFTs do nothing (their arithmetic gone,
    every load, store and barrier kept);
  * ``no_twiddle``: the stages store without multiplying by the twiddles
    between them;
  * ``local_rows``: the column pass gathers every row from the block's own
    shared memory instead of the row's owner (no traffic between SMs);
  * ``no_columns``: the block writes its transformed rows straight out
    after the first cluster.sync() (no column pass).

Every ablation computes a wrong transform: only its time means something.
An edit that no longer matches the source raises.

Each group of variants is timed in turns (one pass over the list, one
back; CUDA events, mean of 5 trials of 20 calls after 3 warm-up calls),
beside ``torch.fft.fftn(dim=(1, 2))``, ``dft2_ref`` and ``clone()`` of the
same bytes.  Prints the card's name and power limit, one line per variant,
and the results as one JSON object, which ``--out`` also writes to a file.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from statistics import mean

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

# (text in csrc/dft2.cu, its replacement) per ablation; each must match once
ABLATIONS = {
    "no_fft": ((
        "  constexpr int kLog = ilog2(L);",
        "  return;\n  constexpr int kLog = ilog2(L);"),),
    "no_twiddle": (
        ("dst[pad(ka + kRowRadix * nb)] = cmul(v[i], tw2[nb * ka]);",
         "dst[pad(ka + kRowRadix * nb)] = v[i];"),
        ("scratch[(ka + CA * nb) * chunk + c] = cmul(v[i], tw1[nb * ka]);",
         "scratch[(ka + CA * nb) * chunk + c] = v[i];")),
    "local_rows": ((
        "row_at[i] = map_rank(shared_addr(rows + (i % R) * kPitch), i / R);",
        "row_at[i] = map_rank(shared_addr(rows + (i % R) * kPitch), r);"),),
    "no_columns": ((
        "  const int cols = N2 / C;",
        "  {\n"
        "    float2* rb = out + (plane * n1 + static_cast<int64_t>(r) * R)"
        " * N2;\n"
        "    for (int i = t; i < R * N2; i += kThreads)\n"
        "      rb[i] = rows[(i / N2) * kPitch + pad(i % N2)];\n"
        "    cluster.sync();\n"
        "    return;\n"
        "  }\n"
        "  const int cols = N2 / C;"),),
}


def ptxas_report() -> list:
    """``(instance, info)`` per kernel of ``csrc/dft2.cu`` from
    ``nvcc -Xptxas -v``: the template arguments and ptxas's lines."""
    from cudecomp_tpu_torch.utils import cuda_build
    out = []
    for name, info in cuda_build.ptxas_report(("dft2.cu",)):
        t = re.search(r"dft2_kernelILi(\d+)ELi(\d+)ELi(\d+)E", name)
        out.append((f"<N2={t.group(1)}, A={t.group(2)}, M={t.group(3)}>"
                    if t else name, info))
    return out


def build_ablation(tmp: Path, name: str, edits):
    """The entry ``cudecomp_dft2`` of csrc/dft2.cu with ``edits``, built
    with K0's file as ``utils/cuda_build`` builds K5."""
    from cudecomp_tpu_torch.ops import dft2 as D
    from cudecomp_tpu_torch.utils import cuda_build
    text = (cuda_build.CSRC_DIR / "dft2.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"ablation {name}: {old!r} is not in "
                               f"csrc/dft2.cu exactly once")
        text = text.replace(old, new)
    src = tmp / f"dft2_{name}.cu"
    src.write_text(text)
    lib = tmp / f"libdft2_{name}.so"
    subprocess.run([str(cuda_build.nvcc_path()), *cuda_build.NVCC_FLAGS,
                    "-o", str(lib), str(cuda_build.CSRC_DIR / "probe.cu"),
                    str(src)], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).cudecomp_dft2
    fn.argtypes = list(D.SIGNATURES[0][1])
    fn.restype = ctypes.c_int
    return fn


def in_turns(launchers: dict, t) -> dict:
    """``{name: [ms, ms]}``: each launcher timed by ``t`` in one pass over
    the list and one back."""
    names = list(launchers)
    runs = {n: [] for n in names}
    for n in names + names[::-1]:
        runs[n].append(t(launchers[n]))
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--x", type=int, default=129)
    ap.add_argument("--ablate", action="store_true",
                    help="also time K5 with parts of its work taken out")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("CUDA is not available: nothing to time", file=sys.stderr)
        return 1
    from cudecomp_tpu_torch import performance as perf
    from cudecomp_tpu_torch.ops import dft2 as D

    card = chip_smoke.card_line()
    print(f"card: {card}")
    torch.cuda.init()
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(
            len(ABLATIONS) + 1) as pool:
        # the ablations build while the ptxas report and the checks run
        ablated = ({n: pool.submit(build_ablation, Path(tmp), n, e)
                    for n, e in ABLATIONS.items()} if args.ablate else {})
        report = ptxas_report()
        for name, info in report:
            print(f"ptxas {name}: {info}")
        D.build()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(5)
        worst = chip_smoke.dft2_kernel_checks(torch, D, gen)
        print(f"K5 within {chip_smoke.K5_EPS} x max|reference| of dft2_ref "
              f"and complex128 fftn on {len(chip_smoke.K5_SHAPES)} shapes, "
              f"forward and inverse (worst {worst['ref']:.3e} and "
              f"{worst['c128']:.3e}); clusters {worst['clusters']}")
        ablated = {n: f.result() for n, f in ablated.items()}

        shape = (args.x, 256, 256)
        x = chip_smoke.complex_field(torch, shape, gen)
        out = torch.empty_like(x)
        tw = D.twiddles(256, x.dtype, x.device)
        stream = torch.cuda.current_stream().cuda_stream
        want = D.dft2_ref(x)
        picked = D.dft2_plan(256, 256)

        def launcher(c, w, fn=D._lib().cudecomp_dft2):
            def launch():
                err = fn(x.data_ptr(), out.data_ptr(), tw.data_ptr(),
                         tw.data_ptr(), shape[0], 256, 256, c, w, 0, 1.0,
                         stream)
                if err:
                    raise RuntimeError(f"K5 layout ({c}, {w}): error {err}")
            return launch

        def t(fn):
            return mean(perf.time_fn(fn, n_warmup=3, n_trials=5,
                                     iters=20)) * 1e3

        layouts = [(picked.cluster, picked.chunk)] + [
            (c, w) for c in D.CLUSTERS for w in D.CHUNKS
            if (c, w) != (picked.cluster, picked.chunk)
            and (256 // c) % w == 0
            and D.smem_bytes(256, 256, c, w) <= D.BLOCK_SMEM]
        errs = {}
        for lay in layouts:
            out.zero_()
            launcher(*lay)()
            torch.cuda.synchronize()
            errs[lay] = float((out - want).abs().max() / want.abs().max())
            if not errs[lay] <= chip_smoke.K5_EPS:
                raise AssertionError(f"K5 layout {lay}: {errs[lay]}")
        runs = in_turns({lay: launcher(*lay) for lay in layouts}, t)
        nbytes = 2 * x.numel() * x.element_size()
        rows = []
        for lay in layouts:
            ms = mean(runs[lay])
            rows.append({"cluster": lay[0], "chunk": lay[1],
                         "smem": D.smem_bytes(256, 256, *lay), "ms": ms,
                         "runs_ms": runs[lay],
                         "gbs": nbytes / (ms * 1e-3) / 1e9,
                         "max_rel_err": errs[lay]})
            print(f"[{card}] K5 {shape} c64, cluster {lay[0]}, chunk "
                  f"{lay[1]}, {rows[-1]['smem']} B shared per block: "
                  f"{ms:.4f} ms = {rows[-1]['gbs']:.0f} GB/s (runs "
                  f"{runs[lay]})")
        ablation = {}
        if ablated:
            base = launcher(picked.cluster, picked.chunk)
            runs = in_turns({"base": base, **{
                n: launcher(picked.cluster, picked.chunk, fn)
                for n, fn in ablated.items()}}, t)
            ablation = {n: {"ms": mean(r), "runs_ms": r}
                        for n, r in runs.items()}
            for n, a in ablation.items():
                print(f"[{card}] K5 {shape} c64, clusters of "
                      f"{picked.cluster}, {picked.chunk}-column chunks, "
                      f"{n}: {a['ms']:.4f} ms "
                      f"({a['ms'] - ablation['base']['ms']:+.4f} ms; runs "
                      f"{a['runs_ms']})")
    cufft_ms = t(lambda: torch.fft.fftn(x, dim=(1, 2)))
    ref_ms = t(lambda: D.dft2_ref(x))
    clone_ms = t(x.clone)
    print(f"[{card}] torch.fft.fftn(dim=(1, 2)) {cufft_ms:.4f} ms; dft2_ref "
          f"{ref_ms:.4f} ms; clone() {clone_ms:.4f} ms = "
          f"{nbytes / (clone_ms * 1e-3) / 1e9:.0f} GB/s; bound "
          f"{nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3:.4f} ms (bytes)")
    result = {"card": card, "shape": shape, "ptxas": report,
              "check_max_rel_err": max(worst["ref"], worst["c128"]),
              "layouts": rows, "ablation": ablation, "cufft_ms": cufft_ms,
              "dft2_ref_ms": ref_ms, "clone_ms": clone_ms, "bytes": nbytes}
    line = json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
