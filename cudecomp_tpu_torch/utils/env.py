"""Environment knobs and logging helpers (``cudecomp_tpu.utils.env``).

The knobs this package reads, each with the JAX package's name and
default:

  CUDECOMP_TPU_FFT_FUSED2=1                   the split-complex FFT takes
                                              K5, the fused 2-axis DFT (off)
  CUDECOMP_TPU_ENABLE_PERFORMANCE_REPORT=1    op sample capture (off)
  CUDECOMP_TPU_PERF_DETAIL                    report detail level (0)
  CUDECOMP_TPU_PERF_N_WARMUP                  samples discarded per op (1)
  CUDECOMP_TPU_PERF_MAX_SAMPLES               samples kept per op (1000)
  CUDECOMP_TPU_PERF_WRITE_DIR                 CSV export directory (unset)
  CUDECOMP_TPU_DISABLE_TRACING=1              no profiler or NVTX ranges
  CUDECOMP_TPU_AUTOTUNE_TRANSPOSE_METHODS     comma list; "^name" excludes
  CUDECOMP_TPU_AUTOTUNE_P_ROW_RANGE="lo,hi"   clamp process-grid rows
  CUDECOMP_TPU_AUTOTUNE_P_COL_RANGE="lo,hi"   clamp process-grid cols

``CUDECOMP_TPU_FFT_FUSED2``, ``_PERF_DETAIL`` and ``_PERF_WRITE_DIR`` are
read on every call; the others when the module that reads them is
imported (``performance``, ``utils.tracing``), or by the autotuner when it
runs, as in JAX.  The JAX package's other knobs tune TPU machinery.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Sequence, Tuple

_PREFIX = "cudecomp_tpu_torch"


def fft_fused2() -> bool:
    """Whether ``CUDECOMP_TPU_FFT_FUSED2=1`` is set."""
    return os.environ.get("CUDECOMP_TPU_FFT_FUSED2", "0") == "1"


def perf_report_enabled() -> bool:
    return os.environ.get("CUDECOMP_TPU_ENABLE_PERFORMANCE_REPORT",
                          "0") == "1"


def perf_detail() -> int:
    return int(os.environ.get("CUDECOMP_TPU_PERF_DETAIL", "0"))


def perf_n_warmup() -> int:
    return int(os.environ.get("CUDECOMP_TPU_PERF_N_WARMUP", "1"))


def perf_max_samples() -> int:
    return int(os.environ.get("CUDECOMP_TPU_PERF_MAX_SAMPLES", "1000"))


def perf_write_dir() -> Optional[str]:
    return os.environ.get("CUDECOMP_TPU_PERF_WRITE_DIR")


def tracing_disabled() -> bool:
    return os.environ.get("CUDECOMP_TPU_DISABLE_TRACING", "0") == "1"


def log_info(msg: str):
    print(f"{_PREFIX}: {msg}", file=sys.stderr)


def log_warn(msg: str):
    print(f"{_PREFIX}:WARN: {msg}", file=sys.stderr)


def candidate_spec(env_name: str) -> Tuple[List[str], set]:
    """(included names in order, excluded names) of a comma list in
    ``env_name``, lower-cased; ``^name`` excludes
    (``src/autotune.cc:108-144``)."""
    spec = os.environ.get(env_name, "").strip()
    items = [s.strip() for s in spec.split(",") if s.strip()]
    excludes = {s[1:].lower() for s in items if s.startswith("^")}
    includes = [s.lower() for s in items if not s.startswith("^")]
    return includes, excludes


def filter_candidates(env_name: str, all_values: Sequence,
                      value_of=lambda v: v.value):
    """Apply the include/exclude list in ``env_name`` to candidate enums;
    a list that leaves none is ignored with a warning."""
    includes, excludes = candidate_spec(env_name)
    vals = list(all_values)
    if not includes and not excludes:
        return vals
    if includes:
        vals = [v for v in vals if value_of(v).lower() in includes]
    if excludes:
        vals = [v for v in vals if value_of(v).lower() not in excludes]
    if not vals:
        log_warn(f"{env_name} filtered out every candidate; ignoring it")
        return list(all_values)
    return vals


def int_range(env_name: str) -> Optional[Tuple[int, int]]:
    """``(lo, hi)`` from ``env_name="lo,hi"``; None when unset or
    malformed (with a warning)."""
    spec = os.environ.get(env_name, "").strip()
    if not spec:
        return None
    try:
        lo, hi = (int(x) for x in spec.split(","))
        return (lo, hi)
    except ValueError:
        log_warn(f"could not parse {env_name}={spec!r}; expected 'lo,hi'")
        return None
