"""Environment knobs and logging helpers (``cudecomp_tpu.utils.env``).

Of the JAX package's knobs one is read here: ``CUDECOMP_TPU_FFT_FUSED2``
(off by default, as in JAX), which opts the split-complex FFT in to K5,
the fused 2-axis DFT.  It is read on every call, so a process can switch
it between solves.  The JAX package's other knobs tune TPU machinery and
its autotuner; none of them is read here yet.
"""

from __future__ import annotations

import os
import sys

_PREFIX = "cudecomp_tpu_torch"


def fft_fused2() -> bool:
    """Whether ``CUDECOMP_TPU_FFT_FUSED2=1`` is set."""
    return os.environ.get("CUDECOMP_TPU_FFT_FUSED2", "0") == "1"


def log_info(msg: str):
    print(f"{_PREFIX}: {msg}", file=sys.stderr)
