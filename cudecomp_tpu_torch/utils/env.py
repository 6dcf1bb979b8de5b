"""Logging helpers (the message half of ``cudecomp_tpu.utils.env``).

The environment-variable knobs of the JAX package tune TPU machinery and
its autotuner; none of them is read here yet.
"""

from __future__ import annotations

import sys

_PREFIX = "cudecomp_tpu_torch"


def log_info(msg: str):
    print(f"{_PREFIX}: {msg}", file=sys.stderr)
