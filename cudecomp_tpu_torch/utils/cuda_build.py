"""Build the package's CUDA sources into shared libraries, load them, and
probe each one with K0.

Each library is compiled at first use by ``nvcc`` (found through
``torch.utils.cpp_extension.CUDA_HOME``) for Hopper::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/probe.cu \\
         csrc/<sources>

into ``cudecomp_tpu_torch/_build/`` and loaded with ``ctypes``.  Where the
package directory cannot be written (an installed copy), the libraries go
to ``$XDG_CACHE_HOME/cudecomp_tpu_torch`` (``~/.cache`` by default)
instead.  The sources carry plain C entry points, so no PyTorch header is
compiled and a build takes seconds.  The file name carries a hash of the
sources and the flags, so an edited source is rebuilt and an unchanged one
is reused.

K0, the probe (``csrc/probe.cu``, the port of the TPU probe in
``_platform_supports_pallas``), is compiled into every library.  ``load``
launches it once per loaded library on an (8, 128) float32 tensor on the
current CUDA device, synchronises and compares the copy bit for bit: a
broken toolkit, driver or binary raises at load, naming the library, and
not in the middle of a path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Sequence

import torch

from cudecomp_tpu_torch.utils.env import log_info

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: compiled into every library: K0 and the error-string entry
PROBE_SOURCE = "probe.cu"
PROBE_SHAPE = (8, 128)

#: K0 launches since the last :func:`reset_probe_count`
probe_launch_count = 0

_COMMON_SIGNATURES = (
    ("cudecomp_probe_copy", (ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_int64, ctypes.c_void_p), ctypes.c_int),
    ("cudecomp_cuda_error_string", (ctypes.c_int,), ctypes.c_char_p),
)


def reset_probe_count() -> None:
    global probe_launch_count
    probe_launch_count = 0


def nvcc_path() -> Path:
    """The toolkit's ``nvcc``; raises when no CUDA toolkit is installed."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (torch.utils.cpp_extension."
                           "CUDA_HOME is None); nvcc builds the kernels")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.is_file():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def build_dir() -> Path:
    """``BUILD_DIR`` when it (or, before the first build, the package
    directory) can be written; the per-user cache otherwise."""
    probe = BUILD_DIR if BUILD_DIR.exists() else BUILD_DIR.parent
    if os.access(probe, os.W_OK):
        return BUILD_DIR
    cache = Path(os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache")
    return cache / "cudecomp_tpu_torch"


def _sources(names: Sequence[str]):
    return [CSRC_DIR / n for n in names]


def library_path(name: str, sources: Sequence[str]) -> Path:
    """Where the library built from ``sources`` (file names in ``csrc/``)
    lives: the name carries a hash of the sources' bytes and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(sources):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, sources: Sequence[str]) -> Path:
    """Compile ``sources`` into ``lib<name>-<hash>.so`` unless it exists;
    returns its path.  Raises with nvcc's output when the build fails."""
    path = library_path(name, sources)
    if path.is_file():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: a concurrent process never
    # loads a half-written library
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = [str(nvcc_path()), *NVCC_FLAGS, "-o", str(tmp),
           *map(str, _sources(sources))]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {res.returncode}: "
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, path)
    for stale in path.parent.glob(f"lib{name}-*.so"):
        # another process's build in flight is no stale library
        if stale != path and not stale.name.endswith(".tmp.so"):
            stale.unlink(missing_ok=True)
    log_info(f"built {path} in {time.perf_counter() - t0:.1f} s")
    return path


def ptxas_report(sources: Sequence[str]) -> list:
    """``[kernel, info]`` for every kernel of ``sources`` (file names in
    ``csrc/``), from ``nvcc -Xptxas -v`` with the library's flags: the
    mangled name, then ptxas's register, spill and stack lines joined."""
    import re
    import tempfile
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        for src in _sources(sources):
            res = subprocess.run(
                [str(nvcc_path()), *flags, "-Xptxas", "-v", "-c", "-o",
                 str(Path(tmp) / "k.o"), str(src)],
                capture_output=True, text=True, check=True)
            for line in res.stderr.splitlines():
                m = re.search(r"entry function '(\w+)'", line)
                if m:
                    out.append([m.group(1), ""])
                elif out and ("registers" in line or "spill" in line):
                    info = line.split(":", 1)[-1].strip()
                    out[-1][1] = f"{out[-1][1]}; {info}".lstrip("; ")
    return out


def library_sources(sources: Sequence[str]) -> tuple:
    """The sources of a library: K0's file, then the kernel's own."""
    return (PROBE_SOURCE,) + tuple(sources)


def probe(lib, name: str, device="cuda") -> None:
    """K0: launch the library's probe copy on an (8, 128) float32 tensor,
    wait for it and compare bit for bit; raises naming the library."""
    global probe_launch_count
    x = torch.arange(PROBE_SHAPE[0] * PROBE_SHAPE[1], dtype=torch.float32,
                     device=device).reshape(PROBE_SHAPE)
    out = torch.full_like(x, float("nan"))
    cuda = x.device.type == "cuda"
    stream = torch.cuda.current_stream(x.device).cuda_stream if cuda else None
    err = lib.cudecomp_probe_copy(x.data_ptr(), out.data_ptr(), x.numel(),
                                  stream)
    if err != 0:
        msg = lib.cudecomp_cuda_error_string(err).decode()
        raise RuntimeError(f"K0 probe of library {name!r} failed to launch: "
                           f"{msg} ({err})")
    probe_launch_count += 1
    if cuda:
        torch.cuda.synchronize(x.device)  # a fault during the run shows here
    if not torch.equal(out, x):
        raise RuntimeError(f"K0 probe of library {name!r}: the device copy "
                           f"differs from its input; the library's kernels "
                           f"do not run on {x.device}")


@functools.lru_cache(maxsize=None)
def load(name: str, sources: Sequence[str], signatures=()) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``sources`` plus K0, set
    the ``(function, argtypes, restype)`` ``signatures``, and probe it with
    K0.  Cached per process; ``sources`` and ``signatures`` are tuples."""
    lib = ctypes.CDLL(str(build(name, library_sources(sources))))
    for fn, argtypes, restype in _COMMON_SIGNATURES + tuple(signatures):
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = restype
    probe(lib, name)
    return lib
