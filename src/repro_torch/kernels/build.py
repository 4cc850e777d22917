"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain ``extern "C"`` launcher, at first use, into
``src/repro_torch/_build/`` (git-ignored), and loaded with ``ctypes``.  No
PyTorch header is included, so a build takes seconds.  A library is rebuilt
when its source is newer than it.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
# a kernel that launches another from the device (a tail launch) is built
# relocatable and linked with the device runtime
DEVICE_LAUNCH = {"interval_join"}
DEVICE_LAUNCH_FLAGS = (["-rdc=true"], ["-lcudadevrt"])

_libs: Dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    return (not lib.exists()
            or lib.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime)


def build(names: Sequence[str], verbose: bool = False) -> Dict[str, dict]:
    """Compile every stale ``csrc/<name>.cu``, one ``nvcc`` each, all
    started together.  Returns ``{name: {"seconds", "log"}}`` for the
    sources compiled (``log`` holds ``-Xptxas -v`` output when
    ``verbose``).  Raises ``RuntimeError`` with the compiler's output if a
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        pre, post = DEVICE_LAUNCH_FLAGS if name in DEVICE_LAUNCH else ([], [])
        cmd = [nvcc(), *NVCC_FLAGS, *pre,
               *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu"), *post]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, library_path(name))
        out[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    with _lib_lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib
