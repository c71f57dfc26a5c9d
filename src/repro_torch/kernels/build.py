"""Build the port's CUDA sources into shared libraries and load them.

``nvcc -gencode arch=compute_90a,code=sm_90a -shared`` compiles the ``.cu``
files of the checkout into ``kernels/_build/`` (listed in ``.gitignore``),
named by a hash of the sources and flags so an edited source never loads a
stale library.  The library has a plain C interface and is loaded with
``ctypes``; nothing here includes PyTorch's headers, so a build takes
seconds.  Nothing is built at import: the first launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()                 # guards _LOCKS
_LOCKS: Dict[str, threading.Lock] = {}   # one per library: different libraries build in parallel
_LOADED: Dict[str, ctypes.CDLL] = {}
#: seconds each library took to compile in this process (0.0 when reused)
BUILD_SECONDS: Dict[str, float] = {}
#: nvcc's output (``-Xptxas -v``: registers, shared memory, spills)
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def load_library(name: str, sources: Sequence[Path]) -> ctypes.CDLL:
    """Compile ``sources`` into ``lib<name>-<hash>.so`` once, then load it.

    Concurrent builders (several processes on one checkout) each compile to
    a private temporary file and rename it into place atomically; threads of
    one process build different libraries at the same time."""
    with _LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LOADED.get(name)
        if lib is not None:
            return lib
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in sources:
            h.update(Path(src).read_bytes())
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        target = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
        BUILD_SECONDS[name] = 0.0
        if not target.exists():
            fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
            os.close(fd)
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)],
                capture_output=True, text=True)
            BUILD_SECONDS[name] = time.perf_counter() - t0
            BUILD_LOG[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed for {name}:\n{BUILD_LOG[name]}")
            os.replace(tmp, target)
        lib = _LOADED[name] = ctypes.CDLL(str(target))
        return lib
