"""Build the port's CUDA sources into shared libraries and load them.

``nvcc -gencode arch=compute_90a,code=sm_90a -c`` compiles each ``.cu`` file
of a library into an object, one ``nvcc`` a source, all started together,
and ``nvcc -shared`` links them into ``kernels/_build/`` (listed in
``.gitignore``), named by a hash of the sources, the ``.cuh`` headers beside
them and in ``kernels/csrc/`` (``wgmma.cuh``, which every ``wgmma`` kernel
includes) and the flags, so an edited source or header never loads a stale
library.  The library has a plain C interface and is loaded with
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

BUILD_DIR = Path(__file__).resolve().parent / "_build"
#: headers shared across the kernel packages
SHARED_CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def source_hash(sources: Sequence[Path]) -> str:
    """What names a library's build: the flags, the sources, and every
    ``.cuh`` beside them or in ``SHARED_CSRC``, names and bytes."""
    sources = [Path(src) for src in sources]
    headers = sorted({h for d in {src.parent for src in sources} | {SHARED_CSRC}
                      for h in d.glob("*.cuh")})
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sources, *headers):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def load_library(name: str, sources: Sequence[Path]) -> ctypes.CDLL:
    """Compile ``sources`` into ``lib<name>-<hash>.so`` once, then load it.

    Concurrent builders (several processes on one checkout) each compile in
    a private temporary directory and rename the library into place
    atomically; threads of one process build different libraries, and the
    sources of one library, at the same time."""
    with _LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LOADED.get(name)
        if lib is not None:
            return lib
        sources = [Path(src) for src in sources]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        target = BUILD_DIR / f"lib{name}-{source_hash(sources)}.so"
        BUILD_SECONDS[name] = 0.0
        if not target.exists():
            work = Path(tempfile.mkdtemp(dir=BUILD_DIR, suffix=".tmp"))
            objs = [work / f"{i}-{src.stem}.o" for i, src in enumerate(sources)]
            t0 = time.perf_counter()
            try:
                with ThreadPoolExecutor(len(sources)) as pool:
                    procs = list(pool.map(lambda so: subprocess.run(
                        [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(so[1]), str(so[0])],
                        capture_output=True, text=True), zip(sources, objs)))
                if all(p.returncode == 0 for p in procs):
                    procs.append(subprocess.run(
                        [_nvcc(), "-shared", "-o", str(work / "lib.so"), *map(str, objs)],
                        capture_output=True, text=True))
                BUILD_SECONDS[name] = time.perf_counter() - t0
                BUILD_LOG[name] = "".join(p.stdout + p.stderr for p in procs)
                if any(p.returncode != 0 for p in procs):
                    raise RuntimeError(f"nvcc failed for {name}:\n{BUILD_LOG[name]}")
                os.replace(work / "lib.so", target)
            finally:
                shutil.rmtree(work, ignore_errors=True)
        lib = _LOADED[name] = ctypes.CDLL(str(target))
        return lib
