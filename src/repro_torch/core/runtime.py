"""Framework-provided runtime — FedHC's workload-heterogeneity mechanism.

The paper's position: client time must come from *executing the actual
workload under the framework*, never from a closed-form guess.

* ``MeasuredRuntime`` — warm up, then wall-clock the client's real train
  step on the trainer's device (the paper's mode: wall clock on the
  simulation GPU).  Returns seconds at 100% capacity; the simulator
  divides by the granted rate, reproducing "fewer SMs ⇒ proportionally
  slower".
* ``FixedRuntime`` — a stable hash of the workload signature, for
  timelines that must reproduce bit for bit across processes and hosts.

Both are memoized by workload signature.  The analytical (roofline)
backend of the reference is still to port, with H100 constants.
"""
from __future__ import annotations

import time
import zlib
from typing import Callable, Dict, Hashable, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device


class MeasuredRuntime:
    """Wall-clock execution of the real workload on ``device``.

    CUDA launches return before the card finishes, so every timed call
    ends in ``torch.cuda.synchronize()``; the first call (kernel build,
    allocator warm-up) is not timed."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._cache: Dict[Hashable, float] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def seconds_at_full(
        self,
        key: Hashable,
        fn: Callable,
        args: Tuple,
        *,
        n_steps: int = 1,
        repeats: int = 2,
    ) -> float:
        if key in self._cache:
            return self._cache[key] * n_steps
        fn(*args)  # warm
        self._sync()
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn(*args)
            self._sync()
            best = min(best, time.perf_counter() - t0)
        self._cache[key] = best
        return best * n_steps


class FixedRuntime:
    """Deterministic runtime backend: seconds-at-full is a pure function of
    the workload signature (a stable hash of ``repr(key)``), never of wall
    clock.  ``spread`` keeps heterogeneity: different workloads still get
    different runtimes.  Keys must be built from plain Python values (ints,
    tuples): a ``torch.Size`` has another ``repr`` than the reference's
    shape tuple and would give another timeline."""

    def __init__(self, base: float = 1.0, spread: float = 1.0):
        self.base = float(base)
        self.spread = float(spread)

    def seconds_at_full(
        self, key: Hashable, fn: Callable, args: Tuple, *, n_steps: int = 1
    ) -> float:
        h = zlib.crc32(repr(key).encode()) / 0xFFFFFFFF
        return n_steps * self.base * (1.0 + self.spread * h)
