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
* ``AnalyticalRuntime`` — no execution: count the step's FLOPs and bytes
  (``compiled_cost``) and derive seconds at full capacity from the H100's
  roofline, each product at the rate of its dtype.  Still
  framework-provided: the counts come from the real step's operator
  stream, nothing is guessed from config knobs.

All three are memoized by workload signature.
"""
from __future__ import annotations

import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Hashable, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.device import DeviceLike, resolve_device

# H100 SXM roofline (per card, dense), the figures PERF.md's kernel bounds
# use: bf16/fp16 products on the tensor cores, every other product at the
# f32 rate of the FFMA pipes (f32 matmuls run with TF32 off, PyTorch's
# default), and HBM3 bytes/s
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_F32 = 67e12
HBM_BW = 3.35e12
_HALF = (torch.bfloat16, torch.float16)


@dataclass(frozen=True)
class StepCost:
    flops: float
    bytes_accessed: float
    #: the part of ``flops`` done in bf16/fp16, at the tensor cores' rate
    half_flops: float = 0.0

    def seconds_at_full(self) -> float:
        compute = (self.half_flops / PEAK_FLOPS_BF16
                   + (self.flops - self.half_flops) / PEAK_FLOPS_F32)
        return max(compute, self.bytes_accessed / HBM_BW)


def _meta(tree: Any) -> Any:
    """``tree`` with every tensor and numpy array replaced by a meta tensor
    of its shape and dtype (float64 arrays become float32, as ``host_to``
    converts them), so a step runs without executing anything."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device="meta")
        if isinstance(x, np.ndarray):
            dtype = np.float32 if x.dtype == np.float64 else x.dtype
            return torch.from_numpy(np.empty(0, dtype)).new_empty(x.shape, device="meta")
        return x
    return tree_map(leaf, tree)


def _nbytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


class _CostCounter(TorchDispatchMode):
    """Entered inside ``flops``: adds up the bytes each aten op reads and
    writes (every tensor input once, every output once; views move no data
    and are not counted), and the FLOPs ``flops`` counts for ops whose
    first floating-point input is bf16/fp16.  A device move (``_to_copy``
    to a device) stays on the meta device and is not counted: it is the
    batch's upload, not the step's work."""

    def __init__(self, flops: FlopCounterMode):
        super().__init__()
        self.flops = flops
        self.bytes = 0
        self.half_flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten._to_copy.default and kwargs.get("device") is not None:
            return func(*args, **dict(kwargs, device=torch.device("meta")))
        before = self.flops.get_total_flops()
        out = func(*args, **kwargs)
        if not func.is_view:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        floats = [t.dtype for t in tree_flatten((args, kwargs))[0]
                  if isinstance(t, torch.Tensor) and t.is_floating_point()]
        if floats and floats[0] in _HALF:
            self.half_flops += self.flops.get_total_flops() - before
        return out


def compiled_cost(fn: Callable, *args, **kw) -> StepCost:
    """FLOPs and bytes of one call of ``fn``, counted on meta tensors of
    the arguments' shapes and dtypes: nothing executes, and the count is
    the same whatever device the arguments lie on.

    The reference reads both from XLA's cost analysis of the compiled
    step.  Here eager PyTorch compiles nothing, so:

    * FLOPs are ``torch.utils.flop_counter.FlopCounterMode``'s.  It counts
      matrix products and convolutions only, where XLA also counts the
      elementwise work, so the MLP's and the LSTM's counts are lower; it
      counts every tap of a padded convolution, where XLA counts the taps
      inside the image, so the CNNs' are higher; and it counts every step
      of a recurrence, where XLA counts a ``lax.scan`` body once.  The
      gaps are measured and held in ``tests/test_torch_runtime.py``.  A
      custom operator (the ``gmm`` kernels) is invisible to it; the
      per-client step the trainer probes runs on library products only.
    * Bytes are the input and output bytes of every aten op eager PyTorch
      dispatches: the unfused work it really does, where XLA counts after
      fusion.
    * The FLOPs of bf16/fp16 ops are kept apart (``half_flops``), so that
      ``StepCost.seconds_at_full`` times them at the tensor cores' rate
      and the rest, the f32 client steps, at the FFMA rate.  The
      reference times every FLOP at the TPU's bf16 rate, since the TPU
      runs f32 products as bf16 passes; the H100 does not.
    """
    margs = _meta((args, kw))
    flops = FlopCounterMode(display=False)
    with flops, _CostCounter(flops) as count:
        fn(*margs[0], **margs[1])
    return StepCost(flops=float(flops.get_total_flops()), bytes_accessed=float(count.bytes),
                    half_flops=float(count.half_flops))


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


class AnalyticalRuntime:
    """Roofline-derived time from the step's counted cost (no execution)."""

    def __init__(self):
        self._cache: Dict[Hashable, StepCost] = {}

    def seconds_at_full(
        self, key: Hashable, fn: Callable, args: Tuple, *, n_steps: int = 1
    ) -> float:
        if key not in self._cache:
            self._cache[key] = compiled_cost(fn, *args)
        return n_steps * self._cache[key].seconds_at_full()
