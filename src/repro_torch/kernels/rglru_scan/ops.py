"""RG-LRU scan: the Hopper kernel and its dispatch.

``rglru_scan(log_a, b, impl=)`` computes ``h_t = exp(log_a_t)·h_{t−1} +
b_t`` over axis 1 of (B, L, W) inputs from h = 0 and returns (y in b's
dtype, h_final (B, W) in f32), as ``repro.kernels.rglru_scan.ops.rglru_scan``
does.  ``impl`` is the reference's:

* ``"sequential"`` and ``"associative"`` are the plain versions in
  ``ref.py``, on any device;
* ``"pallas"`` is the kernel's route, and the tensors' device picks the
  implementation: CPU tensors take ``ref.rglru_associative``; anything
  else goes to ``csrc/rglru_scan.cu``, which launches or raises (nothing
  falls back to the plain version).

The kernel takes any L (the reference's Pallas kernel needs L to be a
multiple of its chunk; its oracle does not).  ``LAUNCHES`` counts kernel
launches.  The kernel is a forward: on the card it refuses inputs that need
a gradient until its backward is written (ROADMAP queue 2 B3); training runs
``rglru_associative``, as the reference's does.  ``rglru_decode_step`` is the one-token update of decode, plain
torch as in the reference.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.rglru_scan import ref

SOURCES = (Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu",)

#: kernel launches so far; callers reset it to 0 to count a run
LAUNCHES = {"rglru_scan": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535
_INT32_MAX = 2 ** 31 - 1

_P, _I = ctypes.c_void_p, ctypes.c_int
_Strides = ctypes.c_longlong * 6


@functools.cache
def library() -> ctypes.CDLL:
    """Build (first call only) and load the kernel's library."""
    lib = load_library("rglru_scan", SOURCES)
    lib.repro_rglru_scan.argtypes = [_I, _P, _P, _P, _P, _I, _I, _I, _Strides, _P]
    lib.repro_rglru_scan.restype = _I
    return lib


def _check(log_a: torch.Tensor, b: torch.Tensor) -> None:
    if log_a.device != b.device:
        raise ValueError(f"rglru_scan: tensors on {log_a.device} and {b.device}")
    if b.device.type != "cuda":
        raise ValueError(f"rglru_scan: the kernel takes CUDA tensors, got {b.device}")
    if b.dtype not in _DTYPES or log_a.dtype not in _DTYPES:
        raise TypeError(f"rglru_scan: dtypes {log_a.dtype}, {b.dtype} not supported "
                        "(float32, bfloat16)")
    if b.dim() != 3 or log_a.shape != b.shape:
        raise ValueError(f"rglru_scan: shapes {tuple(log_a.shape)}, {tuple(b.shape)}; "
                         "want two equal (B, L, W)")
    if log_a.stride(-1) != 1 or b.stride(-1) != 1:
        raise ValueError("rglru_scan: the last dimension must be unit-stride")
    bs, l, w = b.shape
    if l > _INT32_MAX or w > _INT32_MAX or bs > _MAX_GRID_YZ:
        raise ValueError(f"rglru_scan: shapes exceed the kernel's grid: {tuple(b.shape)}")
    if (log_a.requires_grad or b.requires_grad) and torch.is_grad_enabled():
        raise NotImplementedError("rglru_scan: the kernel's backward is not ported yet "
                                  "(ROADMAP queue 2 B3)")


def rglru_kernel(log_a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel: (y (B, L, W) in b's dtype, h_final (B, W) f32)."""
    _check(log_a, b)
    log_a = log_a.float()   # the kernel reads the decay in f32, as the reference does
    bs, l, w = b.shape
    y = torch.empty((bs, l, w), dtype=b.dtype, device=b.device)
    h_final = torch.empty((bs, w), dtype=torch.float32, device=b.device)
    if y.numel() == 0:
        return y, h_final.zero_()
    strides = _Strides(*(s for t in (log_a, b, y) for s in t.stride()[:2]))
    with torch.cuda.device(b.device):
        err = library().repro_rglru_scan(
            _DTYPES[b.dtype], log_a.data_ptr(), b.data_ptr(), y.data_ptr(), h_final.data_ptr(),
            bs, l, w, strides, torch.cuda.current_stream(b.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error {err}")
    LAUNCHES["rglru_scan"] += 1
    return y, h_final


def rglru_scan(
    log_a: torch.Tensor,
    b: torch.Tensor,
    impl: str = "associative",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = exp(log_a_t)·h_{t-1} + b_t over axis 1.  -> (y, h_final)."""
    if impl == "sequential":
        return ref.rglru_sequential(log_a, b)
    if impl == "associative":
        return ref.rglru_associative(log_a, b)
    if impl == "pallas":
        if log_a.device.type == b.device.type == "cpu":
            return ref.rglru_associative(log_a, b)
        return rglru_kernel(log_a, b)
    raise ValueError(f"unknown rglru impl: {impl}")


def rglru_decode_step(
    h: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-step update.  h, log_a, b: (B, W).  Returns (y, new_h)."""
    h_new = torch.exp(log_a.float()) * h.float() + b.float()
    return h_new.to(b.dtype), h_new
