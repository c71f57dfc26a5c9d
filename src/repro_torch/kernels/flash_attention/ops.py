"""Flash-attention forward: the Hopper kernel and its dispatch.

``flash_attention(q, k, v, ...)`` takes the model's ``(B, S, H, D)`` layout,
as ``repro.kernels.flash_attention.ops.flash_attention`` does, with the
same conventions: contiguous positions (queries are the last ``Sq`` of the
``Skv`` positions), causal and sliding-window masks, GQA through
``h // (Hq / Hk)``, scale ``1/√D``, output in ``q.dtype``.  The position
arguments are accepted and ignored, as the reference ignores them.  The
tensor's device picks the implementation:

* a CUDA tensor launches ``csrc/flash_attention.cu`` or raises; nothing
  falls back to the plain version;
* a CPU tensor takes the plain version in ``ref.py``.

``LAUNCHES`` counts kernel launches, so a run can show that its path went
through the kernel.  The kernel is a forward: on the card it refuses
inputs that need a gradient (training is a later slice of the port).
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.flash_attention import ref

SOURCES = (Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",)

#: kernel launches so far; callers reset it to 0 to count a run
LAUNCHES = {"flash_attention": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TQ = 64            # query rows per block (grid sizing)
_MAX_D = 256
_MAX_GRID_YZ = 65535
_INT32_MAX = 2 ** 31 - 1

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_Strides = ctypes.c_longlong * 12


@functools.cache
def library() -> ctypes.CDLL:
    """Build (first call only) and load the kernel's library."""
    lib = load_library("flash_attention", SOURCES)
    lib.repro_flash_attention.argtypes = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                          _Strides, _F, _I, _I, _P]
    lib.repro_flash_attention.restype = _I
    lib.repro_flash_attention_smem_bytes.argtypes = [_I]
    lib.repro_flash_attention_smem_bytes.restype = _I
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
    dev = q.device
    for t in (k, v):
        if t.device != dev:
            raise ValueError(f"flash_attention: tensors on {dev} and {t.device}")
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: the kernel takes CUDA tensors, got {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported (float32, bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: mixed dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}; want (B, S, H, D)")
    (b, sq, hq, d), (bk, skv, hk, dk) = q.shape, k.shape
    if bk != b or dk != d or hk == 0 or hq % hk:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v {tuple(k.shape)}: "
                         "batch and head size must agree and Hk divide Hq")
    if d > _MAX_D:
        raise ValueError(f"flash_attention: head size {d} above the kernel's {_MAX_D}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} must be at least 1")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dimension must be unit-stride")
    if max(sq, skv) > _INT32_MAX or hq > _MAX_GRID_YZ or b > _MAX_GRID_YZ:
        raise ValueError(f"flash_attention: shapes exceed the kernel's grid: {tuple(q.shape)}")
    if any(t.requires_grad for t in (q, k, v)) and torch.is_grad_enabled():
        raise NotImplementedError("flash_attention: the kernel's backward is not ported yet "
                                  "(ROADMAP: kernel queue #2, LM training)")


def flash_attention(
    q: torch.Tensor,   # (B, Sq, Hq, D)
    k: torch.Tensor,   # (B, Skv, Hk, D)
    v: torch.Tensor,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """(B, Sq, Hq, D) attention output in ``q.dtype``."""
    del q_positions, kv_positions  # contiguous positions assumed, as the reference does
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    _check(q, k, v, window)
    (b, sq, hq, d), (skv, hk) = q.shape, k.shape[1:3]
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    strides = _Strides(*(s for t in (q, k, v, o) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        err = library().repro_flash_attention(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, sq, skv, hq, hk, d, strides, 1.0 / math.sqrt(d), int(causal),
            0 if window is None else int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    return o
