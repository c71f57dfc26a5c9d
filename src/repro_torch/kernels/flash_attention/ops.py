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

The kernel has two paths, picked by ``choose_path`` before the launch from
the dtype, D and the operands' alignment: ``wgmma`` (bf16 with 16-byte
rows, both products on the tensor cores) and ``ffma`` (f32, and bf16 that
is not aligned so).  ``LAUNCHES`` counts kernel launches and
``PATH_LAUNCHES`` the same launches by path, so a run can show which path
its attention went through.  ``kv_tiles`` is the kernel's block-skip: the
KV tiles a query tile visits.  The kernel is a forward: on the card it
refuses inputs that need a gradient until its backward is written
(ROADMAP queue 2 B1); training runs ``attention_chunked``, as the
reference's does.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import vector_rows
from repro_torch.kernels.build import load_library
from repro_torch.kernels.flash_attention import ref

SOURCES = (Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",)

#: kernel launches so far; callers reset it to 0 to count a run
LAUNCHES = {"flash_attention": 0}
#: the same launches by path
PATH_LAUNCHES = {"ffma": 0, "wgmma": 0}
#: the kernel's paths: code of the C entry
PATHS = {"ffma": 0, "wgmma": 1}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 256
_MAX_GRID_YZ = 65535
_INT32_MAX = 2 ** 31 - 1

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_Strides = ctypes.c_longlong * 12


@functools.cache
def library() -> ctypes.CDLL:
    """Build (first call only) and load the kernel's library."""
    lib = load_library("flash_attention", SOURCES)
    lib.repro_flash_attention.argtypes = [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                          _Strides, _F, _I, _I, _P]
    lib.repro_flash_attention.restype = _I
    lib.repro_flash_attention_smem_bytes.argtypes = [_I, _I]
    lib.repro_flash_attention_smem_bytes.restype = _I
    lib.repro_flash_attention_tile.argtypes = [_I, _I, _I]
    lib.repro_flash_attention_tile.restype = _I
    for path, code in PATHS.items():
        for d in (32, 64, 128, 256):
            got = (lib.repro_flash_attention_tile(code, d, 0), lib.repro_flash_attention_tile(code, d, 1))
            if got != tiles(path, d):
                raise RuntimeError(f"flash path {path}, D={d}: the kernel's tile {got} differs "
                                   f"from {tiles(path, d)}")
    return lib


def tiles(path: str, d: int) -> Tuple[int, int]:
    """(query rows, keys) of a block's tile on ``path`` at head size ``d``."""
    if path == "wgmma":
        return 128, 128 if d <= 128 else 64
    return 64, 64


def kv_tiles(q_tile: int, sq: int, skv: int, causal: bool, window: Optional[int],
             tq: int, tk: int) -> Tuple[int, int]:
    """[begin, end) of the KV tiles that query tile ``q_tile`` visits: those
    that can hold a live key for its rows (the kernel's block-skip, after
    the reference's ``kernel.py:44-52``)."""
    q_offset = skv - sq
    q_lo = q_tile * tq + q_offset
    q_hi = min(q_tile * tq + tq, sq) - 1 + q_offset
    n_kt = -(-skv // tk)
    begin, end = 0, n_kt
    if causal:
        end = 0 if q_hi < 0 else min(n_kt, q_hi // tk + 1)
    if window is not None and q_lo - window + 1 > 0:
        begin = (q_lo - window + 1) // tk
    return begin, end


def choose_path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """``wgmma`` for bf16 with 16-byte rows (D and the batch, sequence and
    head strides multiples of 8, pointers 16-byte aligned) whose grid fits;
    ``ffma`` for the rest: f32, whose 2e-5 parity a TF32 pass would miss,
    and bf16 that is not aligned so."""
    if (q.dtype == torch.bfloat16 and q.shape[-1] % 8 == 0 and vector_rows(q, k, v)
            and q.shape[0] * q.shape[2] * -(-q.shape[1] // tiles("wgmma", q.shape[-1])[0])
            <= _INT32_MAX):
        return "wgmma"
    return "ffma"


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
                                  "(ROADMAP queue 2 B1)")


def flash_attention(
    q: torch.Tensor,   # (B, Sq, Hq, D)
    k: torch.Tensor,   # (B, Skv, Hk, D)
    v: torch.Tensor,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    path: Optional[str] = None,
) -> torch.Tensor:
    """(B, Sq, Hq, D) attention output in ``q.dtype``.  ``path`` forces one
    of ``PATHS`` on the card (every path computes the same function; tests
    hold each); it raises where that path does not take the operands."""
    del q_positions, kv_positions  # contiguous positions assumed, as the reference does
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    _check(q, k, v, window)
    chosen = choose_path(q, k, v)
    if path is None:
        path = chosen
    elif path not in PATHS:
        raise ValueError(f"flash_attention: unknown path {path!r}, not one of {sorted(PATHS)}")
    elif path == "wgmma" and chosen != "wgmma":
        raise ValueError("flash_attention: the wgmma path takes bfloat16 with 16-byte rows "
                         "(D and the batch, sequence and head strides multiples of 8)")
    (b, sq, hq, d), (skv, hk) = q.shape, k.shape[1:3]
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    strides = _Strides(*(s for t in (q, k, v, o) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        err = library().repro_flash_attention(
            PATHS[path], _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, sq, skv, hq, hk, d, strides, 1.0 / math.sqrt(d), int(causal),
            0 if window is None else int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    PATH_LAUNCHES[path] += 1
    return o
