"""Grouped matmul with its gradient: the Hopper kernels and their dispatch.

``grouped_matmul(x, w, group_sizes)`` computes ``y[m] = x[m] @ w[g(m)]``
for rows pre-sorted by group, as ``repro.kernels.grouped_matmul.ops`` does
with ``impl="pallas"``.  The tensor's device picks the implementation:

* a CUDA tensor launches the kernels of ``csrc/grouped_matmul.cu`` — the
  forward and ``dx = gmm(dy, wᵀ)`` on ``gmm``, ``dw`` on ``tgmm`` — or
  raises; nothing falls back to the plain version;
* a CPU tensor takes the plain versions in ``ref.py``.

``LAUNCHES`` counts kernel launches per kernel, so a run can show that its
path went through the kernels.  The wrappers never read group sizes on the
host: ``offsets = [0, cumsum(group_sizes)]`` is computed on the card and
the kernels read it there.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.grouped_matmul import ref

SOURCES = (Path(__file__).resolve().parent / "csrc" / "grouped_matmul.cu",)

#: kernel launches so far, by kernel; callers reset entries to 0 to count a run
LAUNCHES = {"gmm": 0, "tgmm": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 64          # output tile edge of both kernels (grid sizing limits)
_MAX_GRID_YZ = 65535
_INT32_MAX = 2 ** 31 - 1

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def library() -> ctypes.CDLL:
    """Build (first call only) and load the kernels' library."""
    lib = load_library("grouped_matmul", SOURCES)
    lib.repro_gmm.argtypes = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _LL, _P]
    lib.repro_gmm.restype = _I
    lib.repro_tgmm.argtypes = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    lib.repro_tgmm.restype = _I
    return lib


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {dev}")


def _check_operand(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {t.dtype} not supported (float32, bfloat16)")
    if t.dtype != dtype:
        raise TypeError(f"{name}: mixed dtypes {t.dtype} and {dtype}")
    if any(s > _INT32_MAX for s in t.shape):
        raise ValueError(f"{name}: dimension too large for the kernel: {tuple(t.shape)}")


def _offsets(group_sizes: torch.Tensor, num_groups: int) -> torch.Tensor:
    if group_sizes.dim() != 1 or group_sizes.shape[0] != num_groups:
        raise ValueError(f"group_sizes must be ({num_groups},), got {tuple(group_sizes.shape)}")
    if group_sizes.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"group_sizes must be int32 or int64, got {group_sizes.dtype}")
    zero = torch.zeros(1, dtype=torch.int32, device=group_sizes.device)
    return torch.cat([zero, torch.cumsum(group_sizes, 0, dtype=torch.int32)])


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def gmm(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """(M, K) rows sorted by group x (G, K, N) -> (M, N) in x.dtype.

    ``w`` may be any strided view (the backward passes ``wᵀ`` in place)."""
    if x.device.type == "cpu":
        return ref.grouped_matmul_ref(x, w, group_sizes)
    _check_cuda("gmm", x, w, group_sizes)
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"gmm: shapes {tuple(x.shape)} x {tuple(w.shape)}")
    _check_operand("gmm x", x, x.dtype)
    _check_operand("gmm w", w, x.dtype)
    if not x.is_contiguous():
        raise ValueError("gmm: x must be contiguous")
    (m, k), (g, _, n) = x.shape, w.shape
    if -(-m // _TILE) > _MAX_GRID_YZ:
        raise ValueError(f"gmm: {m} rows exceed the kernel's grid")
    offs = _offsets(group_sizes, g)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    with torch.cuda.device(x.device):
        err = library().repro_gmm(
            _DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), offs.data_ptr(),
            y.data_ptr(), m, k, n, g, *w.stride(),
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "gmm")
    LAUNCHES["gmm"] += 1
    return y


def tgmm(x: torch.Tensor, dy: torch.Tensor, group_sizes: torch.Tensor,
         num_groups: int) -> torch.Tensor:
    """(M, K) x (M, N), rows sorted by group -> dw (G, K, N) in x.dtype."""
    if x.device.type == "cpu":
        return ref.tgmm_ref(x, dy, group_sizes, num_groups)
    _check_cuda("tgmm", x, dy, group_sizes)
    if x.dim() != 2 or dy.dim() != 2 or dy.shape[0] != x.shape[0]:
        raise ValueError(f"tgmm: shapes {tuple(x.shape)} and {tuple(dy.shape)}")
    _check_operand("tgmm x", x, x.dtype)
    _check_operand("tgmm dy", dy, x.dtype)
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("tgmm: x and dy must be contiguous")
    (m, k), n = x.shape, dy.shape[1]
    if num_groups > _MAX_GRID_YZ or -(-k // _TILE) > _MAX_GRID_YZ:
        raise ValueError(f"tgmm: {num_groups} groups x {k} rows exceed the kernel's grid")
    offs = _offsets(group_sizes, num_groups)
    dw = torch.empty((num_groups, k, n), dtype=x.dtype, device=x.device)
    if dw.numel() == 0:
        return dw
    with torch.cuda.device(x.device):
        err = library().repro_tgmm(
            _DTYPES[x.dtype], x.data_ptr(), dy.data_ptr(), offs.data_ptr(),
            dw.data_ptr(), m, k, n, num_groups,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "tgmm")
    LAUNCHES["tgmm"] += 1
    return dw


class GroupedMatmul(torch.autograd.Function):
    """``gmm`` with its gradient: ``dx = gmm(dy, wᵀ)``, ``dw = tgmm(x, dy)``
    (the reference's custom VJP, ``repro/kernels/grouped_matmul/ops.py:45``)."""

    @staticmethod
    def forward(ctx, x, w, group_sizes):
        ctx.save_for_backward(x, w, group_sizes)
        return gmm(x, w, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        x, w, gs = ctx.saved_tensors
        dy = dy.contiguous()
        dx = gmm(dy, w.transpose(1, 2), gs) if ctx.needs_input_grad[0] else None
        dw = tgmm(x, dy, gs, w.shape[0]) if ctx.needs_input_grad[1] else None
        return dx, dw, None


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """y[m] = x[m] @ w[g(m)] with rows pre-sorted by group; differentiable.
    Mixed input dtypes are promoted first, as jnp.dot promotes them."""
    dtype = torch.promote_types(x.dtype, w.dtype)
    return GroupedMatmul.apply(x.to(dtype), w.to(dtype), group_sizes)
