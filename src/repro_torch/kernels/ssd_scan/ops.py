"""Mamba-2 SSD scan: the Hopper kernel and its dispatch.

``ssd(x, dt, a, b_mat, c_mat, chunk=, impl=, path=)`` takes the model's
layout, x (B, L, H, P), dt (B, L, H), a (H,), B/C (B, L, G, N), as
``repro.kernels.ssd_scan.ops.ssd`` does, and returns (y (B, L, H, P) in
x's dtype, final state (B, H, P, N) in f32).  ``impl`` is the reference's:

* ``"sequential"`` and ``"chunked"`` are the plain versions in ``ref.py``,
  on any device;
* ``"pallas"`` is the kernel's route, and the tensors' device picks the
  implementation: CPU tensors take ``ref.ssd_chunked`` at ``chunk``;
  anything else goes to ``csrc/ssd_scan.cu``, which launches or raises
  (nothing falls back to the plain version).

The kernel has two paths, picked by ``choose_path`` before the launch from
the dtype, P, N and the operands' alignment: ``wgmma`` (bf16 with 16-byte
rows and N above 32, every product on the tensor cores) and ``ffma`` (f32,
and the rest of bf16).  ``path=`` forces one; a forced path raises where
it does not take the operands.

The kernel reads the model's layout in place through strides (the
reference's wrapper transposes to (B, H, L, P)) and masks a ragged tail
itself, as the reference pads it: with dt = 0, so the final state is
exact.  It runs its own internal chunk: the chunk length does not change
the function, only the order of its sums, so ``chunk`` sizes the plain
version alone.

``LAUNCHES`` counts kernel launches and ``PATH_LAUNCHES`` the same launches
by path, so a run can show which path its scan went through.  The kernel is
a forward: on the card it refuses inputs that need a gradient until its
backward is written (ROADMAP queue 2 B2); training runs ``ssd_chunked``, as
the reference's does.  ``ssd_decode_step`` is the one-token update of
decode, plain torch as in the reference.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import vector_rows
from repro_torch.kernels.build import load_library
from repro_torch.kernels.ssd_scan import ref

SOURCES = (Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu",)

#: kernel launches so far; callers reset it to 0 to count a run
LAUNCHES = {"ssd_scan": 0}
#: the same launches by path
PATH_LAUNCHES = {"ffma": 0, "wgmma": 0}
#: the kernel's paths: code of the C entry
PATHS = {"ffma": 0, "wgmma": 1}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_P, _MAX_N = 64, 128     # the kernel's largest head and state sizes
_MAX_GRID_YZ = 65535
_INT32_MAX = 2 ** 31 - 1

_P, _I = ctypes.c_void_p, ctypes.c_int
_Strides = ctypes.c_longlong * 15


@functools.cache
def library() -> ctypes.CDLL:
    """Build (first call only) and load the kernel's library."""
    lib = load_library("ssd_scan", SOURCES)
    lib.repro_ssd_scan.argtypes = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _Strides, _P]
    lib.repro_ssd_scan.restype = _I
    lib.repro_ssd_scan_smem_bytes.argtypes = [_I, _I, _I]
    lib.repro_ssd_scan_smem_bytes.restype = _I
    lib.repro_ssd_scan_wgmma_tile.argtypes = [_I]
    lib.repro_ssd_scan_wgmma_tile.restype = _I
    return lib


def choose_path(x: torch.Tensor, b_mat: torch.Tensor, c_mat: torch.Tensor) -> str:
    """``wgmma`` for bf16 with 16-byte rows (P and N multiples of 8, the
    batch, length and head or group strides of x, B and C multiples of 8,
    pointers 16-byte aligned) and N above 32; ``ffma`` for the rest: f32,
    whose 2e-5 parity a bf16 or TF32 operand would miss, bf16 that is not
    aligned so, and bf16 with N <= 32, where y is held elementwise at 2e-2
    and the ``wgmma`` path's bf16 operands miss that where a read-out over
    few state columns cancels."""
    n = b_mat.shape[-1]
    if (x.dtype == torch.bfloat16 and x.shape[-1] % 8 == 0 and n % 8 == 0 and n > 32
            and vector_rows(x, b_mat, c_mat)):
        return "wgmma"
    return "ffma"


def _check(x, dt, a, b_mat, c_mat) -> None:
    dev = x.device
    for t in (dt, a, b_mat, c_mat):
        if t.device != dev:
            raise ValueError(f"ssd_scan: tensors on {dev} and {t.device}")
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan: the kernel takes CUDA tensors, got {dev}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"ssd_scan: dtype {x.dtype} not supported (float32, bfloat16)")
    if b_mat.dtype != x.dtype or c_mat.dtype != x.dtype:
        raise TypeError(f"ssd_scan: x, B and C must share a dtype: {x.dtype}, "
                        f"{b_mat.dtype}, {c_mat.dtype}")
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or b_mat.dim() != 4 \
            or b_mat.shape != c_mat.shape:
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"a {tuple(a.shape)}, B {tuple(b_mat.shape)}, C {tuple(c_mat.shape)}")
    (bsz, l, h, p), (g, n) = x.shape, b_mat.shape[2:]
    if tuple(dt.shape) != (bsz, l, h) or tuple(a.shape) != (h,) \
            or tuple(b_mat.shape[:2]) != (bsz, l) or g == 0 or h % g:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)}, a "
                         f"{tuple(a.shape)}, B/C {tuple(b_mat.shape)}: batch, length and "
                         "heads must agree and G divide H")
    if p > _MAX_P or n > _MAX_N:
        raise ValueError(f"ssd_scan: head size {p} or state size {n} above the kernel's "
                         f"{_MAX_P} and {_MAX_N}")
    if any(t.stride(-1) != 1 for t in (x, b_mat, c_mat)):
        raise ValueError("ssd_scan: the last dimension of x, B and C must be unit-stride")
    if l > _INT32_MAX or bsz > _MAX_GRID_YZ:
        raise ValueError(f"ssd_scan: shapes exceed the kernel's grid: {tuple(x.shape)}")
    if any(t.requires_grad for t in (x, dt, a, b_mat, c_mat)) and torch.is_grad_enabled():
        raise NotImplementedError("ssd_scan: the kernel's backward is not ported yet "
                                  "(ROADMAP queue 2 B2)")


def ssd_kernel(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
               c_mat: torch.Tensor, path: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel: (y (B, L, H, P) in x's dtype, final state (B, H, P, N) f32).
    ``path`` forces one of ``PATHS`` (every path computes the same function;
    tests hold each); it raises where that path does not take the operands."""
    _check(x, dt, a, b_mat, c_mat)
    chosen = choose_path(x, b_mat, c_mat)
    if path is None:
        path = chosen
    elif path not in PATHS:
        raise ValueError(f"ssd_scan: unknown path {path!r}, not one of {sorted(PATHS)}")
    elif path == "wgmma" and chosen != "wgmma":
        raise ValueError("ssd_scan: the wgmma path takes bfloat16 with 16-byte rows (P, N and "
                         "the batch, length and head or group strides multiples of 8) and N "
                         "above 32")
    dt, a = dt.float(), a.float().contiguous()   # the kernel reads both in f32, as the reference does
    (bsz, l, h, p), (g, n) = x.shape, b_mat.shape[2:]
    y = torch.empty((bsz, l, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    if state.numel() == 0:
        return y, state
    strides = _Strides(*(s for t in (x, dt, b_mat, c_mat, y) for s in t.stride()[:3]))
    with torch.cuda.device(x.device):
        err = library().repro_ssd_scan(
            PATHS[path], _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), a.data_ptr(),
            b_mat.data_ptr(), c_mat.data_ptr(), y.data_ptr(), state.data_ptr(), bsz, l, h, p, g,
            n, strides, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    LAUNCHES["ssd_scan"] += 1
    PATH_LAUNCHES[path] += 1
    return y, state


def ssd(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b_mat: torch.Tensor,
    c_mat: torch.Tensor,
    *,
    chunk: int = 128,
    impl: str = "chunked",
    path: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan.  x (B,L,H,P), dt (B,L,H), a (H,), B/C (B,L,G,N).

    Returns (y (B,L,H,P), final_state (B,H,P,N)).  ``path`` forces one of
    the kernel's ``PATHS`` on the card (``impl="pallas"``)."""
    if impl == "sequential":
        return ref.ssd_sequential(x, dt, a, b_mat, c_mat)
    if impl == "chunked":
        return ref.ssd_chunked(x, dt, a, b_mat, c_mat, chunk=chunk)
    if impl == "pallas":
        if all(t.device.type == "cpu" for t in (x, dt, a, b_mat, c_mat)):
            return ref.ssd_chunked(x, dt, a, b_mat, c_mat, chunk=chunk)
        return ssd_kernel(x, dt, a, b_mat, c_mat, path)
    raise ValueError(f"unknown ssd impl: {impl}")


def ssd_decode_step(
    state: torch.Tensor,  # (B, H, P, N)
    x: torch.Tensor,      # (B, H, P)
    dt: torch.Tensor,     # (B, H)
    a: torch.Tensor,      # (H,)
    b_vec: torch.Tensor,  # (B, G, N)
    c_vec: torch.Tensor,  # (B, G, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSD update (decode).  Returns (y (B,H,P), new_state)."""
    rep = x.shape[1] // b_vec.shape[1]
    bh = b_vec.repeat_interleave(rep, dim=1).float()
    ch = c_vec.repeat_interleave(rep, dim=1).float()
    decay = torch.exp(a[None, :] * dt.float())                 # (B,H)
    xdt = x.float() * dt.float()[..., None]
    state = state * decay[..., None, None] + xdt[..., :, None] * bh[..., None, :]
    y = torch.einsum("bhpn,bhn->bhp", state, ch)
    return y.to(x.dtype), state
