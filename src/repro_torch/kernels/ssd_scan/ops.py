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

Under grad (grad mode on and an input that requires it) a CUDA call goes
through ``SSDScan``, whose forward is one launch of the kernel and whose
backward is ``ssd_bwd``: three launches (the state entering each chunk, the
chunks walked last first, then dB, dC and da summed over heads and batch);
on the CPU the route stays ``ssd_chunked`` with torch's autograd.  A config
with ``ssm_impl="pallas"`` trains through the kernels; the reference's own
default, ``"chunked"``, stays the default here too.

The backward has two paths, picked by ``choose_bwd_path``: ``bwd_wgmma``
(``csrc/ssd_scan_bwd_wgmma.cu``: bf16 with 16-byte rows in x, B, C and dY
and N above 32, every product on the tensor cores, 64-row chunks) and
``bwd_ffma`` (``csrc/ssd_scan_bwd.cu``: f32, whose 1e-4 gradients bf16
operands would miss, and the rest of bf16, 32-row chunks).
``ssd_bwd(..., path=)`` forces one; a forced path raises where it does not
take the operands.

``LAUNCHES["ssd_scan"]`` counts forward launches and ``PATH_LAUNCHES`` the
same launches by path, so a run can show which path its scan went through;
``LAUNCHES["ssd_scan_bwd"]`` and ``PATH_LAUNCHES["bwd_ffma"]``,
``PATH_LAUNCHES["bwd_wgmma"]`` count backward calls, ``BWD_LAUNCHES`` each
of the three kernels a call launches, whichever its path.
``ssd_decode_step`` is the one-token update of decode, plain torch as in the
reference.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import vector_rows
from repro_torch.kernels.build import load_library
from repro_torch.dist.sharding import refuse_dtensor
from repro_torch.kernels.ssd_scan import ref

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "ssd_scan.cu", _CSRC / "ssd_scan_bwd.cu", _CSRC / "ssd_scan_bwd_wgmma.cu")

#: forward launches and backward calls so far; callers reset them to 0 to count a run
LAUNCHES = {"ssd_scan": 0, "ssd_scan_bwd": 0}
#: the same by path: the forward's paths, and the backward's
PATH_LAUNCHES = {"ffma": 0, "wgmma": 0, "bwd_ffma": 0, "bwd_wgmma": 0}
#: the backward's kernels, one launch each a backward call that needs them
BWD_LAUNCHES = {"states": 0, "dchunk": 0, "group_sum": 0}
#: the forward's paths: code of the C entry
PATHS = {"ffma": 0, "wgmma": 1}
#: the backward's paths
BWD_PATHS = ("bwd_ffma", "bwd_wgmma")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_P, _MAX_N = 64, 128     # the kernel's largest head and state sizes
_MAX_GRID_YZ = 65535
_INT32_MAX = 2 ** 31 - 1

_P, _I = ctypes.c_void_p, ctypes.c_int
_LL = ctypes.POINTER(ctypes.c_longlong)


@functools.cache
def library() -> ctypes.CDLL:
    """Build (first call only) and load the kernel's library."""
    lib = load_library("ssd_scan", SOURCES)
    lib.repro_ssd_scan.argtypes = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _LL, _P]
    lib.repro_ssd_scan.restype = _I
    lib.repro_ssd_scan_smem_bytes.argtypes = [_I, _I, _I]
    lib.repro_ssd_scan_smem_bytes.restype = _I
    lib.repro_ssd_scan_wgmma_tile.argtypes = [_I]
    lib.repro_ssd_scan_wgmma_tile.restype = _I
    lib.repro_ssd_scan_bwd_states.argtypes = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                              _LL, _P]
    lib.repro_ssd_scan_bwd_dchunk.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                              _P, _I, _I, _I, _I, _I, _I, _LL, _P]
    lib.repro_ssd_scan_bwd_group_sum.argtypes = [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                                 _P]
    lib.repro_ssd_scan_bwd_smem_bytes.argtypes = [_I, _I, _I]
    lib.repro_ssd_scan_bwd_chunk_rows.argtypes = []
    # the bwd_wgmma path's entries take the bwd_ffma path's arguments
    lib.repro_ssd_scan_bwd_wgmma_states.argtypes = lib.repro_ssd_scan_bwd_states.argtypes
    lib.repro_ssd_scan_bwd_wgmma_dchunk.argtypes = lib.repro_ssd_scan_bwd_dchunk.argtypes
    lib.repro_ssd_scan_bwd_wgmma_group_sum.argtypes = lib.repro_ssd_scan_bwd_group_sum.argtypes
    lib.repro_ssd_scan_bwd_wgmma_smem_bytes.argtypes = [_I]
    lib.repro_ssd_scan_bwd_wgmma_chunk_rows.argtypes = []
    lib.repro_ssd_scan_bwd_wgmma_tile_bytes.argtypes = []
    for fn in (lib.repro_ssd_scan_bwd_states, lib.repro_ssd_scan_bwd_dchunk,
               lib.repro_ssd_scan_bwd_group_sum, lib.repro_ssd_scan_bwd_smem_bytes,
               lib.repro_ssd_scan_bwd_chunk_rows, lib.repro_ssd_scan_bwd_wgmma_states,
               lib.repro_ssd_scan_bwd_wgmma_dchunk, lib.repro_ssd_scan_bwd_wgmma_group_sum,
               lib.repro_ssd_scan_bwd_wgmma_smem_bytes, lib.repro_ssd_scan_bwd_wgmma_chunk_rows,
               lib.repro_ssd_scan_bwd_wgmma_tile_bytes):
        fn.restype = _I
    return lib


def bwd_chunk_rows(path: str) -> int:
    """Rows of a chunk of the backward's ``path``: they size its states scratch."""
    lib = library()
    if path == "bwd_wgmma":
        return lib.repro_ssd_scan_bwd_wgmma_chunk_rows()
    if path == "bwd_ffma":
        return lib.repro_ssd_scan_bwd_chunk_rows()
    raise ValueError(f"ssd_bwd: unknown path {path!r}, not one of {BWD_PATHS}")


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


def choose_bwd_path(x: torch.Tensor, b_mat: torch.Tensor, c_mat: torch.Tensor,
                    dy: torch.Tensor) -> str:
    """``bwd_wgmma`` for bf16 with 16-byte rows in x, B, C and dY (P and N
    multiples of 8, the batch, length and head or group strides multiples
    of 8, pointers 16-byte aligned) and N above 32, as the forward's
    ``wgmma``; ``bwd_ffma`` for the rest: f32, whose 1e-4 gradients bf16
    operands would miss, and bf16 that is not aligned so or whose N is 32 or
    less (the forward's ``ffma`` there)."""
    n = b_mat.shape[-1]
    if (x.dtype == torch.bfloat16 and x.shape[-1] % 8 == 0 and n % 8 == 0 and n > 32
            and vector_rows(x, b_mat, c_mat, dy)):
        return "bwd_wgmma"
    return "bwd_ffma"


def _bwd_path(x, b_mat, c_mat, dy, path: Optional[str]) -> str:
    chosen = choose_bwd_path(x, b_mat, c_mat, dy)
    if path is None:
        return chosen
    if path not in BWD_PATHS:
        raise ValueError(f"ssd_bwd: unknown path {path!r}, not one of {BWD_PATHS}")
    if path == "bwd_wgmma" and chosen != path:
        raise ValueError("ssd_bwd: the bwd_wgmma path takes bfloat16 with 16-byte rows in x, B, "
                         "C and dY (P, N and the batch, length and head or group strides "
                         "multiples of 8) and N above 32")
    return path


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


def _path(x: torch.Tensor, b_mat: torch.Tensor, c_mat: torch.Tensor, path: Optional[str]) -> str:
    chosen = choose_path(x, b_mat, c_mat)
    if path is None:
        return chosen
    if path not in PATHS:
        raise ValueError(f"ssd_scan: unknown path {path!r}, not one of {sorted(PATHS)}")
    if path == "wgmma" and chosen != "wgmma":
        raise ValueError("ssd_scan: the wgmma path takes bfloat16 with 16-byte rows (P, N and "
                         "the batch, length and head or group strides multiples of 8) and N "
                         "above 32")
    return path


def _strides(*tensors: torch.Tensor) -> ctypes.Array:
    """(batch, length, head-or-group) strides of each tensor, in order, for a C entry."""
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def ssd_kernel(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
               c_mat: torch.Tensor, path: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel: (y (B, L, H, P) in x's dtype, final state (B, H, P, N) f32).
    ``path`` forces one of ``PATHS`` (every path computes the same function;
    tests hold each); it raises where that path does not take the operands."""
    _check(x, dt, a, b_mat, c_mat)
    path = _path(x, b_mat, c_mat, path)
    dt, a = dt.float(), a.float().contiguous()   # the kernel reads both in f32, as the reference does
    (bsz, l, h, p), (g, n) = x.shape, b_mat.shape[2:]
    y = torch.empty((bsz, l, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    if state.numel() == 0:
        return y, state
    with torch.cuda.device(x.device):
        err = library().repro_ssd_scan(
            PATHS[path], _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), a.data_ptr(),
            b_mat.data_ptr(), c_mat.data_ptr(), y.data_ptr(), state.data_ptr(), bsz, l, h, p, g,
            n, _strides(x, dt, b_mat, c_mat, y), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    LAUNCHES["ssd_scan"] += 1
    PATH_LAUNCHES[path] += 1
    return y, state


def ssd_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
            c_mat: torch.Tensor, dy: torch.Tensor, dstate: Optional[torch.Tensor] = None, *,
            need_bc: bool = True, path: Optional[str] = None) -> Tuple[Optional[torch.Tensor], ...]:
    """(dx, ddt, da, dB, dC) of the scan for the cotangents ``dy`` of y (x's
    shape and dtype, any strides with a unit-stride last dimension) and
    ``dstate`` of the final state ((B, H, P, N), or None for 0): dx, dB and
    dC in x's dtype, ddt and da in f32.  Three launches: the state entering
    each chunk, then the chunks walked last first (dx, ddt, and each head's
    dB, dC and da), then dB and dC summed over each group's heads and da
    over the batch (``need_bc``; without it dB, dC and da are None and not
    launched).  ``path`` forces one of ``BWD_PATHS`` (both compute the same
    function; tests hold each); it raises where that path does not take the
    operands.  CUDA tensors only: the plain version is ``ref.ssd_bwd_ref``."""
    _check(x, dt, a, b_mat, c_mat)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device or dy.stride(-1) != 1:
        raise ValueError(f"ssd_bwd: dy {tuple(dy.shape)} {dy.dtype} must be x's shape, dtype and "
                         "device with a unit-stride last dimension")
    path = _bwd_path(x, b_mat, c_mat, dy, path)
    (bsz, l, h, p), (g, n) = x.shape, b_mat.shape[2:]
    if dstate is not None:
        if dstate.shape != (bsz, h, p, n) or dstate.device != x.device:
            raise ValueError(f"ssd_bwd: dstate {tuple(dstate.shape)} must be ({bsz}, {h}, {p}, "
                             f"{n}) on {x.device}")
        dstate = dstate.float().contiguous()
    dt, a = dt.float(), a.float().contiguous()
    dev = x.device
    dx = torch.empty((bsz, l, h, p), dtype=x.dtype, device=dev)
    ddt = torch.empty((bsz, l, h), dtype=torch.float32, device=dev)
    db = torch.empty((bsz, l, g, n), dtype=x.dtype, device=dev) if need_bc else None
    dc = torch.empty((bsz, l, g, n), dtype=x.dtype, device=dev) if need_bc else None
    da = torch.zeros((h,), dtype=torch.float32, device=dev) if need_bc else None
    if x.numel() == 0 or b_mat.numel() == 0:
        return (dx.zero_(), ddt.zero_(), da, None if db is None else db.zero_(),
                None if dc is None else dc.zero_())
    lib = library()
    chunks = -(-l // bwd_chunk_rows(path))
    if path == "bwd_wgmma":   # bf16 S_in tiles of chunks 1.., bf16 per-head partials
        states = torch.empty((bsz, h, chunks - 1, lib.repro_ssd_scan_bwd_wgmma_tile_bytes()),
                             dtype=torch.uint8, device=dev)
        part = x.dtype
        entries = (lib.repro_ssd_scan_bwd_wgmma_states, lib.repro_ssd_scan_bwd_wgmma_dchunk,
                   lib.repro_ssd_scan_bwd_wgmma_group_sum)
    else:                     # f32 S_in of every chunk, f32 per-head partials
        states = torch.empty((bsz, h, chunks, p, n), dtype=torch.float32, device=dev)
        part = torch.float32
        entries = (lib.repro_ssd_scan_bwd_states, lib.repro_ssd_scan_bwd_dchunk,
                   lib.repro_ssd_scan_bwd_group_sum)
    dbp = torch.empty((bsz, l, h, n), dtype=part, device=dev)
    dcp = torch.empty((bsz, l, h, n), dtype=part, device=dev)
    da_part = torch.empty((bsz, h), dtype=torch.float32, device=dev)
    dtype = _DTYPES[x.dtype]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entries[0](dtype, x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(),
                         states.data_ptr(), bsz, l, h, p, g, n, _strides(x, dt, b_mat), stream)
        if err != 0:
            raise RuntimeError(f"ssd_scan_bwd states launch failed ({path}): CUDA error {err}")
        BWD_LAUNCHES["states"] += 1
        err = entries[1](
            dtype, x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
            dy.data_ptr(), states.data_ptr(), None if dstate is None else dstate.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), dbp.data_ptr(), dcp.data_ptr(), da_part.data_ptr(),
            bsz, l, h, p, g, n, _strides(x, dt, b_mat, c_mat, dy, dx), stream)
        if err != 0:
            raise RuntimeError(f"ssd_scan_bwd dchunk launch failed ({path}): CUDA error {err}")
        BWD_LAUNCHES["dchunk"] += 1
        if need_bc:
            err = entries[2](dtype, dbp.data_ptr(), dcp.data_ptr(), da_part.data_ptr(),
                             db.data_ptr(), dc.data_ptr(), da.data_ptr(), bsz, l, h, g, n, stream)
            if err != 0:
                raise RuntimeError(f"ssd_scan_bwd group_sum launch failed ({path}): CUDA error "
                                   f"{err}")
            BWD_LAUNCHES["group_sum"] += 1
    LAUNCHES["ssd_scan_bwd"] += 1
    PATH_LAUNCHES[path] += 1
    return dx, ddt, da, db, dc


class SSDScan(torch.autograd.Function):
    """The SSD kernel with its gradient (the reference's custom VJP,
    ``repro/kernels/ssd_scan/ops.py:22-49``, whose backward is the vjp of
    ``ssd_chunked``; here the kernels of ``ssd_bwd``).  The forward is one
    launch and saves x, dt, a, B and C (dt and a in f32, cast outside so
    that the gradients reach the caller's tensors); under remat it runs
    again in the backward's recompute, and each run is a forward launch.
    A cotangent autograd leaves out (the final state's, in training) is 0."""

    @staticmethod
    def forward(ctx, x, dt, a, b_mat, c_mat, path):
        ctx.set_materialize_grads(False)
        y, state = ssd_kernel(x, dt, a, b_mat, c_mat, path)
        ctx.save_for_backward(x, dt, a, b_mat, c_mat)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, a, b_mat, c_mat = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x, memory_format=torch.contiguous_format)
        elif dy.stride(-1) != 1:    # e.g. an expanded zero cotangent: the one copy of dY
            dy = dy.contiguous()
        need = ctx.needs_input_grad[:5]
        grads = ssd_bwd(x, dt, a, b_mat, c_mat, dy, dstate, need_bc=any(need[2:]))
        return (*(gr if nd else None for gr, nd in zip(grads, need)), None)


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
    the kernel's ``PATHS`` on the card (``impl="pallas"``).  Under grad a
    CUDA call goes through ``SSDScan``; otherwise it is one forward launch."""
    if impl == "sequential":
        return ref.ssd_sequential(x, dt, a, b_mat, c_mat)
    if impl == "chunked":
        return ref.ssd_chunked(x, dt, a, b_mat, c_mat, chunk=chunk)
    if impl == "pallas":
        refuse_dtensor("ssd_scan", x, dt, a, b_mat, c_mat)
        if all(t.device.type == "cpu" for t in (x, dt, a, b_mat, c_mat)):
            return ref.ssd_chunked(x, dt, a, b_mat, c_mat, chunk=chunk)
        if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, a, b_mat, c_mat)):
            _check(x, dt, a, b_mat, c_mat)
            return SSDScan.apply(x, dt.float(), a.float(), b_mat, c_mat,
                                 _path(x, b_mat, c_mat, path))
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
