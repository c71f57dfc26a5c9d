"""RG-LRU scan: the Hopper kernels and their dispatch.

``rglru_scan(log_a, b, impl=)`` computes ``h_t = exp(log_a_t)·h_{t−1} +
b_t`` over axis 1 of (B, L, W) inputs from h = 0 and returns (y in b's
dtype, h_final (B, W) in f32), as ``repro.kernels.rglru_scan.ops.rglru_scan``
does.  ``impl`` is the reference's:

* ``"sequential"`` and ``"associative"`` are the plain versions in
  ``ref.py``, on any device;
* ``"pallas"`` is the kernel's route, and the tensors' device picks the
  implementation: CPU tensors take ``ref.rglru_associative`` with torch's
  autograd; anything else goes to ``csrc/rglru_scan.cu``, which launches or
  raises (nothing falls back to the plain version).

The kernel takes any L (the reference's Pallas kernel needs L to be a
multiple of its chunk; its oracle does not).  Under grad (grad mode on and
an input that requires it) a CUDA call goes through ``RGLRUScan``, whose
forward is one launch of the kernel and whose backward is ``rglru_bwd``, so
a config with ``rglru_impl="pallas"`` trains the hybrid family on the
kernels, as the reference's custom VJP does.

The backward has two paths, picked by ``choose_bwd_path`` from L alone:
``bwd_onchip`` (``csrc/rglru_scan_bwd_onchip.cu``: log_a, b and dy read
once into registers, segments exchanged inside a block or a thread-block
cluster, no workspace) for L up to ``ONCHIP_MAX_L``, f32 and bf16 alike;
``bwd_fourpass`` (``csrc/rglru_scan_bwd.cu``: h recomputed into an f32
workspace, then the reverse scan) above it, for any L.
``rglru_bwd(..., path=)`` forces one; ``bwd_onchip`` raises above its
capacity.

``LAUNCHES["rglru_scan"]`` counts forward launches and
``LAUNCHES["rglru_scan_bwd"]`` backward calls, ``PATH_LAUNCHES`` the
backward calls by path and ``BWD_LAUNCHES`` each backward kernel's
launches (``"onchip"``, ``"reverse_scan"``: the four-pass kernel).
``rglru_decode_step`` is the one-token update of decode, plain torch as in
the reference.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.dist.sharding import refuse_dtensor
from repro_torch.kernels.build import load_library
from repro_torch.kernels.rglru_scan import ref

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "rglru_scan.cu", _CSRC / "rglru_scan_bwd.cu",
           _CSRC / "rglru_scan_bwd_onchip.cu")

#: forward launches and backward calls so far; callers reset them to 0 to count a run
LAUNCHES = {"rglru_scan": 0, "rglru_scan_bwd": 0}
#: the backward's paths
BWD_PATHS = ("bwd_fourpass", "bwd_onchip")
#: backward calls by path
PATH_LAUNCHES = {path: 0 for path in BWD_PATHS}
#: the backward's kernels, one launch a backward call: the four-pass kernel, the on-chip one
BWD_LAUNCHES = {"reverse_scan": 0, "onchip": 0}

#: the on-chip kernel's tile (rglru_scan_bwd_onchip.cu): lanes of W a block, the
#: most steps a thread holds, segments (warps) a block and blocks a cluster
ONCHIP_LANES, ONCHIP_STEPS, ONCHIP_MAX_WARPS, ONCHIP_MAX_CLUSTER = 32, 32, 16, 8
#: the longest L the on-chip path takes
ONCHIP_MAX_L = ONCHIP_STEPS * ONCHIP_MAX_WARPS * ONCHIP_MAX_CLUSTER
_ONCHIP_WARPS = 8          # segments a block up to L = 2048
_ONCHIP_SHORT_STEPS = 16   # the short kernel's steps a thread (three blocks an SM)

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
    lib.repro_rglru_scan_bwd.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _Strides, _P]
    lib.repro_rglru_scan_bwd.restype = _I
    lib.repro_rglru_scan_bwd_onchip.argtypes = [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                                _I, _Strides, _P]
    lib.repro_rglru_scan_bwd_onchip.restype = _I
    lib.repro_rglru_scan_bwd_onchip_capacity.argtypes = []
    lib.repro_rglru_scan_bwd_onchip_capacity.restype = _I
    return lib


def onchip_schedule(length: int) -> Tuple[int, int, int]:
    """(steps a segment, segments a block, blocks a cluster) of the on-chip
    kernel for L = ``length``, the steps covering L: 8 segments a block of
    up to 16 steps (the short kernel) in clusters of ceil(L / 128) blocks up
    to L = 1024, of up to 32 steps in clusters of ceil(L / 256) up to L =
    2048, then clusters of 8 with up to 16 segments a block.  Raises above
    ``ONCHIP_MAX_L``."""
    if not 1 <= length <= ONCHIP_MAX_L:
        raise ValueError(f"rglru_bwd: the on-chip path takes 1 <= L <= {ONCHIP_MAX_L}, "
                         f"got L = {length}")
    short_block = _ONCHIP_WARPS * _ONCHIP_SHORT_STEPS
    if length <= short_block * ONCHIP_MAX_CLUSTER:
        warps, cluster = _ONCHIP_WARPS, math.ceil(length / short_block)
    elif length <= _ONCHIP_WARPS * ONCHIP_STEPS * ONCHIP_MAX_CLUSTER:
        warps, cluster = _ONCHIP_WARPS, math.ceil(length / (_ONCHIP_WARPS * ONCHIP_STEPS))
    else:
        warps, cluster = math.ceil(length / (ONCHIP_STEPS * ONCHIP_MAX_CLUSTER)), ONCHIP_MAX_CLUSTER
    return math.ceil(length / (warps * cluster)), warps, cluster


def choose_bwd_path(log_a: torch.Tensor, b: torch.Tensor) -> str:
    """``bwd_onchip`` where L is at most ``ONCHIP_MAX_L``, ``bwd_fourpass``
    above it; f32 and bf16 alike (both paths run f32 FFMA)."""
    return "bwd_onchip" if b.shape[1] <= ONCHIP_MAX_L else "bwd_fourpass"


def _bwd_path(log_a: torch.Tensor, b: torch.Tensor, path: Optional[str]) -> str:
    chosen = choose_bwd_path(log_a, b)
    if path is None:
        return chosen
    if path not in BWD_PATHS:
        raise ValueError(f"rglru_bwd: unknown path {path!r}, not one of {BWD_PATHS}")
    if path == "bwd_onchip" and chosen != path:
        raise ValueError(f"rglru_bwd: the bwd_onchip path takes L <= {ONCHIP_MAX_L}, "
                         f"got L = {b.shape[1]}")
    return path


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


def rglru_bwd(log_a: torch.Tensor, b: torch.Tensor, dy: torch.Tensor,
              dh_final: Optional[torch.Tensor] = None,
              path: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dlog_a in log_a's dtype, db in b's dtype) of the scan for the
    cotangents ``dy`` of y (b's shape and dtype, any strides with a
    unit-stride last dimension) and ``dh_final`` of the final state ((B, W),
    or None for 0).  One launch on ``path`` (None: ``choose_bwd_path``'s);
    only ``bwd_fourpass`` allocates a workspace (h in f32).  ``bwd_onchip``
    raises on a length stride or a W above 2**31 / 32 elements (its step
    offsets are 32-bit).  CUDA tensors only: the plain version is
    ``ref.rglru_bwd``."""
    _check(log_a, b)
    path = _bwd_path(log_a, b, path)
    if dy.shape != b.shape or dy.dtype != b.dtype or dy.device != b.device or dy.stride(-1) != 1:
        raise ValueError(f"rglru_bwd: dy {tuple(dy.shape)} {dy.dtype} must be b's shape, dtype "
                         "and device with a unit-stride last dimension")
    bs, l, w = b.shape
    if dh_final is not None:
        if dh_final.shape != (bs, w) or dh_final.device != b.device:
            raise ValueError(f"rglru_bwd: dh_final {tuple(dh_final.shape)} must be ({bs}, {w}) "
                             f"on {b.device}")
        dh_final = dh_final.float().contiguous()
    la = log_a.float()
    dlog_a = torch.empty((bs, l, w), dtype=torch.float32, device=b.device)
    db = torch.empty((bs, l, w), dtype=b.dtype, device=b.device)
    if db.numel() == 0:
        return dlog_a.to(log_a.dtype), db
    strides = _Strides(*(s for t in (la, b, dy) for s in t.stride()[:2]))
    dhf = None if dh_final is None else dh_final.data_ptr()
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        if path == "bwd_onchip":
            kernel = "onchip"
            err = library().repro_rglru_scan_bwd_onchip(
                _DTYPES[b.dtype], la.data_ptr(), b.data_ptr(), dy.data_ptr(), dhf,
                dlog_a.data_ptr(), db.data_ptr(), bs, l, w, *onchip_schedule(l), strides, stream)
        else:
            kernel = "reverse_scan"
            h_ws = torch.empty((bs, l, w), dtype=torch.float32, device=b.device)
            err = library().repro_rglru_scan_bwd(
                _DTYPES[b.dtype], la.data_ptr(), b.data_ptr(), dy.data_ptr(), dhf,
                h_ws.data_ptr(), dlog_a.data_ptr(), db.data_ptr(), bs, l, w, strides, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan_bwd kernel launch failed ({path}): CUDA error {err}")
    BWD_LAUNCHES[kernel] += 1
    PATH_LAUNCHES[path] += 1
    LAUNCHES["rglru_scan_bwd"] += 1
    return dlog_a.to(log_a.dtype), db


class RGLRUScan(torch.autograd.Function):
    """The RG-LRU kernel with its gradient (the reference's custom VJP,
    ``repro/kernels/rglru_scan/ops.py:14-26``, whose backward is the vjp of
    ``rglru_associative``; here the kernel of ``rglru_bwd``).  The forward
    is one launch and saves log_a and b; under remat it runs again in the
    backward's recompute, and each run is a forward launch.  A cotangent
    autograd leaves out (the final state's, in training) is 0."""

    @staticmethod
    def forward(ctx, log_a, b):
        ctx.set_materialize_grads(False)
        y, h_final = rglru_kernel(log_a, b)
        ctx.save_for_backward(log_a, b)
        return y, h_final

    @staticmethod
    def backward(ctx, dy, dh_final):
        log_a, b = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(b, memory_format=torch.contiguous_format)
        elif dy.stride(-1) != 1:    # e.g. an expanded zero cotangent
            dy = dy.contiguous()
        dlog_a, db = rglru_bwd(log_a, b, dy, dh_final)
        need = ctx.needs_input_grad
        return dlog_a if need[0] else None, db if need[1] else None


def rglru_scan(
    log_a: torch.Tensor,
    b: torch.Tensor,
    impl: str = "associative",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = exp(log_a_t)·h_{t-1} + b_t over axis 1.  -> (y, h_final).
    Under grad a CUDA call goes through ``RGLRUScan``; otherwise it is one
    forward launch."""
    if impl == "sequential":
        return ref.rglru_sequential(log_a, b)
    if impl == "associative":
        return ref.rglru_associative(log_a, b)
    if impl == "pallas":
        refuse_dtensor("rglru_scan", log_a, b)
        if log_a.device.type == b.device.type == "cpu":
            return ref.rglru_associative(log_a, b)
        if torch.is_grad_enabled() and (log_a.requires_grad or b.requires_grad):
            return RGLRUScan.apply(log_a, b)
        return rglru_kernel(log_a, b)
    raise ValueError(f"unknown rglru impl: {impl}")


def rglru_decode_step(
    h: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-step update.  h, log_a, b: (B, W).  Returns (y, new_h)."""
    h_new = torch.exp(log_a.float()) * h.float() + b.float()
    return h_new.to(b.dtype), h_new
