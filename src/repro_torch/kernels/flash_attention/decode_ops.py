"""Int8 split-KV decode attention: the Hopper kernel and its dispatch.

``flash_decode_int8(q, k_q, v_q, k_scale, v_scale, kv_len=)`` has the
signature and layouts of ``repro.kernels.flash_attention.decode_kernel.
flash_decode_int8``: q ``(B, Hq, D)``, int8 K/V ``(B, Hk, S, D)``, scales
``(B, Hk, S)``, out ``(B, Hq, D)`` in f32; positions ``>= kv_len`` masked.
Every operand may be a strided view, so the model's ``(B, S, Hk, D)`` cache
and ``(B, S, Hk)`` scales are read in place through ``transpose(1, 2)``.
Any S is taken (the TPU wrapper needs S to be a multiple of its tile).
The tensor's device picks the implementation:

* a CUDA tensor launches ``csrc/flash_decode_int8.cu`` or raises; nothing
  falls back to the plain version;
* a CPU tensor takes the plain version in ``decode_ref.py``.

The kernel is one launch a call and has one path for every shape it takes
(``G * D <= 4096``): the positions are cut into 1, 2, 4 or 8 splits
(``split_len``, from what the card's clusters hold: ``cluster_fit``), and
the splits of one (batch, KV head) are one thread-block cluster that
combines them in shared memory.  ``LAUNCHES`` counts kernel
launches, so a run can show that its path went through the kernel.  No
model of the reference calls this kernel: its decode dequantizes the int8
cache and attends through the plain attention, and the port's does the
same.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Dict, Mapping

import torch

from repro_torch.dist.sharding import refuse_dtensor
from repro_torch.kernels.build import load_library
from repro_torch.kernels.flash_attention import decode_ref

SOURCES = (Path(__file__).resolve().parent / "csrc" / "flash_decode_int8.cu",)

#: kernel launches so far; callers reset it to 0 to count a run
LAUNCHES = {"flash_decode_int8": 0}

_FLOAT = (torch.float32, torch.bfloat16)
_MAX_D = 256
_MAX_GROUP_COLUMNS = 4096  # (Hq / Hk) * D: the (head, column) outputs a block keeps
#: cluster sizes the kernel takes: the splits of one (batch, KV head) form a
#: cluster, and 8 is the portable cluster size
CLUSTER_SIZES = (1, 2, 4, 8)
_MIN_SPLIT = 64          # positions: no split is cut shorter
_SPLIT_GRAIN = 32        # positions: a split is a multiple of this
_MAX_GRID_YZ = 65535
_MAX_POSITIONS = 2 ** 30    # the kernel's row counters run past S in int32

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_Strides = ctypes.c_longlong * 14


@functools.cache
def library() -> ctypes.CDLL:
    """Build (first call only) and load the kernel's library."""
    lib = load_library("flash_decode_int8", SOURCES)
    lib.repro_flash_decode_int8.argtypes = [_P] * 6 + [_I] * 8 + [_F, _I, _I, _I, _Strides, _P]
    lib.repro_flash_decode_int8.restype = _I
    lib.repro_flash_decode_int8_smem_bytes.argtypes = [_I, _I]
    lib.repro_flash_decode_int8_smem_bytes.restype = _I
    lib.repro_flash_decode_int8_max_clusters.argtypes = [_I, _I, _I]
    lib.repro_flash_decode_int8_max_clusters.restype = _I
    return lib


@functools.cache
def cluster_fit(index: int, group: int, d: int) -> Dict[int, int]:
    """{cluster size: clusters of that many blocks that fit on card ``index``
    at once} for ``group`` query heads a KV head at head size ``d``
    (``cudaOccupancyMaxActiveClusters``: whole GPCs hold a cluster, so the
    count can fall below SMs / size)."""
    lib = library()
    with torch.cuda.device(index):
        fit = {c: lib.repro_flash_decode_int8_max_clusters(group, d, c) for c in CLUSTER_SIZES}
    if any(n < 0 for n in fit.values()):
        raise RuntimeError(f"flash_decode_int8: the cluster occupancy query failed: {fit}")
    return fit


def split_len(batch: int, kv_heads: int, s: int, clusters: Mapping[int, int]) -> int:
    """Positions per split.  The splits of one (batch, KV head) form a
    cluster, and their count is the largest of ``CLUSTER_SIZES`` with which
    all ``batch * kv_heads`` clusters fit on the card at once: ``clusters``
    maps a cluster size to how many fit (``cluster_fit``).  So one split
    where ``batch * kv_heads`` alone fills the card.  A split is a multiple
    of ``_SPLIT_GRAIN`` positions and no shorter than ``_MIN_SPLIT``; split
    ``i`` holds positions ``[i * chunk, min((i + 1) * chunk, s))``."""
    pairs = max(batch * kv_heads, 1)
    want = max([c for c in CLUSTER_SIZES if pairs <= clusters.get(c, 0)], default=1)
    per_split = -(-s // want)
    return max(_MIN_SPLIT, -(-per_split // _SPLIT_GRAIN) * _SPLIT_GRAIN)


def _check(q, k_q, v_q, k_scale, v_scale) -> None:
    dev = q.device
    for t in (k_q, v_q, k_scale, v_scale):
        if t.device != dev:
            raise ValueError(f"flash_decode_int8: tensors on {dev} and {t.device}")
    if dev.type != "cuda":
        raise ValueError(f"flash_decode_int8: the kernel takes CUDA tensors, got {dev}")
    if q.dtype not in _FLOAT or k_scale.dtype not in _FLOAT:
        raise TypeError(f"flash_decode_int8: q {q.dtype} and scales {k_scale.dtype} must be "
                        "float32 or bfloat16")
    if k_q.dtype != torch.int8 or v_q.dtype != torch.int8 or v_scale.dtype != k_scale.dtype:
        raise TypeError(f"flash_decode_int8: want int8 K/V and one scale dtype, got {k_q.dtype}, "
                        f"{v_q.dtype}, {k_scale.dtype}, {v_scale.dtype}")
    (b, hq, d), (bk, hk, s, dk) = q.shape, k_q.shape
    if (bk != b or dk != d or hk == 0 or hq % hk or v_q.shape != k_q.shape
            or k_scale.shape != (b, hk, s) or v_scale.shape != (b, hk, s)):
        raise ValueError(f"flash_decode_int8: q {tuple(q.shape)}, k/v {tuple(k_q.shape)}, "
                         f"{tuple(v_q.shape)}, scales {tuple(k_scale.shape)}, "
                         f"{tuple(v_scale.shape)}: want (B, Hq, D), (B, Hk, S, D), (B, Hk, S)")
    if d > _MAX_D or (hq // hk) * d > _MAX_GROUP_COLUMNS:
        raise ValueError(f"flash_decode_int8: head size {d} with {hq // hk} query heads a KV "
                         f"head is beyond the kernel (D <= {_MAX_D}, G * D <= {_MAX_GROUP_COLUMNS})")
    if any(t.stride(-1) != 1 for t in (q, k_q, v_q)):
        raise ValueError("flash_decode_int8: the head dimension must be unit-stride")
    if s > _MAX_POSITIONS or b > _MAX_GRID_YZ or hk > _MAX_GRID_YZ:
        raise ValueError(f"flash_decode_int8: shapes exceed the kernel's grid: {tuple(k_q.shape)}")
    if q.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError("flash_decode_int8: the kernel has no backward (neither has "
                                  "the reference's)")


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0 and all(st % 16 == 0 for st in t.stride()[:-1])


def flash_decode_int8(
    q: torch.Tensor,        # (B, Hq, D) f32 or bf16
    k_q: torch.Tensor,      # (B, Hk, S, D) int8
    v_q: torch.Tensor,      # (B, Hk, S, D) int8
    k_scale: torch.Tensor,  # (B, Hk, S) f32 or bf16
    v_scale: torch.Tensor,  # (B, Hk, S)
    *,
    kv_len: int,
) -> torch.Tensor:
    """o (B, Hq, D) in f32: q attends to the first ``kv_len`` positions.

    ``kv_len`` outside ``[1, S]`` gives the reference's values: past S every
    slot is live (``kv_len = S``); at ``kv_len <= 0`` every score is masked
    alike, so the softmax is uniform and o is the mean of the dequantized V
    over all S slots.  On a CUDA tensor the kernel computes that mean too:
    the wrapper launches it over all S slots with a zero query, whose
    scores are all equal, so its weights are the same uniform weights."""
    refuse_dtensor("flash_decode_int8", q, k_q, v_q, k_scale, v_scale)
    s = k_q.shape[2]
    if s < 1:
        raise ValueError("flash_decode_int8: the cache holds no position")
    kv_len = int(kv_len)
    if q.device.type == "cpu":
        return decode_ref.flash_decode_int8_ref(q, k_q, v_q, k_scale, v_scale, kv_len=kv_len)
    _check(q, k_q, v_q, k_scale, v_scale)
    if kv_len <= 0:
        q = torch.zeros_like(q)
    kv_len = s if kv_len <= 0 else min(kv_len, s)
    (b, hq, d), hk = q.shape, k_q.shape[1]
    out = torch.empty((b, hq, d), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    index = q.device.index if q.device.index is not None else torch.cuda.current_device()
    chunk = split_len(b, hk, s, cluster_fit(index, hq // hk, d))
    splits = -(-s // chunk)
    strides = _Strides(*q.stride()[:2], *k_q.stride()[:3], *v_q.stride()[:3],
                       *k_scale.stride(), *v_scale.stride())
    vec = int(d % 16 == 0 and _aligned(k_q) and _aligned(v_q))
    with torch.cuda.device(q.device):
        err = library().repro_flash_decode_int8(
            q.data_ptr(), k_q.data_ptr(), v_q.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
            out.data_ptr(), b, hq, hk, s, d, kv_len, chunk, splits, 1.0 / math.sqrt(d),
            int(q.dtype == torch.bfloat16),
            int(k_scale.dtype == torch.bfloat16), vec, strides,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode_int8 kernel launch failed: CUDA error {err}")
    LAUNCHES["flash_decode_int8"] += 1
    return out
