"""Flash attention with its gradient: the Hopper kernels and their dispatch.

``flash_attention(q, k, v, ...)`` takes the model's ``(B, S, H, D)`` layout,
as ``repro.kernels.flash_attention.ops.flash_attention`` does, with the
same conventions: contiguous positions (queries are the last ``Sq`` of the
``Skv`` positions), causal and sliding-window masks, GQA through
``h // (Hq / Hk)``, scale ``1/√D``, output in ``q.dtype``.  The position
arguments are accepted and ignored, as the reference ignores them.  The
tensor's device picks the implementation:

* a CUDA tensor launches ``csrc/flash_attention.cu`` or raises; nothing
  falls back to the plain version.  Under grad (grad mode on and an input
  that requires it) the call goes through ``FlashAttention``, whose forward
  also saves each row's log-sum-exp and whose backward launches the
  backward's kernels (``flash_attention_bwd``);
* a CPU tensor takes the plain version in ``ref.py``, with torch's own
  autograd.

The forward has two paths, picked by ``choose_path`` before the launch
from the dtype, D and the operands' alignment: ``wgmma`` (bf16 with 16-byte
rows, both products on the tensor cores) and ``ffma`` (f32, and bf16 that
is not aligned so).  ``LAUNCHES["flash_attention"]`` counts forward
launches and ``PATH_LAUNCHES`` the same launches by path, so a run can show
which path its attention went through.  The backward has two paths, picked
by ``choose_bwd_path`` from the same conditions on q, k, v, o and dO:
``bwd_wgmma`` (bf16 with 16-byte rows: ``csrc/flash_attention_bwd_wgmma.cu``,
every product on the tensor cores, a group's query heads split across
blocks where the grid is too small for the card, ``bwd_head_splits``) and
``bwd_ffma`` (f32, whose 1e-4 gradients one TF32 pass would miss, and bf16
that is not aligned so: ``csrc/flash_attention_bwd.cu``, scalar FFMA).
``LAUNCHES["flash_attention_bwd"]`` counts backward calls, ``PATH_LAUNCHES``
the same calls by path, and ``BWD_LAUNCHES`` each kernel's launches
(``preprocess``, ``dkdv``, ``dq``, and ``reduce``, the sum of a head
split's partials, only where there is a split).  ``kv_tiles`` is the
kernels' block-skip: the KV tiles a query tile visits; ``q_tiles`` its
mirror, the query tiles that see a KV tile.  A config with
``attn_impl="pallas"`` trains through the kernels; the reference's own
training default, ``attention_chunked``, stays the default here too.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.dist.sharding import is_dtensor
from repro_torch.kernels import vector_rows
from repro_torch.kernels.build import load_library
from repro_torch.kernels.flash_attention import ref

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "flash_attention.cu", _CSRC / "flash_attention_bwd.cu",
           _CSRC / "flash_attention_bwd_wgmma.cu")

#: forward launches and backward calls so far; callers reset them to 0 to count a run
LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}
#: the same by path: the forward's paths, and the backward's
PATH_LAUNCHES = {"ffma": 0, "wgmma": 0, "bwd_ffma": 0, "bwd_wgmma": 0}
#: the backward's kernels, one launch each a backward call that needs them
BWD_LAUNCHES = {"preprocess": 0, "dkdv": 0, "dq": 0, "reduce": 0}
#: the forward's paths: code of the C entry
PATHS = {"ffma": 0, "wgmma": 1}
#: the backward's paths
BWD_PATHS = ("bwd_ffma", "bwd_wgmma")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 256
_MAX_GRID_YZ = 65535
_INT32_MAX = 2 ** 31 - 1

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.POINTER(ctypes.c_longlong)


@functools.cache
def library() -> ctypes.CDLL:
    """Build (first call only) and load the kernel's library."""
    lib = load_library("flash_attention", SOURCES)
    lib.repro_flash_attention.argtypes = [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                          _LL, _F, _I, _I, _P]
    lib.repro_flash_attention_bwd_preprocess.argtypes = [_I, _P, _P, _P, _I, _I, _I, _I, _LL,
                                                         _P]
    lib.repro_flash_attention_bwd_dkdv.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                                   _I, _I, _I, _I, _LL, _F, _I, _I, _P]
    lib.repro_flash_attention_bwd_dq.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                                 _I, _I, _LL, _F, _I, _I, _P]
    lib.repro_flash_attention_bwd_wgmma_preprocess.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I,
                                                               _I, _LL, _F, _P]
    lib.repro_flash_attention_bwd_wgmma_dkdv.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                                         _I, _I, _I, _I, _I, _I, _I, _LL, _I, _I,
                                                         _P]
    lib.repro_flash_attention_bwd_wgmma_dq.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                                       _I, _I, _LL, _F, _I, _I, _P]
    lib.repro_flash_attention_bwd_split_reduce.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _LL,
                                                           _P]
    lib.repro_flash_attention_smem_bytes.argtypes = [_I, _I]
    lib.repro_flash_attention_tile.argtypes = [_I, _I, _I]
    lib.repro_flash_attention_bwd_smem_bytes.argtypes = [_I, _I]
    lib.repro_flash_attention_bwd_tile.argtypes = [_I, _I]
    lib.repro_flash_attention_bwd_wgmma_smem_bytes.argtypes = [_I, _I]
    lib.repro_flash_attention_bwd_wgmma_tile.argtypes = [_I, _I]
    for fn in (lib.repro_flash_attention, lib.repro_flash_attention_bwd_preprocess,
               lib.repro_flash_attention_bwd_dkdv, lib.repro_flash_attention_bwd_dq,
               lib.repro_flash_attention_bwd_wgmma_preprocess,
               lib.repro_flash_attention_bwd_wgmma_dkdv, lib.repro_flash_attention_bwd_wgmma_dq,
               lib.repro_flash_attention_bwd_split_reduce,
               lib.repro_flash_attention_smem_bytes, lib.repro_flash_attention_tile,
               lib.repro_flash_attention_bwd_smem_bytes, lib.repro_flash_attention_bwd_tile,
               lib.repro_flash_attention_bwd_wgmma_smem_bytes,
               lib.repro_flash_attention_bwd_wgmma_tile):
        fn.restype = _I
    for path, code in PATHS.items():
        for d in (32, 64, 128, 256):
            got = (lib.repro_flash_attention_tile(code, d, 0), lib.repro_flash_attention_tile(code, d, 1))
            if got != tiles(path, d):
                raise RuntimeError(f"flash path {path}, D={d}: the kernel's tile {got} differs "
                                   f"from {tiles(path, d)}")
    for d in (32, 64, 128, 256):
        ffma = (lib.repro_flash_attention_bwd_tile(d, 0), lib.repro_flash_attention_bwd_tile(d, 1))
        wgmma = tuple(lib.repro_flash_attention_bwd_wgmma_tile(d, i) for i in range(4))
        for path, got in (("bwd_ffma", (ffma, ffma)), ("bwd_wgmma", (wgmma[:2], wgmma[2:]))):
            if got != bwd_tiles(path, d):
                raise RuntimeError(f"flash backward {path}, D={d}: the kernels' tiles {got} "
                                   f"differ from {bwd_tiles(path, d)}")
    return lib


def tiles(path: str, d: int) -> Tuple[int, int]:
    """(query rows, keys) of a block's tile on ``path`` at head size ``d``."""
    if path == "wgmma":
        return 128, 128 if d <= 128 else 64
    return 64, 64


def bwd_tiles(path: str, d: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """The backward's tiles on ``path`` at head size ``d``: (query rows,
    keys) of the dK/dV kernel's (q tile a step, KV tile a block) and of the
    dQ kernel's (q tile a block, KV tile a step).  ``bwd_ffma``: 64 x 64 in
    both, 32 keys at D = 256 (q^, dO, K, V, P and dS as f32 in 227 KB of
    shared memory).  ``bwd_wgmma``: 64 x 64 in both (one warpgroup a
    block), and at D = 256 dK/dV steps 64 q rows over 64 keys (two
    warpgroups) and dQ 64 rows over 32 keys."""
    if path == "bwd_wgmma":
        return ((64, 64), (64, 64)) if d <= 128 else ((64, 64), (64, 32))
    if path != "bwd_ffma":
        raise ValueError(f"flash backward: unknown path {path!r}, not one of {BWD_PATHS}")
    tile = (64, 64 if d <= 128 else 32)
    return tile, tile


def bwd_head_splits(b: int, hk: int, group: int, n_kt: int, sms: int) -> Tuple[int, int]:
    """(splits, query heads a split) of the ``bwd_wgmma`` dK/dV grid: one
    block a (batch, KV head, key tile) walks every query head of its group
    unless those ``b * hk * n_kt`` blocks are fewer than two a
    multiprocessor (``sms`` of them): then the group's heads are cut into
    as many splits as ``group // want`` heads a split make, where ``want``
    splits would give two blocks a multiprocessor (at most one head a
    split), the heads shared out as evenly as that count allows.  Each split
    writes partial sums that one more launch adds.  Every head lies in
    exactly one split, and no split is empty."""
    blocks = b * hk * n_kt
    if group <= 1 or blocks >= 2 * sms:
        return 1, max(group, 1)
    splits = -(-group // max(1, group // -(-2 * sms // max(blocks, 1))))
    per = -(-group // splits)
    return -(-group // per), per


def bwd_splits(q: torch.Tensor, k: torch.Tensor) -> Tuple[int, int]:
    """``bwd_head_splits`` of the ``bwd_wgmma`` dK/dV launch for CUDA
    tensors q and k, on their card."""
    (b, _, hq, d), (skv, hk) = q.shape, k.shape[1:3]
    (_, tk), _ = bwd_tiles("bwd_wgmma", d)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    return bwd_head_splits(b, hk, hq // hk, -(-skv // tk), sms)


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


def q_tiles(kv_tile: int, sq: int, skv: int, causal: bool, window: Optional[int],
            tq: int, tk: int) -> Tuple[int, int]:
    """[begin, end) of the query tiles that can see a key of KV tile
    ``kv_tile`` (< ceil(skv / tk)): the dK/dV kernel's block-skip, the mirror
    of ``kv_tiles``.  Query row i sits at position i + skv - sq; the rows
    that see some key of the tile are one interval (causal: at or past its
    first key; window: before its last key + window), and each of them holds
    a live pair with it."""
    q_offset = skv - sq
    k_lo = kv_tile * tk
    k_hi = min(k_lo + tk, skv) - 1
    lo, hi = 0, sq - 1
    if causal:
        lo = max(lo, k_lo - q_offset)
    if window is not None:
        hi = min(hi, k_hi + window - 1 - q_offset)
    if lo > hi:
        return 0, 0
    return lo // tq, hi // tq + 1


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


def choose_bwd_path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                    do: torch.Tensor) -> str:
    """``bwd_wgmma`` for bf16 with 16-byte rows in all five operands (D and
    the batch, sequence and head strides multiples of 8, pointers 16-byte
    aligned) whose grids fit; ``bwd_ffma`` for the rest: f32, whose 1e-4
    gradients a TF32 pass would miss, and bf16 that is not aligned so."""
    (b, sq, hq, d), skv = q.shape, k.shape[1]
    (tq, tk), (tq_dq, _) = bwd_tiles("bwd_wgmma", d)
    if (q.dtype == torch.bfloat16 and d % 8 == 0 and vector_rows(q, k, v, o, do)
            and b * hq * max(-(-sq // tq_dq), -(-skv // tk)) <= _INT32_MAX):
        return "bwd_wgmma"
    return "bwd_ffma"


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




def _strides(*tensors: torch.Tensor) -> ctypes.Array:
    """(batch, seq, head) strides of each tensor, in order, for a C entry."""
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _refuse_rows_without_keys(sq: int, skv: int, causal: bool) -> None:
    """Under the causal mask with Sq > Skv the first rows see no key; the
    forward's output there depends on its tiles, so no gradient goes
    through them (the model never routes such a row)."""
    if causal and sq > skv:
        raise ValueError(f"flash_attention: Sq {sq} > Skv {skv} under the causal mask leaves "
                         "rows with no live key; the kernel takes no gradient through them")


def _path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, path: Optional[str]) -> str:
    chosen = choose_path(q, k, v)
    if path is None:
        return chosen
    if path not in PATHS:
        raise ValueError(f"flash_attention: unknown path {path!r}, not one of {sorted(PATHS)}")
    if path == "wgmma" and chosen != "wgmma":
        raise ValueError("flash_attention: the wgmma path takes bfloat16 with 16-byte rows "
                         "(D and the batch, sequence and head strides multiples of 8)")
    return path


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        path: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): the forward launch ``FlashAttention`` makes, with each
    row's log-sum-exp ((B, Hq, Sq) f32, natural log; ``ref.attention_lse_ref``
    is its plain version).  CUDA tensors only."""
    _check(q, k, v, window)
    return _forward(q, k, v, causal, window, _path(q, k, v, path), with_lse=True)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
             window: Optional[int], path: str,
             with_lse: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One forward launch on ``path``: o, and each row's log-sum-exp
    ((B, Hq, Sq) f32) when ``with_lse``.  Without it the kernel gets a null
    pointer and stores none."""
    (b, sq, hq, d), (skv, hk) = q.shape, k.shape[1:3]
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if with_lse else None
    if o.numel() == 0:
        return o, lse
    strides = _strides(q, k, v, o)
    with torch.cuda.device(q.device):
        err = library().repro_flash_attention(
            PATHS[path], _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), b, sq, skv, hq, hk, d, strides,
            1.0 / math.sqrt(d), int(causal), 0 if window is None else int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    PATH_LAUNCHES[path] += 1
    return o, lse


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, *, causal: bool = True, window: Optional[int] = None,
    need_dq: bool = True, need_dkdv: bool = True, path: Optional[str] = None,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(dq, dk, dv) in q's dtype and the model's layout, from the forward's
    inputs, its output ``o`` and ``lse`` and the output's cotangent ``do``
    (any strides with a unit-stride head dimension).  Launches: delta =
    rowsum(dO * O) (on ``bwd_wgmma`` with q / sqrt(D) rounded once), then
    dK/dV (``need_dkdv``; on ``bwd_wgmma`` with a head split, one more
    launch sums the partials), then dQ (``need_dq``); what is not needed is
    None and not launched.  ``path`` forces one of ``BWD_PATHS`` (both
    compute the same function; tests hold each); it raises where that path
    does not take the operands.  CUDA tensors only: the plain version is
    ``ref.attention_bwd_ref``."""
    _check(q, k, v, window)
    (b, sq, hq, d), (skv, hk) = q.shape, k.shape[1:3]
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device or t.stride(-1) != 1:
            raise ValueError(f"flash_attention_bwd: {name} {tuple(t.shape)} {t.dtype} must be "
                             f"q's shape, dtype and device with a unit-stride head dimension")
    if (lse.shape != (b, hq, sq) or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} {lse.dtype} must be "
                         f"({b}, {hq}, {sq}) float32, contiguous, on {q.device}")
    chosen = choose_bwd_path(q, k, v, o, do)
    if path is None:
        path = chosen
    elif path not in BWD_PATHS:
        raise ValueError(f"flash_attention_bwd: unknown path {path!r}, not one of {BWD_PATHS}")
    elif path == "bwd_wgmma" and chosen != path:
        raise ValueError("flash_attention_bwd: the bwd_wgmma path takes bfloat16 with 16-byte "
                         "rows in q, k, v, o and do (D and the batch, sequence and head strides "
                         "multiples of 8)")
    _refuse_rows_without_keys(sq, skv, causal)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format) if need_dq else None
    dk = torch.empty_like(k, memory_format=torch.contiguous_format) if need_dkdv else None
    dv = torch.empty_like(v, memory_format=torch.contiguous_format) if need_dkdv else None
    if q.numel() == 0 or k.numel() == 0:
        return (None if dq is None else dq.zero_(), None if dk is None else dk.zero_(),
                None if dv is None else dv.zero_())
    launch = _bwd_wgmma if path == "bwd_wgmma" else _bwd_ffma
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        launch(library(), q, k, v, o, lse, do, delta, dq, dk, dv, int(causal),
               0 if window is None else int(window), 1.0 / math.sqrt(d),
               torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES["flash_attention_bwd"] += 1
    PATH_LAUNCHES[path] += 1
    return dq, dk, dv


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd {what} launch failed: CUDA error {err}")


def _bwd_ffma(lib, q, k, v, o, lse, do, delta, dq, dk, dv, causal, win, scale, stream) -> None:
    """The ``bwd_ffma`` launches: delta, dK/dV (dk not None), dQ (dq not None)."""
    (b, sq, hq, d), (skv, hk) = q.shape, k.shape[1:3]
    dtype = _DTYPES[q.dtype]
    _raise_on(lib.repro_flash_attention_bwd_preprocess(
        dtype, o.data_ptr(), do.data_ptr(), delta.data_ptr(), b, sq, hq, d, _strides(o, do),
        stream), "preprocess")
    BWD_LAUNCHES["preprocess"] += 1
    if dk is not None:
        _raise_on(lib.repro_flash_attention_bwd_dkdv(
            dtype, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, skv, hq, hk, d,
            _strides(q, k, v, do, dk, dv), scale, causal, win, stream), "dK/dV")
        BWD_LAUNCHES["dkdv"] += 1
    if dq is not None:
        _raise_on(lib.repro_flash_attention_bwd_dq(
            dtype, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), b, sq, skv, hq, hk, d, _strides(q, k, v, do, dq),
            scale, causal, win, stream), "dQ")
        BWD_LAUNCHES["dq"] += 1


def _bwd_wgmma(lib, q, k, v, o, lse, do, delta, dq, dk, dv, causal, win, scale, stream) -> None:
    """The ``bwd_wgmma`` launches: delta and q^ = bf16(q / sqrt(D)) into a
    (B, Hq, Sq, D) workspace, dK/dV (dk not None; with a head split, into an
    f32 workspace whose partials one more launch sums), dQ (dq not None)."""
    (b, sq, hq, d), (skv, hk) = q.shape, k.shape[1:3]
    qh = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    _raise_on(lib.repro_flash_attention_bwd_wgmma_preprocess(
        q.data_ptr(), o.data_ptr(), do.data_ptr(), delta.data_ptr(), qh.data_ptr(), b, sq, hq, d,
        _strides(q, o, do), scale, stream), "preprocess")
    BWD_LAUNCHES["preprocess"] += 1
    if dk is not None:
        splits, per = bwd_splits(q, k)
        ws = (torch.empty((2 * splits, b, skv, hk, d), dtype=torch.float32, device=q.device)
              if splits > 1 else None)
        _raise_on(lib.repro_flash_attention_bwd_wgmma_dkdv(
            qh.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), None if ws is None else ws.data_ptr(),
            b, sq, skv, hq, hk, d, splits, per, _strides(k, v, do, dk, dv), causal, win, stream),
            "dK/dV")
        BWD_LAUNCHES["dkdv"] += 1
        if ws is not None:
            _raise_on(lib.repro_flash_attention_bwd_split_reduce(
                ws.data_ptr(), dk.data_ptr(), dv.data_ptr(), splits, b, skv, hk, d,
                _strides(dk, dv), stream), "split reduce")
            BWD_LAUNCHES["reduce"] += 1
    if dq is not None:
        _raise_on(lib.repro_flash_attention_bwd_wgmma_dq(
            qh.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), b, sq, skv, hq, hk, d, _strides(k, v, do, dq), scale,
            causal, win, stream), "dQ")
        BWD_LAUNCHES["dq"] += 1


class FlashAttention(torch.autograd.Function):
    """The flash kernel with its gradient (the reference's custom VJP,
    ``repro/kernels/flash_attention/ops.py:18-46``, whose backward is the
    vjp of ``attention_chunked``; here a kernel).  The forward saves q, k,
    v, o and each row's log-sum-exp; under remat it runs again in the
    backward's recompute, and each run is a forward launch.  The backward
    takes the path ``choose_bwd_path`` picks."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, path):
        o, lse = _forward(q, k, v, causal, window, path, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:    # e.g. an expanded zero cotangent: the one copy of dO
            do = do.contiguous()
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal=ctx.causal,
                                         window=ctx.window, need_dq=need_q,
                                         need_dkdv=need_k or need_v)
        return dq, dk if need_k else None, dv if need_v else None, None, None, None


def _summed(t):
    """``t`` with each pending partial sum reduced: onto the batch dim
    (``Shard(0)``, a reduce-scatter) where no other mesh dim splits the
    batch and the batch divides, else replicated.  DTensor's sharding
    propagation may leave a projection's output partial over a mesh dim
    whose contraction it split (torch 2.11 left qwen's q partial over
    "data" in a train step's forward); attention needs whole scores."""
    from torch.distributed.tensor import Replicate, Shard

    placements = list(t.placements)
    if not any(p.is_partial() for p in placements):
        return t
    for i, p in enumerate(placements):
        if p.is_partial():
            free = not any(o.is_shard(0) for o in placements)
            placements[i] = (Shard(0) if free and t.shape[0] % t.device_mesh.size(i) == 0
                             else Replicate())
    return t.redistribute(t.device_mesh, placements)


def _on_local_shards(q, k, v, *, causal: bool, window: Optional[int],
                     path: Optional[str]):
    """Flash of DTensor q, k, v on each rank's local shards: batch over
    the batch axes and heads over "model" split attention into independent
    pieces, so each rank runs ``flash_attention`` (the kernel on the card,
    forward and backward) on its ``to_local()`` shards, differentiably, and
    the output comes back with q's placements.  No head is gathered.  q, k
    and v sharded on the sequence or on the head dim (the GQA fallback's
    ``rules["head"]``), or placed unlike each other, are ROADMAP queue 1
    row 9b-v."""
    from torch.distributed.tensor import DTensor

    if not all(isinstance(t, DTensor) for t in (q, k, v)):
        raise TypeError("flash_attention got DTensor and plain operands together: "
                        "distribute every operand")
    q, k, v = (_summed(t) for t in (q, k, v))
    placements = tuple(q.placements)
    for name, t in (("k", k), ("v", v)):
        if tuple(t.placements) != placements or t.device_mesh != q.device_mesh:
            raise NotImplementedError(
                f"flash_attention on DTensors placed {placements} for q and "
                f"{tuple(t.placements)} for {name}: ROADMAP queue 1 row 9b-v")
    for p in placements:
        if p.is_shard() and p.dim % q.dim() not in (0, 2):
            raise NotImplementedError(
                f"flash_attention on q placed {placements} (sequence or head dim): "
                f"ROADMAP queue 1 row 9b-v")
    o = flash_attention(q.to_local(), k.to_local(), v.to_local(), causal=causal,
                        window=window, path=path)
    return DTensor.from_local(o, q.device_mesh, placements, run_check=False)


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
    of ``PATHS`` for the forward on the card (every path computes the same
    function; tests hold each); it raises where that path does not take the
    operands.  Under grad a CUDA call goes through ``FlashAttention``;
    otherwise it is one forward launch that stores no log-sum-exp.  DTensor
    operands run on each rank's local shards (``_on_local_shards``)."""
    del q_positions, kv_positions  # contiguous positions assumed, as the reference does
    if is_dtensor(q, k, v):
        return _on_local_shards(q, k, v, causal=causal, window=window, path=path)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    _check(q, k, v, window)
    path = _path(q, k, v, path)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        _refuse_rows_without_keys(q.shape[1], k.shape[1], causal)
        return FlashAttention.apply(q, k, v, causal, window, path)
    return _forward(q, k, v, causal, window, path, with_lse=False)[0]
