"""Grouped matmul with its gradient: the Hopper kernels and their dispatch.

``grouped_matmul(x, w, group_sizes)`` computes ``y[m] = x[m] @ w[g(m)]``
for rows pre-sorted by group, as ``repro.kernels.grouped_matmul.ops`` does
with ``impl="pallas"``.  The tensor's device picks the implementation:

* a CUDA tensor launches the kernels of ``csrc/grouped_matmul.cu`` — the
  forward and ``dx = gmm(dy, wᵀ)`` on ``gmm``, ``dw`` on ``tgmm`` — or
  raises; nothing falls back to the plain version;
* a CPU tensor takes the plain versions in ``ref.py``.

``gmm`` has three paths, picked by ``choose_path`` from M, K, N, G and the
dtype alone: ``stream`` (a few rows a group: one block per group and
64-column slab streams the slab once), ``wgmma`` (bf16 tiles on the
tensor cores) and ``ffma`` / ``ffma_wide`` (f32 tiles, and bf16 rows that
are no 16-byte multiple).  The tiled paths give every block one (part, row
tile, column tile): ``row_bounds`` and ``tile_prefix`` are that schedule,
computed with torch ops on the tensor's device, and ``grid`` is its upper
bound on the host.  ``tgmm`` has two paths, picked by ``choose_tgmm_path``
from K, N, the dtype and alignment alone: ``wgmma`` (bf16 with 16-byte
rows, on the tensor cores) and ``ffma`` (f32, and the rest of bf16); it
reads the same ``row_bounds``, which the autograd Function builds once in
the forward for the backward's ``gmm`` and ``tgmm``.  ``LAUNCHES`` counts
kernel launches per kernel (one a wrapper call) and ``TGMM_PATH_LAUNCHES``
``tgmm``'s by path, so a run can show that its path went through the
kernels.  The wrappers never read group sizes on the host.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import load_library
from repro_torch.kernels.grouped_matmul import ref

SOURCES = (Path(__file__).resolve().parent / "csrc" / "grouped_matmul.cu",)

#: kernel launches so far, by kernel; callers reset entries to 0 to count a run
LAUNCHES = {"gmm": 0, "tgmm": 0}
#: the same ``tgmm`` launches, by path
TGMM_PATH_LAUNCHES = {"ffma": 0, "wgmma": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: gmm's paths: (code of the C entry, rows, columns) of a block's tile; a
#: ``stream`` block owns a whole group and 64 columns, 8 rows a pass
PATHS = {"stream": (0, 8, 64), "ffma": (1, 32, 32), "ffma_wide": (2, 128, 128),
         "wgmma": (3, 128, 256)}
#: tgmm's paths: (code of the C entry, the (K rows, N columns) tiles a block
#: may own, by tile code); ``tgmm_tile`` picks one from the shapes
TGMM_PATHS = {"ffma": (0, ((64, 64), (32, 64), (32, 32))),
              "wgmma": (1, ((128, 128), (128, 256)))}
_SMS = 132          # an H100's SMs: ffma_wide once its grid has 4 blocks an SM
_MAX_GRID_YZ = 65535
_INT32_MAX = 2 ** 31 - 1

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def library() -> ctypes.CDLL:
    """Build (first call only) and load the kernels' library."""
    lib = load_library("grouped_matmul", SOURCES)
    lib.repro_gmm.argtypes = [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _LL, _P]
    lib.repro_gmm.restype = _I
    lib.repro_gmm_tile.argtypes = [_I, _I]
    lib.repro_gmm_tile.restype = _I
    lib.repro_tgmm.argtypes = [_I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P]
    lib.repro_tgmm.restype = _I
    lib.repro_tgmm_tile.argtypes = [_I, _I, _I]
    lib.repro_tgmm_tile.restype = _I
    for name, (code, tm, tn) in PATHS.items():
        if (lib.repro_gmm_tile(code, 0), lib.repro_gmm_tile(code, 1)) != (tm, tn):
            raise RuntimeError(f"gmm path {name}: the kernel's tile differs from ({tm}, {tn})")
    for name, (code, tiles) in TGMM_PATHS.items():
        for i, tile in enumerate(tiles):
            if (lib.repro_tgmm_tile(code, i, 0), lib.repro_tgmm_tile(code, i, 1)) != tile:
                raise RuntimeError(f"tgmm path {name}: the kernel's tile {i} differs from {tile}")
    return lib


def choose_path(m: int, k: int, n: int, g: int, dtype: torch.dtype,
                vectors: bool = True) -> str:
    """The path for an (m, k) x (g, k, n) product.  ``vectors``: the operands'
    rows start on 16-byte boundaries (``_vector_rows``); without it, and
    where K or N is no multiple of 8, only the ffma paths take them."""
    vectors = vectors and k % 8 == 0 and n % 8 == 0
    if vectors and m <= 4 * g:
        return "stream"
    if vectors and dtype == torch.bfloat16:
        return "wgmma"
    cols, rows = grid("ffma_wide", m, n, g)
    return "ffma_wide" if cols * rows >= 4 * _SMS else "ffma"


def grid(path: str, m: int, n: int, g: int) -> Tuple[int, int]:
    """(columns, rows) of the launch grid: an upper bound of the blocks that
    own a tile for any split of m rows over g groups."""
    _, tm, tn = PATHS[path]
    if path == "stream":
        return -(-n // tn), g + 1
    return -(-n // tn), -(-m // tm) + g


def choose_tgmm_path(m: int, k: int, n: int, g: int, dtype: torch.dtype,
                     vectors: bool = True) -> str:
    """``tgmm``'s path for (m, k) x (m, n) over g groups: ``wgmma`` for bf16
    whose rows are 16-byte multiples (``vectors``: x's and dy's bases are
    16-byte aligned; K and N multiples of 8), else ``ffma``.  Shapes, dtype
    and alignment alone: never a group size."""
    del m, g   # every split of any m rows takes the same path
    if vectors and dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0:
        return "wgmma"
    return "ffma"


def tgmm_tile(path: str, k: int, n: int, g: int) -> int:
    """The code of ``path``'s tile for dw (g, k, n): ``wgmma`` 128 x 256
    where N > 128 (one block an SM, the wider product), else 128 x 128;
    ``ffma`` the largest tile whose grid has eight blocks for every SM, else
    the smallest.  A block's work is its group's rows, so many small blocks
    even out ragged groups (at 784 → 128, 32 × 64 beat 64 × 64 by 5 %)."""
    tiles = TGMM_PATHS[path][1]
    if path == "wgmma":
        return 1 if n > 128 else 0
    for i, (tk, tn) in enumerate(tiles):
        if g * -(-k // tk) * -(-n // tn) >= 8 * _SMS:
            return i
    return len(tiles) - 1


def tgmm_grid(path: str, k: int, n: int, g: int) -> Tuple[int, int, int]:
    """(N tiles, K tiles, g) of ``tgmm``'s launch: block (x, y, z) owns
    dw[z, y TK: (y + 1) TK, x TN: (x + 1) TN], whatever the split."""
    tk, tn = TGMM_PATHS[path][1][tgmm_tile(path, k, n, g)]
    return -(-n // tn), -(-k // tk), g


def tgmm_copy_bytes(k: int, n: int, esize: int, *ptrs: int) -> int:
    """Bytes of each of the ``ffma`` path's cp.async copies: the widest of
    16, 8, 4 (and 2, for bf16) that divides x's and dy's rows (k, n
    elements of esize bytes) and every base address in ``ptrs``."""
    for b in (16, 8, 4, 2):
        if b >= esize and (k * esize) % b == 0 and (n * esize) % b == 0 \
                and all(p % b == 0 for p in ptrs):
            return b
    raise ValueError(f"tgmm: no copy width fits rows of {k} and {n} {esize}-byte elements")


def row_bounds(group_sizes: torch.Tensor, m: int) -> torch.Tensor:
    """int32 (G + 2,): [0, end of group 0, .., end of group G-1, m], clamped
    to [0, m]; part G, the rows past the groups, is written as zeros."""
    ends = F.pad(group_sizes.to(torch.int32), (1, 1)).cumsum(0, dtype=torch.int32)
    ends[-1:].fill_(m)
    return ends.clamp_(0, m)


def tile_prefix(bounds: torch.Tensor, tm: int) -> torch.Tensor:
    """int32 (G + 2,): [0, running count of the parts' tm-row tiles]; part p
    owns grid rows prefix[p] .. prefix[p + 1] - 1."""
    tiles = bounds.diff().clamp_(min=0).add_(tm - 1).div_(tm, rounding_mode="floor")
    return F.pad(tiles.cumsum(0, dtype=torch.int32), (1, 0))


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


def _check_sizes(group_sizes: torch.Tensor, num_groups: int) -> None:
    if group_sizes.dim() != 1 or group_sizes.shape[0] != num_groups:
        raise ValueError(f"group_sizes must be ({num_groups},), got {tuple(group_sizes.shape)}")
    if group_sizes.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"group_sizes must be int32 or int64, got {group_sizes.dtype}")


def _check_bounds(bounds: torch.Tensor, num_groups: int, dev: torch.device) -> None:
    if bounds.shape != (num_groups + 2,) or bounds.dtype != torch.int32 or bounds.device != dev:
        raise ValueError(f"bounds must be int32 ({num_groups + 2},) on {dev} (row_bounds), got "
                         f"{bounds.dtype} {tuple(bounds.shape)} on {bounds.device}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _vector_rows(x: torch.Tensor, w: torch.Tensor) -> bool:
    """16-byte copies can read x's rows and w's slabs: aligned starts and a
    non-unit stride of w that keeps them aligned (K, N % 8 is the path's)."""
    e = 16 // x.element_size()
    s_g, s_k, s_n = w.stride()
    return (x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0 and s_g % e == 0
            and (s_k if s_n == 1 else s_n) % e == 0)


def launch_gmm(path: str, x: torch.Tensor, w: torch.Tensor, bounds: torch.Tensor,
               prefix: Optional[torch.Tensor], y: torch.Tensor) -> None:
    """One launch of ``path`` on a schedule already made (``gmm`` makes it;
    timings call this to keep the schedule's own launches out)."""
    (m, k), (g, _, n) = x.shape, w.shape
    with torch.cuda.device(x.device):
        err = library().repro_gmm(
            PATHS[path][0], _DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), bounds.data_ptr(),
            0 if prefix is None else prefix.data_ptr(), y.data_ptr(), m, k, n, g, *w.stride(),
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "gmm")


def gmm(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
        path: Optional[str] = None, bounds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(M, K) rows sorted by group x (G, K, N) -> (M, N) in x.dtype.

    ``w`` is (G, K, N) with unit stride along N, or a view with unit stride
    along K (the backward passes ``wᵀ`` in place).  ``path`` forces one of
    ``PATHS`` (every path computes the same function; tests hold each).
    ``bounds``: ``row_bounds(group_sizes, M)`` made already (the autograd
    Function shares the forward's with the backward)."""
    if x.device.type == "cpu":
        return ref.grouped_matmul_ref(x, w, group_sizes)
    _check_cuda("gmm", x, w, group_sizes)
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"gmm: shapes {tuple(x.shape)} x {tuple(w.shape)}")
    _check_operand("gmm x", x, x.dtype)
    _check_operand("gmm w", w, x.dtype)
    if not x.is_contiguous():
        raise ValueError("gmm: x must be contiguous")
    if w.stride(2) != 1 and w.stride(1) != 1:
        raise ValueError(f"gmm: w needs unit stride along K or N, got strides {w.stride()}")
    (m, k), (g, _, n) = x.shape, w.shape
    _check_sizes(group_sizes, g)
    if bounds is not None:
        _check_bounds(bounds, g, x.device)
    vectors = _vector_rows(x, w)
    if path is None:
        path = choose_path(m, k, n, g, x.dtype, vectors)
    elif path not in PATHS:
        raise ValueError(f"gmm: unknown path {path!r}, not one of {sorted(PATHS)}")
    elif path in ("stream", "wgmma") and not (vectors and k % 8 == 0 and n % 8 == 0):
        raise ValueError(f"gmm: the {path} path needs 16-byte rows (K, N multiples of 8)")
    elif path == "wgmma" and x.dtype != torch.bfloat16:
        raise ValueError("gmm: the wgmma path takes bfloat16")
    if grid(path, m, n, g)[1] > _MAX_GRID_YZ:
        raise ValueError(f"gmm: {m} rows in {g} groups exceed the kernel's grid")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    if bounds is None:
        bounds = row_bounds(group_sizes, m)
    prefix = None if path == "stream" else tile_prefix(bounds, PATHS[path][1])
    launch_gmm(path, x, w, bounds, prefix, y)
    LAUNCHES["gmm"] += 1
    return y


def launch_tgmm(path: str, x: torch.Tensor, dy: torch.Tensor, bounds: torch.Tensor,
                dw: torch.Tensor) -> None:
    """One launch of ``path`` on bounds already made (``tgmm`` checks the
    operands; timings call this to keep the schedule's launches out)."""
    (k, n), g = dw.shape[1:], dw.shape[0]
    vbytes = tgmm_copy_bytes(k, n, x.element_size(), x.data_ptr(), dy.data_ptr())
    with torch.cuda.device(x.device):
        err = library().repro_tgmm(
            TGMM_PATHS[path][0], tgmm_tile(path, k, n, g), _DTYPES[x.dtype], vbytes,
            x.data_ptr(), dy.data_ptr(), bounds.data_ptr(), dw.data_ptr(), k, n, g,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "tgmm")


def tgmm(x: torch.Tensor, dy: torch.Tensor, group_sizes: torch.Tensor, num_groups: int,
         path: Optional[str] = None, bounds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(M, K) x (M, N), rows sorted by group -> dw (G, K, N) in x.dtype.

    ``path`` forces one of ``TGMM_PATHS`` (tests hold each); ``bounds`` is
    ``row_bounds(group_sizes, M)`` made already, as for ``gmm``."""
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
    _check_sizes(group_sizes, num_groups)
    if bounds is not None:
        _check_bounds(bounds, num_groups, x.device)
    vectors = x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
    if path is None:
        path = choose_tgmm_path(m, k, n, num_groups, x.dtype, vectors)
    elif path not in TGMM_PATHS:
        raise ValueError(f"tgmm: unknown path {path!r}, not one of {sorted(TGMM_PATHS)}")
    elif path == "wgmma" and choose_tgmm_path(m, k, n, num_groups, x.dtype, vectors) != path:
        raise ValueError("tgmm: the wgmma path takes bfloat16 with 16-byte rows "
                         "(K, N multiples of 8)")
    if num_groups > _MAX_GRID_YZ or max(tgmm_grid(path, k, n, num_groups)[:2]) > _MAX_GRID_YZ:
        raise ValueError(f"tgmm: {num_groups} groups of ({k}, {n}) exceed the kernel's grid")
    dw = torch.empty((num_groups, k, n), dtype=x.dtype, device=x.device)
    if dw.numel() == 0:
        return dw
    if bounds is None:
        bounds = row_bounds(group_sizes, m)
    launch_tgmm(path, x, dy, bounds, dw)
    LAUNCHES["tgmm"] += 1
    TGMM_PATH_LAUNCHES[path] += 1
    return dw


class GroupedMatmul(torch.autograd.Function):
    """``gmm`` with its gradient: ``dx = gmm(dy, wᵀ)``, ``dw = tgmm(x, dy)``
    (the reference's custom VJP, ``repro/kernels/grouped_matmul/ops.py:45``).
    On the card the forward's ``row_bounds`` serve all three products."""

    @staticmethod
    def forward(ctx, x, w, group_sizes):
        bounds = row_bounds(group_sizes, x.shape[0]) if x.device.type == "cuda" else None
        ctx.save_for_backward(x, w, group_sizes, bounds)
        return gmm(x, w, group_sizes, bounds=bounds)

    @staticmethod
    def backward(ctx, dy):
        x, w, gs, bounds = ctx.saved_tensors
        dy = dy.contiguous()
        dx = gmm(dy, w.transpose(1, 2), gs, bounds=bounds) if ctx.needs_input_grad[0] else None
        dw = tgmm(x, dy, gs, w.shape[0], bounds=bounds) if ctx.needs_input_grad[1] else None
        return dx, dw, None


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """y[m] = x[m] @ w[g(m)] with rows pre-sorted by group; differentiable.
    Mixed input dtypes are promoted first, as jnp.dot promotes them."""
    dtype = torch.promote_types(x.dtype, w.dtype)
    return GroupedMatmul.apply(x.to(dtype), w.to(dtype), group_sizes)
