"""The grouped-matmul kernel's tile schedule, on the CPU.

``gmm`` gives every block of its grid one (part, row tile within the part,
column tile), where the parts are the G groups and, last, the rows past
them.  The wrapper computes the schedule with torch ops on the tensor's
device (``row_bounds``, ``tile_prefix``) and sizes the grid on the host
(``grid``); a block finds its part as the largest p with
``prefix[p] <= row of the grid``.  These tests decode every grid row the
same way and check that, for any split, every (part, row tile, column tile)
appears exactly once below the bound and every row is covered once.
"""
import pytest
import torch

from repro_torch.kernels.grouped_matmul import ops

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - dev extra not installed
    from _hypothesis_fallback import given, settings, strategies as st

TILED = [p for p in ops.PATHS if p != "stream"]


def _schedule(sizes, m, path):
    gs = torch.tensor(sizes, dtype=torch.int32)
    bounds = ops.row_bounds(gs, m)
    prefix = ops.tile_prefix(bounds, ops.PATHS[path][1])
    return bounds, prefix


def _check_tiled(sizes, m, n, path):
    """Every (part, row tile, column tile) exactly once below the bound."""
    g = len(sizes)
    _, tm, tn = ops.PATHS[path]
    bounds, prefix = _schedule(sizes, m, path)
    cols, rows = ops.grid(path, m, n, g)
    assert bounds.dtype == prefix.dtype == torch.int32
    assert bounds.shape == prefix.shape == (g + 2,)
    assert int(bounds[0]) == 0 and int(bounds[-1]) == m
    assert int(prefix[-1]) <= rows
    assert (cols - 1) * tn < n <= cols * tn
    slots = torch.arange(rows, dtype=torch.int32)
    live = slots < prefix[-1]
    part = (torch.searchsorted(prefix, slots, right=True) - 1).clamp(max=g)
    seen, covered = set(), torch.zeros(m, dtype=torch.int64)
    for slot, p, ok in zip(slots.tolist(), part.tolist(), live.tolist()):
        if not ok:                       # past the last tile: the block exits
            continue
        tile = slot - int(prefix[p])
        r0 = int(bounds[p]) + tile * tm
        r1 = min(r0 + tm, int(bounds[p + 1]))
        assert int(bounds[p]) <= r0 < r1 <= int(bounds[p + 1]), (slot, p)
        covered[r0:r1] += 1
        for c in range(cols):
            assert (p, tile, c) not in seen
            seen.add((p, tile, c))
    assert bool((covered == 1).all())
    want = {(p, t, c) for p in range(g + 1)
            for t in range(-(-int(bounds[p + 1] - bounds[p]) // tm)) for c in range(cols)}
    assert seen == want


def _check_stream(sizes, m, n):
    """One block per (part, 64-column slab); every row of a part in passes."""
    g = len(sizes)
    _, tm, tn = ops.PATHS["stream"]
    bounds = ops.row_bounds(torch.tensor(sizes, dtype=torch.int32), m)
    cols, rows = ops.grid("stream", m, n, g)
    assert rows == g + 1 and (cols - 1) * tn < n <= cols * tn
    covered = torch.zeros(m, dtype=torch.int64)
    for p in range(rows):
        for r0 in range(int(bounds[p]), int(bounds[p + 1]), tm):
            covered[r0:min(r0 + tm, int(bounds[p + 1]))] += 1
    assert bool((covered == 1).all())


SPLITS = {
    "empty groups": ([0, 50, 0, 70, 0, 0, 13], 0),
    "groups of one row": ([1] * 40, 0),
    "one group holds every row": ([0, 0, 700, 0], 0),
    "rows past the last group": ([17, 0, 45, 61, 3], 5),
    "every group empty, rows past them": ([0] * 8, 300),
    "at and one past tile edges": ([128, 129, 127, 32, 33, 8, 9, 64, 65, 0, 1], 3),
    "G = 1": ([130], 0),
    "G = 384, a 32-row decode split": ([1 if i % 12 == 0 else 0 for i in range(384)], 0),
}


@pytest.mark.parametrize("path", TILED)
@pytest.mark.parametrize("name", list(SPLITS))
def test_named_splits_tile_every_row_once(name, path):
    sizes, tail = SPLITS[name]
    m = sum(sizes) + tail
    for n in (62, 128, 320):
        _check_tiled(sizes, m, n, path)
    _check_stream(sizes, m, 320)


@settings(max_examples=60, deadline=None)
@given(sizes=st.lists(st.integers(0, 300), min_size=1, max_size=384),
       tail=st.integers(0, 140), n=st.integers(1, 700), path=st.sampled_from(TILED))
def test_any_split_tiles_every_row_once_below_the_bound(sizes, tail, n, path):
    m = sum(sizes) + tail
    _check_tiled(sizes, m, n, path)
    _check_stream(sizes, m, n)


@settings(max_examples=60, deadline=None)
@given(sizes=st.lists(st.integers(0, 9), min_size=1, max_size=384), n=st.integers(1, 300))
def test_decode_splits_of_few_rows(sizes, n):
    m = sum(sizes)
    for path in TILED:
        _check_tiled(sizes, m, n, path)
    _check_stream(sizes, m, n)


def test_split_past_m_is_clamped():
    """Group sizes that sum past M end at M, as the plain version's do."""
    bounds, prefix = _schedule([5, 9, 4], 8, "ffma")
    assert bounds.tolist() == [0, 5, 8, 8, 8]
    assert prefix.tolist() == [0, 1, 2, 2, 2]


@settings(max_examples=40, deadline=None)
@given(m=st.integers(0, 5000), g=st.integers(1, 384), n=st.integers(1, 4096),
       path=st.sampled_from(list(ops.PATHS)))
def test_bound_depends_on_m_n_g_alone(m, g, n, path):
    """The grid is a function of (M, N, G): the host never sees the split,
    and for the tiled paths it is ceil(M / TM) + G rows of ceil(N / TN)."""
    _, tm, tn = ops.PATHS[path]
    cols, rows = ops.grid(path, m, n, g)
    assert cols == -(-n // tn)
    assert rows == (g + 1 if path == "stream" else -(-m // tm) + g)
    if path == "stream":
        return
    # the worst split, G + 1 parts of TM + 1 rows, owns ceil(M / TM) + G -
    # ceil((G + 1) / TM) + 1 tiles: the bound itself while G + 1 <= TM
    m_worst = (g + 1) * (tm + 1)
    _, prefix = _schedule([tm + 1] * g, m_worst, path)
    bound = ops.grid(path, m_worst, n, g)[1]
    assert int(prefix[-1]) == bound - (-(-(g + 1) // tm)) + 1 <= bound


@pytest.mark.parametrize("shape,dtype,want", [
    ((32, 2048, 1024, 64), torch.bfloat16, "stream"),      # olmoe decode, gate/up
    ((32, 1024, 2048, 64), torch.float32, "stream"),       # olmoe decode, down, f32
    ((65536, 2048, 1024, 64), torch.bfloat16, "wgmma"),    # olmoe prefill
    ((65536, 2048, 1024, 64), torch.float32, "ffma_wide"),
    ((1283, 784, 128, 32), torch.float32, "ffma"),         # a FEMNIST wave
    ((1283, 784, 128, 32), torch.bfloat16, "wgmma"),
    ((1283, 128, 62, 32), torch.bfloat16, "ffma"),         # N = 62: no 16-byte rows
    ((40, 62, 128, 16), torch.float32, "ffma"),            # K = 62 (a backward's dx)
])
def test_path_is_chosen_from_shapes_and_dtype(shape, dtype, want):
    assert ops.choose_path(*shape, dtype) == want
    assert ops.choose_path(*shape, dtype, vectors=False) in ("ffma", "ffma_wide")


def test_cpu_tensors_take_the_plain_version_on_any_path():
    x, w = torch.randn(20, 16), torch.randn(3, 16, 8)
    gs = torch.tensor([5, 0, 12], dtype=torch.int32)
    want = ops.ref.grouped_matmul_ref(x, w, gs)
    for path in ops.PATHS:
        torch.testing.assert_close(ops.gmm(x, w, gs, path=path), want)
    assert not ops.gmm(x, w, gs)[17:].any()


# ---------------------------------------------------------------- tgmm
#
# ``tgmm`` gives every block of its grid (N tiles, K tiles, G) one tile of one
# group's dw and the group's rows [bounds[g], bounds[g + 1]); the grid and the
# path come from the shapes, dtype and alignment alone.

@pytest.mark.parametrize("shape,dtype,want", [
    ((1283, 784, 128, 32), torch.float32, "ffma"),      # the FEMNIST wave's layers, f32
    ((1283, 128, 128, 32), torch.float32, "ffma"),
    ((1283, 128, 62, 32), torch.float32, "ffma"),
    ((1283, 784, 128, 32), torch.bfloat16, "wgmma"),    # bf16 with 16-byte rows
    ((1283, 128, 128, 32), torch.bfloat16, "wgmma"),
    ((1283, 128, 62, 32), torch.bfloat16, "ffma"),      # N = 62: 124-byte rows
    ((65536, 2048, 1024, 64), torch.bfloat16, "wgmma"),  # olmoe's prefill, both products
    ((65536, 1024, 2048, 64), torch.bfloat16, "wgmma"),
    ((65536, 2048, 1024, 64), torch.float32, "ffma"),
    ((32, 2048, 1024, 64), torch.bfloat16, "wgmma"),     # olmoe's decode split
])
def test_tgmm_path_is_chosen_from_shapes_dtype_and_alignment(shape, dtype, want):
    assert ops.choose_tgmm_path(*shape, dtype) == want
    assert ops.choose_tgmm_path(*shape, dtype, vectors=False) == "ffma"
    m, k, n, g = shape
    for other_m in (0, 1, 7 * m + 3):       # never the rows or their split
        assert ops.choose_tgmm_path(other_m, k, n, g, dtype) == want


@pytest.mark.parametrize("path,k,n,g,tile,blocks", [
    ("ffma", 784, 128, 32, (32, 64), 1600),   # 64 x 64 gives 832 blocks, < 8 an SM
    ("ffma", 128, 128, 32, (32, 32), 512),    # 128 and 256 blocks would leave SMs idle
    ("ffma", 128, 62, 32, (32, 32), 256),     # the smallest tile, the most blocks
    ("ffma", 2048, 1024, 64, (64, 64), 32768),  # olmoe's shape in f32
    ("wgmma", 784, 128, 32, (128, 128), 224),
    ("wgmma", 2048, 1024, 64, (128, 256), 4096),
    ("wgmma", 1024, 2048, 64, (128, 256), 4096),
    ("wgmma", 784, 136, 4, (128, 256), 28),
])
def test_tgmm_tile_puts_enough_blocks_on_every_sm(path, k, n, g, tile, blocks):
    tk, tn = ops.TGMM_PATHS[path][1][ops.tgmm_tile(path, k, n, g)]
    assert (tk, tn) == tile
    nx, ny, nz = ops.tgmm_grid(path, k, n, g)
    assert (nx, ny, nz) == (-(-n // tn), -(-k // tk), g) and nx * ny * nz == blocks


@pytest.mark.parametrize("k,n,esize,ptrs,want", [
    (784, 128, 4, (0, 256), 16),     # f32 784 -> 128: 16-byte copies
    (128, 62, 4, (0, 512), 8),       # f32 128 -> 62: 248-byte rows, 8-byte copies
    (128, 62, 2, (0, 512), 4),       # bf16 128 -> 62: 124-byte rows
    (128, 61, 2, (0, 512), 2),       # bf16 of odd length: two bytes, no cp.async
    (784, 128, 4, (4, 0), 4),        # a base one f32 off 16 bytes
    (784, 128, 2, (0, 6), 2),
])
def test_tgmm_copy_width_divides_rows_and_bases(k, n, esize, ptrs, want):
    assert ops.tgmm_copy_bytes(k, n, esize, *ptrs) == want


def _check_tgmm_grid(sizes, tail, k, n, path):
    """Every (g, K tile, N tile) of dw is owned by exactly one block, the
    tiles cover dw once, and a block's rows are its group's rows."""
    g = len(sizes)
    m = sum(sizes) + tail
    bounds = ops.row_bounds(torch.tensor(sizes, dtype=torch.int32), m)
    tk, tn = ops.TGMM_PATHS[path][1][ops.tgmm_tile(path, k, n, g)]
    nx, ny, nz = ops.tgmm_grid(path, k, n, g)
    assert nz == g and (nx - 1) * tn < n <= nx * tn and (ny - 1) * tk < k <= ny * tk
    covered = torch.zeros((g, k, n), dtype=torch.int64)
    rows = torch.zeros(m, dtype=torch.int64)
    seen = set()
    for bz in range(nz):
        start, end = int(bounds[bz]), max(int(bounds[bz + 1]), int(bounds[bz]))
        assert end - start == min(sizes[bz], max(m - sum(sizes[:bz]), 0))
        rows[start:end] += 1
        for by in range(ny):
            for bx in range(nx):
                assert (bz, by, bx) not in seen
                seen.add((bz, by, bx))
                covered[bz, by * tk:(by + 1) * tk, bx * tn:(bx + 1) * tn] += 1
    assert bool((covered == 1).all())
    assert bool((rows[:sum(sizes)] == 1).all()) and not rows[sum(sizes):].any()


@settings(max_examples=40, deadline=None)
@given(sizes=st.lists(st.integers(0, 300), min_size=1, max_size=40),
       tail=st.integers(0, 140), k=st.integers(1, 800), n=st.integers(1, 300),
       path=st.sampled_from(list(ops.TGMM_PATHS)))
def test_tgmm_grid_owns_every_tile_once_for_any_split(sizes, tail, k, n, path):
    _check_tgmm_grid(sizes, tail, k, n, path)


@pytest.mark.parametrize("name", list(SPLITS))
def test_tgmm_grid_at_named_splits(name):
    sizes, tail = SPLITS[name]
    for path, k, n in (("ffma", 784, 62), ("ffma", 128, 128), ("wgmma", 136, 320)):
        _check_tgmm_grid(sizes, tail, k, n, path)


def test_cpu_tensors_take_tgmm_ref_on_any_path():
    x, dy = torch.randn(20, 16), torch.randn(20, 8)
    gs = torch.tensor([5, 0, 12], dtype=torch.int32)
    want = ops.ref.tgmm_ref(x, dy, gs, 3)
    assert not want[1].any()
    before = dict(ops.TGMM_PATH_LAUNCHES)
    for path in (None, *ops.TGMM_PATHS):
        torch.testing.assert_close(ops.tgmm(x, dy, gs, 3, path=path), want)
        torch.testing.assert_close(
            ops.tgmm(x, dy, gs, 3, path=path, bounds=ops.row_bounds(gs, 20)), want)
    assert ops.TGMM_PATH_LAUNCHES == before and set(before) == {"ffma", "wgmma"}


def test_autograd_shares_the_forward_bounds_on_the_cpu():
    """On the CPU the Function saves no bounds and its grads are the plain
    versions' (the card's are held in tests/test_torch_kernels_cuda.py)."""
    x = torch.randn(20, 16, requires_grad=True)
    w = torch.randn(3, 16, 8, requires_grad=True)
    gs = torch.tensor([5, 0, 12], dtype=torch.int32)
    dy = torch.randn(20, 8)
    ops.grouped_matmul(x, w, gs).backward(dy)
    torch.testing.assert_close(w.grad, ops.ref.tgmm_ref(x.detach(), dy, gs, 3))
    torch.testing.assert_close(
        x.grad, ops.ref.grouped_matmul_ref(dy, w.detach().transpose(1, 2), gs))
