"""The port's CUDA kernels against their plain versions, on the card:
``gmm``/``tgmm``, ``flash_attention`` and its backward,
``flash_decode_int8``, ``ssd_scan`` and its backward, and ``rglru_scan``
and its backward.

These tests need a CUDA card (the kernels have no CPU mode) and skip
without one.  They import neither JAX nor the reference package, so they
run where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import decode_ops, decode_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.grouped_matmul import ops, ref
from repro_torch.kernels.rglru_scan import ops as lru_ops
from repro_torch.kernels.rglru_scan import ref as lru_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models.layers import quantize_kv

pytestmark = pytest.mark.cuda

# (M, K, N, G) with explicit group sizes (None: random, empty groups likely);
# the last two are the FEMNIST client's layer shapes at a 32-client wave
CASES = [
    ((128, 32, 64, 4), None),
    ((96, 16, 40, 5), [0, 30, 0, 66, 0]),
    ((130, 64, 62, 1), [130]),
    ((1283, 784, 128, 32), None),
    ((1283, 128, 62, 32), None),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, sizes, seed):
    m, k, n, g = shape
    rng = np.random.default_rng(seed)
    if sizes is None:
        cuts = np.sort(rng.integers(0, m + 1, size=g - 1))
        sizes = np.diff(np.concatenate([[0], cuts, [m]]))
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(g, k, n)) / np.sqrt(k)).astype(np.float32)
    dy = rng.normal(size=(m, n)).astype(np.float32)
    return x, w, dy, np.asarray(sizes, np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,sizes", CASES)
def test_kernels_match_plain_versions(card, shape, sizes, dtype):
    x, w, dy, gs = _inputs(shape, sizes, seed=5)
    tdt = getattr(torch, dtype)
    xc, wc, dyc = (torch.from_numpy(a).to(card, tdt) for a in (x, w, dy))
    gc = torch.from_numpy(gs).to(card)
    before = dict(ops.LAUNCHES)
    y, dw = ops.gmm(xc, wc, gc), ops.tgmm(xc, dyc, gc, shape[3])
    dx = ops.gmm(dyc, wc.transpose(1, 2), gc)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["gmm"] == before["gmm"] + 2
    assert ops.LAUNCHES["tgmm"] == before["tgmm"] + 1
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)
    for got, want in ((y, ref.grouped_matmul_ref(xc, wc, gc)),
                      (dx, ref.grouped_matmul_ref(dyc, wc.transpose(1, 2), gc)),
                      (dw, ref.tgmm_ref(xc, dyc, gc, shape[3]))):
        torch.testing.assert_close(got.float(), want.float(), **tol)
    for g, size in enumerate(gs):  # an empty group's gradient is exact zeros
        assert size or not dw[g].any()


@pytest.mark.parametrize("shape,sizes", CASES)
def test_autograd_matches_autograd_through_plain_versions(card, shape, sizes):
    x, w, dy, gs = _inputs(shape, sizes, seed=6)
    gc = torch.from_numpy(gs).to(card)
    grads = []
    for fn in (ops.grouped_matmul, ref.grouped_matmul_ref):
        xc = torch.from_numpy(x).to(card).requires_grad_()
        wc = torch.from_numpy(w).to(card).requires_grad_()
        fn(xc, wc, gc).backward(torch.from_numpy(dy).to(card))
        grads.append((xc.grad, wc.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    x = torch.zeros((8, 4), device=card)
    w = torch.zeros((2, 4, 3), device=card)
    gs = torch.tensor([4, 4], dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        ops.gmm(x.half(), w.half(), gs)
    with pytest.raises(TypeError):
        ops.gmm(x, w.double(), gs)
    with pytest.raises(ValueError):
        ops.gmm(x.t().contiguous().t(), w, gs)        # non-contiguous x
    with pytest.raises(ValueError):
        ops.gmm(x, w, gs[:1])                          # one size for two groups
    with pytest.raises(ValueError):
        ops.gmm(x, w.cpu(), gs)                        # mixed devices


def _decode_split_384():
    sizes = [0] * 384
    for i in range(24):
        sizes[(37 * i) % 384] += 1 + (i % 3 == 0)
    return sizes


# gmm's split edge cases, on every path: (K, N, group sizes, rows past them) —
# groups ending at and one row past the tile edges (8-row stream passes, 32-
# and 64-row ffma tiles, 128-row wgmma tiles; N = 320 past a 256-column tile),
# one expert taking every row, a 32-row decode split over 384 experts, and
# every group empty with rows past them
PATH_CASES = {
    "tile-edges": (64, 320, [128, 129, 127, 32, 33, 8, 9, 64, 65, 0, 1], 3),
    "one-expert-all-rows": (128, 128, [0] * 11 + [300] + [0] * 4, 0),
    "G384-decode": (64, 64, _decode_split_384(), 0),
    "all-empty-rows-past": (64, 96, [0] * 8, 300),
}


# every path with each dtype it takes (wgmma takes bf16; f32 stays on FFMA)
PATH_DTYPES = [(p, d) for p in ops.PATHS for d in ("float32", "bfloat16")
               if not (p == "wgmma" and d == "float32")]


@pytest.mark.parametrize("path,dtype", PATH_DTYPES)
@pytest.mark.parametrize("case", list(PATH_CASES))
def test_gmm_every_path_at_split_edges(card, case, path, dtype):
    k, n, sizes, extra = PATH_CASES[case]
    m = sum(sizes) + extra
    x, w, dy, gs = _inputs((m, k, n, len(sizes)), sizes, seed=8)
    tdt = getattr(torch, dtype)
    xc, wc, dyc = (torch.from_numpy(a).to(card, tdt) for a in (x, w, dy))
    gc = torch.from_numpy(gs).to(card)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)
    for lhs, rhs in ((xc, wc), (dyc, wc.transpose(1, 2))):
        got = ops.gmm(lhs, rhs, gc, path=path)
        torch.testing.assert_close(got.float(), ref.grouped_matmul_ref(lhs, rhs, gc).float(), **tol)
        assert not got[sum(sizes):].any()     # rows past the groups: exact zeros


@pytest.mark.parametrize("path", ["wgmma", "stream"])
def test_gmm_bf16_transposed_w_at_a_prefill_split(card, path):
    """The backward's dx = dy @ wᵀ in bf16 with wᵀ read in place, at a routed
    prefill-like split (olmoe's shape cut to a few MB)."""
    rng = np.random.default_rng(9)
    sizes = rng.multinomial(2048, rng.dirichlet(np.ones(64))).astype(np.int32)
    sizes[::7] = 0
    m = int(sizes.sum())
    dy = torch.from_numpy(rng.normal(size=(m, 128)).astype(np.float32)).to(card, torch.bfloat16)
    w = torch.from_numpy((rng.normal(size=(64, 256, 128)) / 16).astype(np.float32)).to(card, torch.bfloat16)
    gc = torch.from_numpy(sizes).to(card)
    got = ops.gmm(dy, w.transpose(1, 2), gc, path=path)
    want = ref.grouped_matmul_ref(dy, w.transpose(1, 2), gc)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("path", list(ops.PATHS))
def test_gmm_reads_no_group_size_on_the_host(card, path):
    dtype = torch.bfloat16 if path == "wgmma" else torch.float32
    x = torch.randn((48, 64), device=card).to(dtype)
    w = torch.randn((16, 64, 64), device=card).to(dtype)
    gs = torch.tensor([0, 5, 0, 20, 3] + [1] * 11, dtype=torch.int32, device=card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = ops.gmm(x, w, gs, path=path)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.testing.assert_close(y.float(), ref.grouped_matmul_ref(x, w, gs).float(),
                               rtol=2e-2, atol=2e-2)


def test_gmm_refuses_paths_that_do_not_take_the_operands(card):
    x = torch.zeros((8, 62), device=card)
    w = torch.zeros((2, 62, 16), device=card)
    gs = torch.tensor([4, 4], dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        ops.gmm(x, w, gs, path="stream")               # K = 62: no 16-byte rows
    with pytest.raises(ValueError):
        ops.gmm(x[:, :48].contiguous(), w[:, :48], gs, path="wgmma")   # f32
    with pytest.raises(ValueError):
        ops.gmm(x, w, gs, path="tiled")                # no such path
    with pytest.raises(ValueError):
        ops.gmm(x, w.transpose(0, 2).contiguous().transpose(0, 2), gs)  # no unit stride on K or N
    before = ops.LAUNCHES["gmm"]
    ops.gmm(x, w, gs)
    assert ops.LAUNCHES["gmm"] == before + 1


# tgmm on each path: CASES as they stand, one group of 300 rows (several
# 64-row wgmma stages and 16-row ffma stages), K = 784 (a ragged K edge on
# the 128-row wgmma tile) with N = 62 and with N = 136 (past a 128-column
# tile, into a 256-column one), and empty groups with 98 rows past the groups
TGMM_CASES = list(CASES) + [
    ((300, 128, 128, 1), [300]),
    ((600, 784, 62, 4), [150, 0, 300, 150]),
    ((600, 784, 136, 4), [150, 0, 300, 150]),
    ((213, 64, 96, 6), [0, 70, 0, 0, 45, 0]),
]
TGMM_PATH_DTYPES = [("ffma", "float32"), ("ffma", "bfloat16"), ("wgmma", "bfloat16")]


def _tgmm_inputs(shape, sizes, dtype, device, seed=10, offset=0):
    """x, dy (``offset`` elements into their storage) and the group sizes."""
    x, _, dy, gs = _inputs(shape, sizes, seed)
    tdt = getattr(torch, dtype)

    def place(a):
        flat = torch.empty(a.size + offset, device=device, dtype=tdt)[offset:]
        return flat.view(a.shape).copy_(torch.from_numpy(a))
    return place(x), place(dy), torch.from_numpy(gs).to(device)


def _hold_tgmm(dw, xc, dyc, gc, g, dtype):
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(dw.float(), ref.tgmm_ref(xc, dyc, gc, g).float(), **tol)
    for gi, size in enumerate(gc.tolist()):   # an empty group's gradient is exact zeros
        assert size or not dw[gi].any()


@pytest.mark.parametrize("path,dtype", TGMM_PATH_DTYPES)
@pytest.mark.parametrize("shape,sizes", TGMM_CASES)
def test_tgmm_every_path_matches_plain_version(card, shape, sizes, path, dtype):
    _, k, n, g = shape
    xc, dyc, gc = _tgmm_inputs(shape, sizes, dtype, card)
    if path == "wgmma" and (k % 8 or n % 8):        # no 16-byte rows: the path refuses
        with pytest.raises(ValueError):
            ops.tgmm(xc, dyc, gc, g, path=path)
        return
    before, by_path = ops.LAUNCHES["tgmm"], dict(ops.TGMM_PATH_LAUNCHES)
    dw = ops.tgmm(xc, dyc, gc, g, path=path)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["tgmm"] == before + 1
    assert ops.TGMM_PATH_LAUNCHES == {**by_path, path: by_path[path] + 1}
    _hold_tgmm(dw, xc, dyc, gc, g, dtype)


@pytest.mark.parametrize("dtype,offset,copy_bytes", [("float32", 1, 4), ("float32", 2, 8),
                                                     ("bfloat16", 1, 2), ("bfloat16", 2, 4)])
def test_tgmm_unaligned_rows_take_ffma_with_narrower_copies(card, dtype, offset, copy_bytes):
    shape, sizes = (600, 784, 136, 4), [150, 0, 300, 150]
    xc, dyc, gc = _tgmm_inputs(shape, sizes, dtype, card, offset=offset)
    esize = xc.element_size()
    assert ops.tgmm_copy_bytes(784, 136, esize, xc.data_ptr(), dyc.data_ptr()) == copy_bytes
    before = dict(ops.TGMM_PATH_LAUNCHES)
    dw = ops.tgmm(xc, dyc, gc, 4)
    assert ops.TGMM_PATH_LAUNCHES == {**before, "ffma": before["ffma"] + 1}
    _hold_tgmm(dw, xc, dyc, gc, 4, dtype)


@pytest.mark.parametrize("path", list(ops.TGMM_PATHS))
def test_tgmm_reads_no_group_size_on_the_host(card, path):
    dtype = torch.bfloat16 if path == "wgmma" else torch.float32
    x = torch.randn((48, 64), device=card).to(dtype)
    dy = torch.randn((48, 32), device=card).to(dtype)
    gs = torch.tensor([0, 5, 0, 20, 3] + [1] * 11, dtype=torch.int32, device=card)
    bounds = ops.row_bounds(gs, 48)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dw = ops.tgmm(x, dy, gs, 16, path=path)
        dw_shared = ops.tgmm(x, dy, gs, 16, path=path, bounds=bounds)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = ref.tgmm_ref(x, dy, gs, 16).float()
    for got in (dw, dw_shared):
        torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)


def test_tgmm_refuses_paths_that_do_not_take_the_operands(card):
    x = torch.zeros((8, 64), device=card)
    dy = torch.zeros((8, 62), device=card)
    gs = torch.tensor([4, 4], dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        ops.tgmm(x, dy[:, :32].contiguous(), gs, 2, path="wgmma")     # f32
    with pytest.raises(ValueError):
        ops.tgmm(x.bfloat16(), dy.bfloat16(), gs, 2, path="wgmma")    # N = 62
    with pytest.raises(ValueError):
        ops.tgmm(x, dy, gs, 2, path="tiled")                          # no such path
    with pytest.raises(ValueError):
        ops.tgmm(x, dy, gs, 2, bounds=ops.row_bounds(gs, 8)[:-1])     # G + 1 bounds
    before = dict(ops.TGMM_PATH_LAUNCHES)
    ops.tgmm(x, dy, gs, 2)
    ops.tgmm(x.bfloat16(), dy[:, :32].contiguous().bfloat16(), gs, 2)
    assert ops.TGMM_PATH_LAUNCHES == {"ffma": before["ffma"] + 1, "wgmma": before["wgmma"] + 1}


@pytest.mark.parametrize("dtype,path", [("float32", "ffma"), ("bfloat16", "wgmma")])
def test_autograd_backward_runs_tgmm_on_its_path(card, dtype, path):
    """The backward's dw takes the path its dtype picks, on the forward's bounds."""
    shape, sizes = (600, 784, 136, 4), [150, 0, 300, 150]
    x, w, dy, gs = _inputs(shape, sizes, seed=11)
    tdt = getattr(torch, dtype)
    gc = torch.from_numpy(gs).to(card)

    def grads_of(fn):
        xc = torch.from_numpy(x).to(card, tdt).requires_grad_()
        wc = torch.from_numpy(w).to(card, tdt).requires_grad_()
        fn(xc, wc, gc).backward(torch.from_numpy(dy).to(card, tdt))
        return xc.grad.float(), wc.grad.float()

    before = dict(ops.TGMM_PATH_LAUNCHES)
    grads = [grads_of(ops.grouped_matmul)]
    assert ops.TGMM_PATH_LAUNCHES == {**before, path: before[path] + 1}
    grads.append(grads_of(ref.grouped_matmul_ref))
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)


# the regime of an MoE train step (olmoe at batch 8 x 128: about 128 rows an
# expert, between decode's few and prefill's thousand), at narrow widths:
# (M, K, N, G) for the gate/up product and the down product
TRAIN_SHAPES = [(2048, 256, 128, 16), (2048, 128, 256, 16)]


@pytest.mark.parametrize("w_layout", ["stored", "transposed view"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", TRAIN_SHAPES)
def test_autograd_at_the_training_regime(card, shape, dtype, w_layout):
    """Forward, dx = gmm(dy, wᵀ) on wᵀ as a view and dw on tgmm, against
    autograd through the plain version; w itself also given as a transposed
    view of a (G, N, K) tensor.  Two gmm launches and one tgmm a call, tgmm
    on the path its dtype picks; bf16 takes wgmma for every product."""
    m, k, n, g = shape
    rng = np.random.default_rng(13)
    sizes = rng.multinomial(m, np.full(g, 1.0 / g)).astype(np.int32)
    assert 64 < sizes.min() and sizes.max() < 192, sizes
    x, w, dy, _ = _inputs(shape, sizes, seed=14)
    tdt = getattr(torch, dtype)
    gc = torch.from_numpy(sizes).to(card)

    def grads_of(fn):
        xc = torch.from_numpy(x).to(card, tdt).requires_grad_()
        if w_layout == "stored":
            wc = torch.from_numpy(w).to(card, tdt).requires_grad_()
            wv = wc
        else:
            wc = torch.from_numpy(w.transpose(0, 2, 1).copy()).to(card, tdt).requires_grad_()
            wv = wc.transpose(1, 2)
        y = fn(xc, wv, gc)
        y.backward(torch.from_numpy(dy).to(card, tdt))
        return y.float(), xc.grad.float(), wc.grad.float()

    before, before_paths = dict(ops.LAUNCHES), dict(ops.TGMM_PATH_LAUNCHES)
    got = grads_of(ops.grouped_matmul)
    path = "wgmma" if dtype == "bfloat16" else "ffma"
    assert ops.LAUNCHES == {"gmm": before["gmm"] + 2, "tgmm": before["tgmm"] + 1}
    assert ops.TGMM_PATH_LAUNCHES == {**before_paths, path: before_paths[path] + 1}
    if dtype == "bfloat16":
        assert ops.choose_path(m, k, n, g, tdt) == ops.choose_path(m, n, k, g, tdt) == "wgmma"
    want = grads_of(ref.grouped_matmul_ref)
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    for a, b, what in zip(got, want, ("y", "dx", "dw")):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol, msg=lambda m_: f"{what}: {m_}")


# flash attention: (b, sq, skv, hq, hk, d, causal, window) — the reference's
# sweep (tests/test_kernels.py:26-34), a suffix (Sq < Skv), ragged lengths
# and head sizes off the kernel's tiles, MQA at D = 256 with a window edge
# inside the wgmma path's tiles, and a long suffix at D = 128
FLASH_CASES = [
    (1, 128, 128, 4, 4, 32, True, None),
    (2, 256, 256, 8, 2, 64, True, None),
    (2, 256, 256, 8, 2, 64, True, 64),
    (1, 384, 384, 4, 1, 32, True, 128),
    (2, 128, 128, 4, 4, 64, False, None),
    (1, 128, 512, 4, 2, 64, True, None),
    (2, 200, 200, 4, 2, 32, True, None),
    (1, 37, 150, 4, 4, 16, True, 24),
    (1, 70, 70, 2, 2, 48, False, None),
    (1, 65, 65, 2, 1, 128, True, 5),
    (1, 2048, 2048, 16, 1, 256, True, 512),
    (2, 128, 2048, 8, 2, 128, True, None),
    (1, 256, 256, 12, 2, 128, True, None),     # GQA 6:1 at D=128 (internvl2-26b's heads)
    (1, 200, 200, 8, 8, 64, False, None),      # bidirectional off the tiles (whisper's encoder)
]
# each flash path with each dtype it takes (wgmma takes bf16; f32 stays on FFMA)
FLASH_PATH_DTYPES = [("ffma", "float32"), ("ffma", "bfloat16"), ("wgmma", "bfloat16")]


def _flash_inputs(case, device, dtype, seed=7):
    b, sq, skv, hq, hk, d = case[:6]
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen).to(device, dtype)
                 for shape in ((b, sq, hq, d), (b, skv, hk, d), (b, skv, hk, d)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_plain_version(card, case, dtype):
    causal, window = case[6:]
    q, k, v = _flash_inputs(case, card, getattr(torch, dtype))
    before, paths = fa_ops.LAUNCHES["flash_attention"], dict(fa_ops.PATH_LAUNCHES)
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES["flash_attention"] == before + 1
    path = "wgmma" if dtype == "bfloat16" else "ffma"      # every case's D is a multiple of 8
    assert fa_ops.PATH_LAUNCHES == {**paths, path: paths[path] + 1}
    want = fa_ref.attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("path,dtype", FLASH_PATH_DTYPES)
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_every_path_matches_plain_version(card, case, path, dtype):
    causal, window = case[6:]
    q, k, v = _flash_inputs(case, card, getattr(torch, dtype))
    before, paths = fa_ops.LAUNCHES["flash_attention"], dict(fa_ops.PATH_LAUNCHES)
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window, path=path)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES["flash_attention"] == before + 1
    assert fa_ops.PATH_LAUNCHES == {**paths, path: paths[path] + 1}
    want = fa_ref.attention_ref(q, k, v, causal=causal, window=window)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got.float(), want.float(), **tol)


def _misaligned(t, how):
    """``t``'s values in a bf16 view that 16-byte copies cannot read: a head
    stride of D + 4 elements, or a start 2 bytes past an aligned one."""
    b, s, h, d = t.shape
    if how == "stride":
        buf = torch.zeros((b, s, h, d + 4), dtype=t.dtype, device=t.device)
        buf[..., :d] = t
        return buf[..., :d]
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(b, s, h, d)
    view.copy_(t)
    return view


@pytest.mark.parametrize("how", ["stride", "offset"])
def test_flash_unaligned_bf16_takes_ffma(card, how):
    case = (2, 96, 160, 4, 2, 64, True, 40)
    q, k, v = _flash_inputs(case, card, torch.bfloat16)
    views = [_misaligned(t, how) for t in (q, k, v)]
    assert fa_ops.choose_path(q, k, v) == "wgmma" and fa_ops.choose_path(*views) == "ffma"
    paths = dict(fa_ops.PATH_LAUNCHES)
    got = fa_ops.flash_attention(*views, window=40)
    torch.cuda.synchronize()
    assert fa_ops.PATH_LAUNCHES == {**paths, "ffma": paths["ffma"] + 1}
    torch.testing.assert_close(got, fa_ops.flash_attention(q, k, v, window=40, path="ffma"),
                               rtol=0, atol=0)
    torch.testing.assert_close(got.float(), fa_ref.attention_ref(q, k, v, window=40).float(),
                               rtol=2e-2, atol=2e-2)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(*views, window=40, path="wgmma")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [1, 8, 20, 36, 64, 72, 100, 128, 136, 200, 256])
def test_flash_takes_every_head_size_it_took_before(card, d, dtype):
    """Every head size up to 256 runs, on the path chosen for it: bf16 with
    D % 8 == 0 on wgmma (zero-padded to 64, 128 or 256), the rest on ffma."""
    case = (1, 70, 90, 4, 2, d, True, None)
    q, k, v = _flash_inputs(case, card, getattr(torch, dtype))
    path = "wgmma" if dtype == "bfloat16" and d % 8 == 0 else "ffma"
    assert fa_ops.choose_path(q, k, v) == path
    got = fa_ops.flash_attention(q, k, v)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got.float(), fa_ref.attention_ref(q, k, v).float(), **tol)


def test_flash_attention_reads_strided_layouts_in_place(card):
    """(B, H, S, D) tensors viewed as (B, S, H, D): the kernel follows the
    strides and gives the contiguous result exactly."""
    q, k, v = _flash_inputs((2, 96, 96, 4, 2, 64), card, torch.float32)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    assert not views[0].is_contiguous()
    want = fa_ops.flash_attention(q, k, v, window=40)
    got = fa_ops.flash_attention(*views, window=40)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_flash_wgmma_reads_strided_layouts_in_place(card):
    """bf16 (B, H, S, D) tensors viewed as (B, S, H, D) keep 16-byte rows:
    the wgmma path takes them and gives the contiguous result exactly."""
    q, k, v = _flash_inputs((2, 300, 300, 4, 2, 128), card, torch.bfloat16)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    assert not views[0].is_contiguous() and fa_ops.choose_path(*views) == "wgmma"
    want = fa_ops.flash_attention(q, k, v, window=100)
    got = fa_ops.flash_attention(*views, window=100)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(card):
    q = torch.zeros((1, 8, 4, 16), device=card)
    k = torch.zeros((1, 8, 2, 16), device=card)
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q, k.bfloat16(), k)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, q[:, :, :3], q[:, :, :3])        # Hk does not divide Hq
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, k.cpu(), k)                       # mixed devices
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, k, k, window=0)
    with pytest.raises(ValueError):
        big = torch.zeros((1, 8, 1, 264), device=card)
        fa_ops.flash_attention(big, big, big)                       # D above the kernel's 256
    with pytest.raises(ValueError):
        odd = torch.zeros((1, 8, 4, 32), device=card)[..., ::2]
        fa_ops.flash_attention(odd, odd, odd)                       # D not unit-stride
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, k, k, path="wgmma")               # f32
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, k, k, path="mma")                 # no such path
    qg = q.clone().requires_grad_()
    (dq,) = torch.autograd.grad(fa_ops.flash_attention(qg, k, k).sum(), qg)   # trains now
    assert dq.shape == q.shape and torch.isfinite(dq).all()
    # the same refusals hold under grad
    with pytest.raises(TypeError):
        fa_ops.flash_attention(qg.half(), k.half(), k.half())
    with pytest.raises(ValueError):
        fa_ops.flash_attention(qg, q[:, :, :3], q[:, :, :3])
    with pytest.raises(ValueError):
        fa_ops.flash_attention(qg, k, k, window=0)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(qg, k, k, path="wgmma")
    with pytest.raises(ValueError):                                 # rows with no live key
        fa_ops.flash_attention(qg, k[:, :5], k[:, :5])


# the backward: the reference's sweep and a suffix (FLASH_CASES[:6]), a
# ragged window, internvl2's GQA 6:1 and MQA at D = 256 with a window edge
# inside its 32-key tiles
FLASH_BWD_CASES = FLASH_CASES[:6] + [
    (2, 200, 200, 4, 2, 32, True, 48),
    (1, 256, 256, 12, 2, 128, True, None),
    (1, 65, 65, 2, 1, 256, True, 5),
]


def _rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


def _bwd_inputs(case, device, dtype, seed=9):
    b, sq, skv, hq, hk, d = case[:6]
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen).to(device, dtype) for shape in
                 ((b, sq, hq, d), (b, skv, hk, d), (b, skv, hk, d), (b, sq, hq, d)))


def _bwd_close(got, want32, dtype):
    """f32: allclose 1e-4 (tests/test_kernels.py:56); bf16: relative norm
    2e-2 against the plain version in f32 on the same bf16 inputs."""
    if dtype == "float32":
        return all(torch.allclose(a, b, rtol=1e-4, atol=1e-4) for a, b in zip(got, want32))
    return max(_rel(a, b) for a, b in zip(got, want32)) <= 2e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_flash_backward_matches_plain_version(card, case, dtype):
    causal, window = case[6:]
    q, k, v, do = _bwd_inputs(case, card, getattr(torch, dtype))
    o, lse = fa_ops.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(lse, fa_ref.attention_lse_ref(q, k, causal=causal, window=window),
                               rtol=1e-5, atol=1e-5)
    before, kernels = dict(fa_ops.LAUNCHES), dict(fa_ops.BWD_LAUNCHES)
    got = fa_ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == {**before, "flash_attention_bwd": before["flash_attention_bwd"] + 1}
    assert fa_ops.BWD_LAUNCHES == {key: n + 1 for key, n in kernels.items()}
    for g, t in zip(got, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
    want32 = fa_ref.attention_bwd_ref(q.float(), k.float(), v.float(), do.float(),
                                      causal=causal, window=window)
    assert _bwd_close(got, want32, dtype), [_rel(a, b) for a, b in zip(got, want32)]
    # control: K rolled by one position fails the limit
    kr = k.roll(1, dims=1)
    o_r, lse_r = fa_ops.flash_attention_fwd(q, kr, v, causal=causal, window=window)
    rolled = fa_ops.flash_attention_bwd(q, kr, v, o_r, lse_r, do, causal=causal, window=window)
    for a, b in zip(rolled, want32):
        assert not _bwd_close((a,), (b,), dtype)


def test_flash_counts_with_and_without_grad(card):
    """Without grad one forward launch that stores no lse (its output the
    grad forward's bit for bit); with grad the Function's forward and one
    backward call of three launches; an input that needs no gradient gets
    none, and dQ alone skips the dK/dV kernel."""
    q, k, v, do = _bwd_inputs((2, 160, 160, 8, 2, 64), card, torch.bfloat16)
    counters = (fa_ops.LAUNCHES, fa_ops.PATH_LAUNCHES, fa_ops.BWD_LAUNCHES)

    def counted(fn):
        for c in counters:
            c.update({key: 0 for key in c})
        out = fn()
        torch.cuda.synchronize()
        return out, tuple(dict(c) for c in counters)

    plain, counts = counted(lambda: fa_ops.flash_attention(q, k, v, window=40))
    assert counts == ({"flash_attention": 1, "flash_attention_bwd": 0},
                      {"ffma": 0, "wgmma": 1, "bwd_ffma": 0},
                      {"preprocess": 0, "dkdv": 0, "dq": 0})
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    with torch.no_grad():
        _, counts = counted(lambda: fa_ops.flash_attention(qg, kg, vg, window=40))
    assert counts[0] == {"flash_attention": 1, "flash_attention_bwd": 0}

    def step():
        out = fa_ops.flash_attention(qg, kg, vg, window=40)
        return out, torch.autograd.grad(out, (qg, kg, vg), do)

    (out, grads), counts = counted(step)
    assert torch.equal(out, plain)
    assert counts == ({"flash_attention": 1, "flash_attention_bwd": 1},
                      {"ffma": 0, "wgmma": 1, "bwd_ffma": 1},
                      {"preprocess": 1, "dkdv": 1, "dq": 1})
    want = fa_ref.attention_bwd_ref(q.float(), k.float(), v.float(), do.float(), window=40)
    assert max(_rel(a, b) for a, b in zip(grads, want)) <= 2e-2
    qg = q.clone().requires_grad_()
    (_, (dq,)), counts = counted(
        lambda: (None, torch.autograd.grad(fa_ops.flash_attention(qg, k, v, window=40), qg, do)))
    assert counts[2] == {"preprocess": 1, "dkdv": 0, "dq": 1}
    assert _rel(dq, want[0]) <= 2e-2


# SSD scan: (b, l, h, p, g, n) — the reference's sweep (tests/test_kernels.py:
# 66-68), G > 1 with a ragged tail, one chunk's worth with no tail, a length
# shorter than the kernel's chunk with P and N off its buckets, and
# mamba2-1.3b's head and state sizes; then where the wgmma path's 64-row
# chunks and its N padding matter: served widths with L off 64, G = 2 at
# served widths, a narrow case (N = 64, padded to 128)
SSD_CASES = [
    (1, 64, 2, 8, 1, 8),
    (2, 128, 4, 16, 2, 16),
    (1, 96, 4, 8, 1, 16),
    (2, 45, 4, 8, 2, 16),
    (1, 32, 2, 8, 1, 8),
    (1, 7, 2, 24, 1, 40),
    (2, 100, 8, 64, 1, 128),
    (2, 1000, 8, 64, 1, 128),
    (2, 512, 8, 64, 2, 128),
    (2, 256, 4, 32, 1, 64),
]
# each SSD path with each dtype it takes (wgmma takes bf16 with N > 32; f32
# stays on FFMA)
SSD_PATH_DTYPES = [("ffma", "float32"), ("ffma", "bfloat16"), ("wgmma", "bfloat16")]


def _ssd_inputs(case, device, dtype, seed=8, strong=False):
    """strong: a = -exp(normal + 2), where exp(cs) underflows within a chunk
    and a seg factored as exp(cs_t) exp(-cs_s) would overflow."""
    b, l, h, p, g, n = case
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, l, h, p))
    dt = np.log1p(np.exp(rng.normal(size=(b, l, h))))    # softplus
    a = -np.exp(rng.normal(size=(h,)) + (2.0 if strong else 0.0))
    bm, cm = rng.normal(size=(b, l, g, n)), rng.normal(size=(b, l, g, n))
    f32 = torch.float32
    return (torch.from_numpy(x).to(device, dtype), torch.from_numpy(dt).to(device, f32),
            torch.from_numpy(a).to(device, f32), torch.from_numpy(bm).to(device, dtype),
            torch.from_numpy(cm).to(device, dtype))


def _hold_ssd(y, s, args):
    """The kernel's outputs against the step recurrence, as tests/test_kernels.py
    holds the Pallas kernel, at the reference's tolerances: elementwise, but
    for y where N > 32, where one read-out sums N products of unit normals
    and an element that cancels carries the rounding of those terms on
    either side: there y is held by its relative norm."""
    want_y, want_s = ssd_ref.ssd_sequential(*args)
    assert y.dtype == args[0].dtype and y.shape == args[0].shape
    assert s.dtype == torch.float32 and s.shape == want_s.shape
    tol = dict(rtol=2e-2, atol=2e-2) if y.dtype == torch.bfloat16 else dict(rtol=2e-5, atol=2e-5)
    if args[3].shape[-1] <= 32:
        torch.testing.assert_close(y.float(), want_y.float(), **tol)
    rel = float((y.float() - want_y.float()).norm() / want_y.float().norm())
    assert rel < tol["rtol"], rel
    torch.testing.assert_close(s, want_s, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_matches_plain_version(card, case, dtype):
    """On the path chosen for it: every case's P and N are multiples of 8,
    so bf16 takes wgmma where N > 32 and ffma elsewhere, and f32 ffma."""
    args = _ssd_inputs(case, card, getattr(torch, dtype))
    before, paths = ssd_ops.LAUNCHES["ssd_scan"], dict(ssd_ops.PATH_LAUNCHES)
    y, s = ssd_ops.ssd(*args, chunk=32, impl="pallas")
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES["ssd_scan"] == before + 1
    path = "wgmma" if dtype == "bfloat16" and case[-1] > 32 else "ffma"
    assert ssd_ops.PATH_LAUNCHES == {**paths, path: paths[path] + 1}
    _hold_ssd(y, s, args)


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("path,dtype", SSD_PATH_DTYPES)
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_every_path_matches_plain_version(card, case, path, dtype, strong):
    """Each case on each path; wgmma refuses N <= 32, where y is held
    elementwise."""
    args = _ssd_inputs(case, card, getattr(torch, dtype), strong=strong)
    before, paths = ssd_ops.LAUNCHES["ssd_scan"], dict(ssd_ops.PATH_LAUNCHES)
    if path == "wgmma" and case[-1] <= 32:
        with pytest.raises(ValueError):
            ssd_ops.ssd(*args, impl="pallas", path=path)
        assert (ssd_ops.LAUNCHES["ssd_scan"], ssd_ops.PATH_LAUNCHES) == (before, paths)
        return
    y, s = ssd_ops.ssd(*args, impl="pallas", path=path)
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES["ssd_scan"] == before + 1
    assert ssd_ops.PATH_LAUNCHES == {**paths, path: paths[path] + 1}
    assert torch.isfinite(y.float()).all() and torch.isfinite(s).all()
    _hold_ssd(y, s, args)


def test_ssd_scan_reads_strided_layouts_in_place(card):
    """x, B and C as slices of one wider projection, as a fused projection
    would hand them over: the kernel follows the strides and gives the
    contiguous result exactly."""
    x, dt, a, bm, cm = _ssd_inputs((2, 70, 4, 16, 2, 16), card, torch.float32)
    wide = torch.cat([x.flatten(2), bm.flatten(2), cm.flatten(2)], dim=-1)
    xv = wide[..., :64].unflatten(2, (4, 16))
    bv, cv = wide[..., 64:96].unflatten(2, (2, 16)), wide[..., 96:].unflatten(2, (2, 16))
    assert not xv.is_contiguous()
    want = ssd_ops.ssd(x, dt, a, bm, cm, impl="pallas")
    got = ssd_ops.ssd(xv, dt, a, bv, cv, impl="pallas")
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=0, atol=0)


def test_ssd_wrapper_refuses_what_the_kernel_does_not_take(card):
    x, dt, a, bm, cm = _ssd_inputs((1, 8, 4, 8, 2, 8), card, torch.float32)
    with pytest.raises(TypeError):
        ssd_ops.ssd(x.half(), dt, a, bm.half(), cm.half(), impl="pallas")
    with pytest.raises(TypeError):
        ssd_ops.ssd(x, dt, a, bm.bfloat16(), cm, impl="pallas")      # mixed dtypes
    with pytest.raises(ValueError):
        ssd_ops.ssd(x[:, :, :3], dt[:, :, :3], a[:3], bm, cm, impl="pallas")   # G does not divide H
    with pytest.raises(ValueError):
        ssd_ops.ssd(x, dt.cpu(), a, bm, cm, impl="pallas")           # mixed devices
    with pytest.raises(ValueError):
        big = torch.zeros((1, 8, 1, 72), device=card)
        ssd_ops.ssd(big, dt[:, :, :1], a[:1], bm[:, :, :1], cm[:, :, :1], impl="pallas")
    with pytest.raises(ValueError):
        ssd_ops.ssd(x[..., ::2], dt, a, bm, cm, impl="pallas")       # P not unit-stride
    # under grad a CUDA input gets its gradients from the backward kernels,
    # and the wrapper still refuses what the kernels do not take
    xg = x.clone().requires_grad_()
    y, _ = ssd_ops.ssd(xg, dt, a, bm, cm, impl="pallas")
    (dx,) = torch.autograd.grad(y.sum(), xg)
    assert dx.shape == x.shape and dx.dtype == x.dtype and torch.isfinite(dx).all()
    with pytest.raises(TypeError):
        ssd_ops.ssd(xg.half(), dt, a, bm.half(), cm.half(), impl="pallas")
    with pytest.raises(ValueError):
        ssd_ops.ssd(xg[:, :, :3], dt[:, :, :3], a[:3], bm, cm, impl="pallas")   # G does not divide H
    with pytest.raises(ValueError):
        big = torch.zeros((1, 8, 1, 72), device=card, requires_grad=True)
        ssd_ops.ssd(big, dt[:, :, :1], a[:1], bm[:, :, :1], cm[:, :, :1], impl="pallas")
    with pytest.raises(ValueError):
        ssd_ops.ssd(xg[..., ::2], dt, a, bm, cm, impl="pallas")      # P not unit-stride


# the backward: the sweep, G > 1 with a ragged L, a length shorter than the
# chunk with P and N off the buckets, served widths, and G = 2 at served
# widths under a strong decay
SSD_BWD_CASES = [
    ((1, 64, 2, 8, 1, 8), False),
    ((2, 45, 4, 8, 2, 16), False),
    ((1, 7, 2, 24, 1, 40), False),
    ((2, 100, 8, 64, 1, 128), False),
    ((2, 70, 4, 64, 2, 128), True),
]


def _ssd_grads_plain(args, dy, ds):
    """The plain backward (autograd through ``ssd_chunked``): in f64 for f32
    inputs (the f32 plain version at served widths misses f64 by more than
    1e-4 itself), in f32 for bf16 inputs."""
    work = torch.float64 if args[0].dtype == torch.float32 else torch.float32
    return ssd_ref.ssd_bwd_ref(*(t.to(work) for t in args), dy.to(work),
                               None if ds is None else ds.to(work), chunk=64)


def _ssd_grad_ok(got, want, dtype):
    """f32: allclose 1e-4 (tests/test_kernels.py:56); bf16: relative norm 2e-2."""
    if dtype == "float32":
        return torch.allclose(got.double(), want, rtol=1e-4, atol=1e-4)
    return _rel(got, want) <= 2e-2


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case,strong", SSD_BWD_CASES)
def test_ssd_backward_matches_plain_version(card, case, strong, dtype, with_state):
    """dx, ddt, da, dB, dC of the three backward kernels against the plain
    backward; B and C rolled one step along L together fail every limit (each
    gradient is linear in the inputs other than its own: dB does not see B)."""
    b, l, h, p, g, n = case
    args = _ssd_inputs(case, card, getattr(torch, dtype), strong=strong)
    gen = torch.Generator().manual_seed(11)
    dy = torch.randn((b, l, h, p), generator=gen).to(card, args[0].dtype)
    ds = torch.randn((b, h, p, n), generator=gen).to(card) if with_state else None
    before, kernels = dict(ssd_ops.LAUNCHES), dict(ssd_ops.BWD_LAUNCHES)
    got = ssd_ops.ssd_bwd(*args, dy, ds)
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES == {**before, "ssd_scan_bwd": before["ssd_scan_bwd"] + 1}
    assert ssd_ops.BWD_LAUNCHES == {key: v + 1 for key, v in kernels.items()}
    for gr, t in zip(got, args):
        assert gr.dtype == t.dtype and gr.shape == t.shape and torch.isfinite(gr.float()).all()
    want = _ssd_grads_plain(args, dy, ds)
    assert all(_ssd_grad_ok(gr, w, dtype) for gr, w in zip(got, want)), \
        [float((gr.double() - w.double()).abs().max()) for gr, w in zip(got, want)]
    rolled = ssd_ops.ssd_bwd(*args[:3], args[3].roll(1, dims=1), args[4].roll(1, dims=1), dy, ds)
    assert not any(_ssd_grad_ok(gr, w, dtype) for gr, w in zip(rolled, want))


def test_ssd_backward_reads_strided_layouts_in_place(card):
    """x, B and C as slices of one fused projection, dt and dY as slices of
    wider tensors: the backward follows the strides and gives the contiguous
    inputs' gradients exactly."""
    b, l, h, p, g, n = 2, 70, 4, 16, 2, 16
    args = _ssd_inputs((b, l, h, p, g, n), card, torch.float32)
    x, dt, a, bm, cm = args
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(13)).to(card)
    xv, bv, cv = _fused_projection(x, bm, cm, extra=8)
    dtv = torch.cat([dt, torch.zeros((b, l, 3), device=card)], dim=-1)[..., :h]
    dyv = torch.cat([dy.flatten(2), torch.zeros((b, l, 8), device=card)], dim=-1)[..., :h * p]
    dyv = dyv.unflatten(2, (h, p))
    assert not any(t.is_contiguous() for t in (xv, dtv, bv, cv, dyv))
    want = ssd_ops.ssd_bwd(*args, dy)
    got = ssd_ops.ssd_bwd(xv, dtv, a, bv, cv, dyv)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=0, atol=0)


def test_ssd_counts_with_and_without_grad(card):
    """Without grad one forward launch; with grad the Function's forward (its
    outputs the plain launch's bit for bit) and one backward call of three
    launches; a cotangent of the final state alone; x alone needing a
    gradient skips the group sum."""
    args = _ssd_inputs((2, 200, 4, 32, 1, 64), card, torch.bfloat16)
    x, dt, a, bm, cm = args
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(12)).to(card, x.dtype)
    counters = (ssd_ops.LAUNCHES, ssd_ops.PATH_LAUNCHES, ssd_ops.BWD_LAUNCHES)

    def counted(fn):
        for c in counters:
            c.update({key: 0 for key in c})
        out = fn()
        torch.cuda.synchronize()
        return out, tuple(dict(c) for c in counters)

    plain, counts = counted(lambda: ssd_ops.ssd(*args, impl="pallas"))
    assert counts == ({"ssd_scan": 1, "ssd_scan_bwd": 0}, {"ffma": 0, "wgmma": 1, "bwd_ffma": 0},
                      {"states": 0, "dchunk": 0, "group_sum": 0})
    leaves = [t.clone().requires_grad_() for t in args]
    with torch.no_grad():
        _, counts = counted(lambda: ssd_ops.ssd(*leaves, impl="pallas"))
    assert counts[0] == {"ssd_scan": 1, "ssd_scan_bwd": 0}

    def step():
        y, s = ssd_ops.ssd(*leaves, impl="pallas")
        return (y, s), torch.autograd.grad(y, leaves, dy)

    ((y, s), grads), counts = counted(step)
    assert torch.equal(y, plain[0]) and torch.equal(s, plain[1])
    assert counts == ({"ssd_scan": 1, "ssd_scan_bwd": 1}, {"ffma": 0, "wgmma": 1, "bwd_ffma": 1},
                      {"states": 1, "dchunk": 1, "group_sum": 1})
    want = _ssd_grads_plain(args, dy, None)
    assert all(_ssd_grad_ok(gr, w, "bfloat16") for gr, w in zip(grads, want))
    ds = torch.ones((2, 4, 32, 64), device=card)
    grads = torch.autograd.grad(ssd_ops.ssd(*leaves, impl="pallas")[1], leaves, ds)
    want = _ssd_grads_plain(args, torch.zeros_like(dy), ds)
    assert not grads[4].any()           # C reaches the final state through no product
    assert all(_ssd_grad_ok(gr, w, "bfloat16") for gr, w in zip(grads[:4], want[:4]))
    xg = x.clone().requires_grad_()
    (dx,), counts = counted(
        lambda: torch.autograd.grad(ssd_ops.ssd(xg, dt, a, bm, cm, impl="pallas")[0], xg, dy))
    assert counts[2] == {"states": 1, "dchunk": 1, "group_sum": 0}
    assert _ssd_grad_ok(dx, _ssd_grads_plain(args, dy, None)[0], "bfloat16")


def _fused_projection(x, bm, cm, extra=0):
    """x, B and C as column slices of one wider projection (``extra``
    columns more a row), as a fused in-projection would hand them over."""
    (b, l, h, p), (g, n) = x.shape, bm.shape[2:]
    wide = torch.zeros((b, l, h * p + 2 * g * n + extra), dtype=x.dtype, device=x.device)
    wide[..., :h * p] = x.flatten(2)
    wide[..., h * p:h * p + g * n] = bm.flatten(2)
    wide[..., h * p + g * n:h * p + 2 * g * n] = cm.flatten(2)
    return (wide[..., :h * p].unflatten(2, (h, p)), wide[..., h * p:h * p + g * n].unflatten(2, (g, n)),
            wide[..., h * p + g * n:h * p + 2 * g * n].unflatten(2, (g, n)))


def test_ssd_wgmma_reads_strided_layouts_in_place(card):
    """bf16 slices of one fused projection keep 16-byte rows: the wgmma
    path takes them and gives the contiguous result exactly."""
    x, dt, a, bm, cm = _ssd_inputs((2, 200, 4, 32, 2, 64), card, torch.bfloat16)
    xv, bv, cv = _fused_projection(x, bm, cm)
    assert not xv.is_contiguous() and ssd_ops.choose_path(xv, bv, cv) == "wgmma"
    want = ssd_ops.ssd(x, dt, a, bm, cm, impl="pallas")
    got = ssd_ops.ssd(xv, dt, a, bv, cv, impl="pallas")
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=0, atol=0)


@pytest.mark.parametrize("how", ["stride", "offset"])
def test_ssd_unaligned_bf16_takes_ffma(card, how):
    """bf16 that 16-byte copies cannot read (a row stride 4 elements off,
    or x starting 2 bytes past an aligned address) runs on ffma, as before."""
    args = _ssd_inputs((2, 70, 4, 16, 2, 48), card, torch.bfloat16)
    x, dt, a, bm, cm = args
    if how == "stride":
        xv, bv, cv = _fused_projection(x, bm, cm, extra=4)
    else:
        flat = torch.zeros(x.numel() + 1, dtype=x.dtype, device=card)
        xv = flat[1:].view(x.shape)
        xv.copy_(x)
        bv, cv = bm, cm
    assert ssd_ops.choose_path(x, bm, cm) == "wgmma" and ssd_ops.choose_path(xv, bv, cv) == "ffma"
    paths = dict(ssd_ops.PATH_LAUNCHES)
    got = ssd_ops.ssd(xv, dt, a, bv, cv, impl="pallas")
    torch.cuda.synchronize()
    assert ssd_ops.PATH_LAUNCHES == {**paths, "ffma": paths["ffma"] + 1}
    for g_, w_ in zip(got, ssd_ops.ssd(*args, impl="pallas", path="ffma")):
        torch.testing.assert_close(g_, w_, rtol=0, atol=0)
    _hold_ssd(*got, args)
    with pytest.raises(ValueError):
        ssd_ops.ssd(xv, dt, a, bv, cv, impl="pallas", path="wgmma")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,n", [(1, 1), (8, 8), (12, 20), (16, 128), (24, 40), (40, 72),
                                 (64, 32), (64, 100), (64, 128)])
def test_ssd_takes_every_shape_it_took_before(card, p, n, dtype):
    """Every P up to 64 and N up to 128 runs, on the path chosen for it:
    bf16 with P and N multiples of 8 and N > 32 on wgmma (padded to 64 and
    128), the rest on ffma."""
    args = _ssd_inputs((2, 75, 4, p, 2, n), card, getattr(torch, dtype))
    path = "wgmma" if dtype == "bfloat16" and p % 8 == 0 and n % 8 == 0 and n > 32 else "ffma"
    assert ssd_ops.choose_path(args[0], args[3], args[4]) == path
    paths = dict(ssd_ops.PATH_LAUNCHES)
    y, s = ssd_ops.ssd(*args, impl="pallas")
    torch.cuda.synchronize()
    assert ssd_ops.PATH_LAUNCHES == {**paths, path: paths[path] + 1}
    _hold_ssd(y, s, args)


def test_ssd_refuses_paths_that_do_not_take_the_operands(card):
    x, dt, a, bm, cm = _ssd_inputs((1, 40, 4, 16, 2, 48), card, torch.float32)
    with pytest.raises(ValueError):
        ssd_ops.ssd(x, dt, a, bm, cm, impl="pallas", path="wgmma")            # f32
    xb, bb, cb = x.bfloat16(), bm.bfloat16(), cm.bfloat16()
    with pytest.raises(ValueError):
        ssd_ops.ssd(xb[..., :12], dt, a, bb, cb, impl="pallas", path="wgmma")  # P off 8
    with pytest.raises(ValueError):
        ssd_ops.ssd(xb, dt, a, bb[..., :44], cb[..., :44], impl="pallas", path="wgmma")  # N off 8
    with pytest.raises(ValueError):
        ssd_ops.ssd(xb, dt, a, bb[..., :32], cb[..., :32], impl="pallas", path="wgmma")  # N <= 32
    with pytest.raises(ValueError):
        ssd_ops.ssd(xb, dt, a, bb, cb, impl="pallas", path="mma")              # no such path
    paths = dict(ssd_ops.PATH_LAUNCHES)
    ssd_ops.ssd(xb, dt, a, bb, cb, impl="pallas", path="ffma")                # ffma takes bf16
    torch.cuda.synchronize()
    assert ssd_ops.PATH_LAUNCHES == {**paths, "ffma": paths["ffma"] + 1}


# RG-LRU scan: (b, l, w) — the reference's sweep (tests/test_kernels.py:111),
# lengths the Pallas kernel refuses, one step, W off the kernel's 32 lanes
RGLRU_CASES = [
    (1, 64, 32),
    (2, 256, 128),
    (2, 96, 64),
    (2, 37, 48),
    (1, 1, 16),
    (3, 300, 40),
    (1, 2048, 96),
]


def _rglru_inputs(case, device, dtype, seed=9):
    rng = np.random.default_rng(seed)
    log_a = -np.log1p(np.exp(rng.normal(size=case)))   # -softplus
    x = rng.normal(size=case)
    return (torch.from_numpy(log_a).to(device, torch.float32),
            torch.from_numpy(x).to(device, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", RGLRU_CASES)
def test_rglru_scan_matches_plain_version(card, case, dtype):
    log_a, x = _rglru_inputs(case, card, getattr(torch, dtype))
    before = lru_ops.LAUNCHES["rglru_scan"]
    y, h = lru_ops.rglru_scan(log_a, x, impl="pallas")
    torch.cuda.synchronize()
    assert lru_ops.LAUNCHES["rglru_scan"] == before + 1
    want_y, want_h = lru_ref.rglru_associative(log_a, x)
    assert y.dtype == x.dtype and y.shape == x.shape and h.dtype == torch.float32
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(y.float(), want_y.float(), **tol)
    torch.testing.assert_close(h, want_h, rtol=1e-4, atol=1e-4)


def test_rglru_wrapper_refuses_what_the_kernel_does_not_take(card):
    log_a, x = _rglru_inputs((2, 16, 8), card, torch.float32)
    with pytest.raises(TypeError):
        lru_ops.rglru_scan(log_a, x.half(), impl="pallas")
    with pytest.raises(ValueError):
        lru_ops.rglru_scan(log_a[:, :8], x, impl="pallas")           # shapes differ
    with pytest.raises(ValueError):
        lru_ops.rglru_scan(log_a, x.cpu(), impl="pallas")            # mixed devices
    with pytest.raises(ValueError):
        lru_ops.rglru_scan(log_a[..., ::2], x[..., ::2], impl="pallas")   # W not unit-stride
    with pytest.raises(ValueError):
        lru_ops.rglru_bwd(log_a, x, x[:, :8])                         # dy not b's shape
    with pytest.raises(ValueError):
        lru_ops.rglru_bwd(log_a, x, x, torch.zeros((2, 7), device=card))   # dh_final's shape


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", RGLRU_CASES)
def test_rglru_backward_matches_plain_version(card, case, dtype, with_state):
    """dlog_a and db of the backward kernel against ``ref.rglru_bwd`` (f32
    allclose 1e-4 against it in f64; bf16 relative norms 2e-2 against it in
    f32 on the same inputs); log_a and b rolled one step along L together
    fail both limits (db does not see b)."""
    log_a, x = _rglru_inputs(case, card, getattr(torch, dtype))
    gen = torch.Generator().manual_seed(10)
    dy = torch.randn(case, generator=gen).to(card, x.dtype)
    dhf = torch.randn((case[0], case[2]), generator=gen).to(card) if with_state else None
    before, kernels = dict(lru_ops.LAUNCHES), dict(lru_ops.BWD_LAUNCHES)
    got = lru_ops.rglru_bwd(log_a, x, dy, dhf)
    torch.cuda.synchronize()
    assert lru_ops.LAUNCHES == {**before, "rglru_scan_bwd": before["rglru_scan_bwd"] + 1}
    assert lru_ops.BWD_LAUNCHES == {key: v + 1 for key, v in kernels.items()}
    for gr, t in zip(got, (log_a, x)):
        assert gr.dtype == t.dtype and gr.shape == t.shape and torch.isfinite(gr.float()).all()
    work = torch.float64 if dtype == "float32" else torch.float32
    want = lru_ref.rglru_bwd(log_a.to(work), x.to(work), dy.to(work),
                             None if dhf is None else dhf.to(work))

    def ok(gr, w):
        if dtype == "float32":
            return torch.allclose(gr.double(), w, rtol=1e-4, atol=1e-4)
        return float((gr.float() - w).norm() / w.norm().clamp_min(1e-30)) <= 2e-2

    assert all(ok(gr, w) for gr, w in zip(got, want)), \
        [float((gr.double() - w.double()).abs().max()) for gr, w in zip(got, want)]
    if case[1] > 1:
        rolled = lru_ops.rglru_bwd(log_a.roll(1, dims=1), x.roll(1, dims=1), dy, dhf)
        assert not any(ok(gr, w) for gr, w in zip(rolled, want))


def test_rglru_backward_reads_strided_layouts_in_place(card):
    """log_a, b and dy as slices of wider tensors: the backward follows the
    strides and gives the contiguous inputs' gradients exactly."""
    log_a, x = _rglru_inputs((2, 70, 40), card, torch.float32)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(14)).to(card)
    want = lru_ops.rglru_bwd(log_a, x, dy)
    wide = [torch.cat([t, torch.zeros((2, 70, 24), device=card)], dim=-1)[..., :40]
            for t in (log_a, x, dy)]
    assert not any(t.is_contiguous() for t in wide)
    for g_, w_ in zip(lru_ops.rglru_bwd(*wide), want):
        torch.testing.assert_close(g_, w_, rtol=0, atol=0)


def test_rglru_counts_with_and_without_grad(card):
    """Without grad one forward launch; with grad the Function's forward (its
    outputs the plain launch's bit for bit) and one backward call, its
    gradients ``rglru_bwd``'s bit for bit, a cotangent of the final state
    alone too."""
    log_a, x = _rglru_inputs((2, 200, 64), card, torch.bfloat16)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(15)).to(card, x.dtype)
    y0, h0 = lru_ops.rglru_scan(log_a, x, impl="pallas")
    before = dict(lru_ops.LAUNCHES)
    la, xx = log_a.clone().requires_grad_(), x.clone().requires_grad_()
    y, h = lru_ops.rglru_scan(la, xx, impl="pallas")
    torch.cuda.synchronize()
    assert lru_ops.LAUNCHES == {**before, "rglru_scan": before["rglru_scan"] + 1}
    assert torch.equal(y, y0) and torch.equal(h, h0)
    y.backward(dy)
    assert lru_ops.LAUNCHES["rglru_scan_bwd"] == before["rglru_scan_bwd"] + 1
    for g_, w_ in zip((la.grad, xx.grad), lru_ops.rglru_bwd(log_a, x, dy)):
        assert torch.equal(g_, w_)
    la.grad = xx.grad = None
    dh = torch.randn(h.shape, generator=torch.Generator().manual_seed(16)).to(card)
    lru_ops.rglru_scan(la, xx, impl="pallas")[1].backward(dh)
    for g_, w_ in zip((la.grad, xx.grad), lru_ops.rglru_bwd(log_a, x, torch.zeros_like(x), dh)):
        assert torch.equal(g_, w_)


# gmm in bf16 at MoE-like splits (M, K, N, group sizes): a prefill split
# with empty experts and a 32-row decode split over 64 experts, most empty
MOE_SPLITS = [
    (512, 256, 128, [0, 90, 0, 0, 141, 37, 0, 200, 44, 0]),
    (32, 256, 128, [0] * 20 + [3, 0, 5, 1] + [0] * 30 + [2, 9, 0, 4, 0, 8, 0, 0, 0, 0]),
]


@pytest.mark.parametrize("m,k,n,sizes", MOE_SPLITS, ids=["prefill-empty-experts", "decode-32-rows"])
def test_gmm_bf16_matches_plain_version_at_moe_splits(card, m, k, n, sizes):
    assert sum(sizes) == m
    x, w, _, gs = _inputs((m, k, n, len(sizes)), sizes, seed=7)
    xc, wc = (torch.from_numpy(a).to(card, torch.bfloat16) for a in (x, w))
    gc = torch.from_numpy(gs).to(card)
    y = ops.gmm(xc, wc, gc)
    torch.testing.assert_close(y.float(), ref.grouped_matmul_ref(xc, wc, gc).float(),
                               rtol=2e-2, atol=2e-2)


# flash_decode_int8: (b, hq, hk, s, d, kv_len) — the reference's cases
# (tests/test_kernels.py:166-168), a ragged S with GQA, MQA at D = 256, a
# head size off the 16-byte vectors, and a one-position context; then three
# heads a KV head (one of a thread's four idle), eight (two warp teams),
# 32 at D = 128 (each team two passes over the rows), kv_len = 65 of 2,081
# (the cluster's last seven splits wholly past kv_len) and kv_len = 1 with
# eight splits; kv_len 0 and -1 (a uniform softmax over all S slots, run as
# a zero query over all of them) and S + 5 (every slot live)
DECODE_CASES = [
    (1, 4, 4, 128, 32, 100),
    (2, 8, 2, 256, 64, 200),
    (1, 4, 1, 512, 64, 511),
    (2, 8, 2, 261, 64, 261),
    (1, 16, 1, 300, 256, 290),
    (2, 4, 2, 70, 48, 33),
    (1, 2, 2, 40, 128, 1),
    (1, 6, 2, 200, 64, 150),
    (1, 8, 1, 333, 128, 300),
    (1, 32, 1, 100, 128, 97),
    (1, 4, 4, 2081, 64, 65),
    (2, 8, 2, 1000, 64, 1),
    (2, 8, 2, 261, 64, 0),
    (1, 4, 1, 512, 64, -1),
    (2, 8, 2, 261, 64, 266),
]


def _decode_inputs(case, card, qdtype, seed=0, sdtype=torch.bfloat16):
    """q (B, Hq, D) and the model's int8 cache, (B, S, Hk, D) values and
    (B, S, Hk) scales (bf16 as the model keeps them, or widened to
    ``sdtype``), viewed as (B, Hk, S, D) and (B, Hk, S)."""
    b, hq, hk, s, d, _ = case
    gen = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn((b, hq, d), generator=gen, device=card).to(qdtype)
    kq, ks = quantize_kv(torch.randn((b, s, hk, d), generator=gen, device=card))
    vq, vs = quantize_kv(torch.randn((b, s, hk, d), generator=gen, device=card))
    return (q, kq.transpose(1, 2), vq.transpose(1, 2), ks.to(sdtype).transpose(1, 2),
            vs.to(sdtype).transpose(1, 2))


def _check_decode(args, kv_len):
    """One launch (counted) against ``decode_ref`` within 1e-5."""
    before = decode_ops.LAUNCHES["flash_decode_int8"]
    got = decode_ops.flash_decode_int8(*args, kv_len=kv_len)
    want = decode_ref.flash_decode_int8_ref(*args, kv_len=kv_len)
    torch.cuda.synchronize()
    assert decode_ops.LAUNCHES["flash_decode_int8"] == before + 1
    assert set(decode_ops.LAUNCHES) == {"flash_decode_int8"}
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sdtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_flash_decode_int8_matches_plain_version(card, case, qdtype, sdtype):
    _check_decode(_decode_inputs(case, card, getattr(torch, qdtype), sdtype=getattr(torch, sdtype)),
                  case[-1])


@pytest.mark.parametrize("past", [0, 1], ids=["on-the-edge", "one-past"])
@pytest.mark.parametrize("sdtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
def test_flash_decode_int8_at_a_split_edge(card, qdtype, sdtype, past):
    """qwen1.5-0.5b's served heads (Hq = Hk = 16, D = 64) at a short S, with
    kv_len ending the last split but one on this card, and one position
    past it."""
    b, hq, hk, s, d = 2, 16, 16, 600, 64
    chunk = decode_ops.split_len(b, hk, s, decode_ops.cluster_fit(card.index or 0, hq // hk, d))
    splits = -(-s // chunk)
    assert splits >= 2, chunk
    kv_len = (splits - 1) * chunk + past
    _check_decode(_decode_inputs((b, hq, hk, s, d, kv_len), card, getattr(torch, qdtype),
                                 sdtype=getattr(torch, sdtype)), kv_len)


def test_flash_decode_int8_takes_f32_scales_and_contiguous_layouts(card):
    case = (2, 8, 2, 200, 64, 150)
    q, kq, vq, ks, vs = _decode_inputs(case, card, torch.float32, seed=1)
    args = (q, kq.contiguous(), vq.contiguous(), ks.float().contiguous(), vs.float().contiguous())
    got = decode_ops.flash_decode_int8(*args, kv_len=150)
    torch.testing.assert_close(got, decode_ref.flash_decode_int8_ref(*args, kv_len=150),
                               rtol=1e-5, atol=1e-5)


def test_flash_decode_int8_reads_unaligned_views(card):
    """K and V rows one byte off the 16-byte grain (a view starting at
    column 1 of a wider cache): the byte-at-a-time reads, at D = 64."""
    b, hq, hk, s, d, kv_len = 2, 8, 2, 300, 64, 257
    q, kq, vq, ks, vs = _decode_inputs((b, hq, hk, s, d, kv_len), card, torch.bfloat16, seed=2)
    wide = torch.zeros((2, b, hk, s, d + 1), dtype=torch.int8, device=card)
    wide[0, ..., 1:], wide[1, ..., 1:] = kq, vq
    args = (q, wide[0, ..., 1:], wide[1, ..., 1:], ks, vs)
    assert args[1].data_ptr() % 16 != 0
    _check_decode(args, kv_len)


def test_flash_decode_wrapper_refuses_what_the_kernel_does_not_take(card):
    q, kq, vq, ks, vs = _decode_inputs((1, 4, 2, 64, 32, 64), card, torch.float32)
    # past the cache every slot is live, as in the reference: no refusal
    assert torch.equal(decode_ops.flash_decode_int8(q, kq, vq, ks, vs, kv_len=65),
                       decode_ops.flash_decode_int8(q, kq, vq, ks, vs, kv_len=64))
    with pytest.raises(ValueError):
        decode_ops.flash_decode_int8(q, kq[:, :, :0], vq[:, :, :0], ks[:, :, :0], vs[:, :, :0],
                                     kv_len=8)                                 # no position
    with pytest.raises(TypeError):
        decode_ops.flash_decode_int8(q.half(), kq, vq, ks, vs, kv_len=8)
    with pytest.raises(TypeError):
        decode_ops.flash_decode_int8(q, kq.float(), vq, ks, vs, kv_len=8)     # not int8
    with pytest.raises(ValueError):
        decode_ops.flash_decode_int8(q[:, :3], kq, vq, ks, vs, kv_len=8)      # 3 heads over 2
    with pytest.raises(ValueError):
        decode_ops.flash_decode_int8(q, kq, vq, ks.cpu(), vs, kv_len=8)       # mixed devices
