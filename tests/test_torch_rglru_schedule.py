"""The RG-LRU backward's ``bwd_onchip`` decomposition and its dispatch, on the CPU.

``csrc/rglru_scan_bwd_onchip.cu`` reads log_a, b and dy once into
registers and computes the backward on chip: a block owns 32 lanes of W and
``warps`` segments of L (``steps`` a segment), and where L needs more than
one block, ``cluster`` blocks of a lane tile exchange summaries through
distributed shared memory (``ops.onchip_schedule`` picks the three).
``onchip_model`` below follows the kernel step for step in f32: the
identity past a segment's end, each segment forward from h = 0 and in
reverse from a zero carry, warp 0's fold of a block's segments, the
cluster's exchange (blocks before a block for the state, those after it,
last first, for the carry), each segment's fold of the block's segments
before and after it, then h from the entering state and the gradients from
the entering carry; every ``fmaf`` of the kernel rounded once.  It is held
against ``jax.vjp`` of the reference's Pallas route (the kernel
interpreted, its custom VJP) and of ``rglru_associative`` at the
reference's limits (f32 1e-4, bf16 2e-2), with and without a cotangent of
the final state, at L = 1, 37, 128 and the capacity, at a W that is not a
multiple of the lane tile, and under a strong decay; log_a and b rolled
one step along L must fail.  ``choose_bwd_path`` and the refusal of a
forced ``bwd_onchip`` above the capacity are held from shapes alone.  The
kernel itself is held against the plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py phase 32).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.rglru_scan import ops as ref_ops
from repro.kernels.rglru_scan import ref as ref_ref
from repro_torch.kernels.rglru_scan import ops

CAP = ops.ONCHIP_MAX_L
GRAD_F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
# (B, L, W): W = 40 and 72 are not multiples of the 32-lane tile
CASES = [(2, 1, 40), (2, 37, 40), (2, 128, 40), (1, CAP, 72)]


def _fma(a, b, c):
    """``fmaf``: a·b + c rounded once to f32 (the f64 product is exact)."""
    return (a.double() * b.double() + c.double()).float()


def onchip_model(log_a, b, dy, dh_final=None):
    """The ``bwd_onchip`` kernel's arithmetic in plain torch, f32: (dlog_a
    in log_a's dtype, db in b's dtype)."""
    bs, l, w = b.shape
    steps, warps, cluster = ops.onchip_schedule(l)
    wp = -(-w // ops.ONCHIP_LANES) * ops.ONCHIP_LANES
    lp = steps * warps * cluster
    g = dy.float()
    if dh_final is not None:
        g = torch.cat([g[:, :-1], g[:, -1:] + dh_final.float()[:, None]], dim=1)

    def tile(t):   # (B, L, W) -> (B, cluster, warps, steps, W padded), 0 past the ends
        t = F.pad(t.float(), (0, wp - w, 0, lp - l))
        return t.reshape(bs, cluster, warps, steps, wp)

    a, x, g = torch.exp(tile(log_a)), tile(b), tile(g)   # exp(0) = 1: the identity
    # each segment from h = 0 and from a zero carry
    prod, hl, cl = torch.ones_like(a[..., 0, :]), torch.zeros_like(a[..., 0, :]), \
        torch.zeros_like(a[..., 0, :])
    for i in range(steps):
        hl = _fma(a[..., i, :], hl, x[..., i, :])
        prod = prod * a[..., i, :]
    for i in reversed(range(steps)):
        cl = a[..., i, :] * (g[..., i, :] + cl)
    # warp 0 folds its block's segments; the cluster's blocks exchange
    h_blk, c_blk = torch.zeros_like(prod[:, :, 0]), torch.zeros_like(prod[:, :, 0])
    if cluster > 1:
        pa, ph, pc = torch.ones_like(h_blk), torch.zeros_like(h_blk), torch.zeros_like(h_blk)
        for j in range(warps):
            ph = _fma(prod[:, :, j], ph, hl[:, :, j])
            pa = pa * prod[:, :, j]
        for j in reversed(range(warps)):
            pc = _fma(prod[:, :, j], pc, cl[:, :, j])
        for rank in range(cluster):
            h, c = torch.zeros_like(pa[:, 0]), torch.zeros_like(pa[:, 0])
            for r in range(rank):
                h = _fma(pa[:, r], h, ph[:, r])
            for r in range(cluster - 1, rank, -1):
                c = _fma(pa[:, r], c, pc[:, r])
            h_blk[:, rank], c_blk[:, rank] = h, c
    # each segment folds its block's segments before and after its own
    h_in, c_in = torch.empty_like(prod), torch.empty_like(prod)
    for k in range(warps):
        h, c = h_blk, c_blk
        for j in range(k):
            h = _fma(prod[:, :, j], h, hl[:, :, j])
        for j in range(warps - 1, k, -1):
            c = _fma(prod[:, :, j], c, cl[:, :, j])
        h_in[:, :, k], c_in[:, :, k] = h, c
    # h from the entering state over b, then the gradients from the entering carry
    hs, h = torch.empty_like(x), h_in
    for i in range(steps):
        h = _fma(a[..., i, :], h, x[..., i, :])
        hs[..., i, :] = h
    dlog_a, db, c = torch.empty_like(x), torch.empty_like(x), c_in
    for i in reversed(range(steps)):
        dh = g[..., i, :] + c
        dlog_a[..., i, :] = dh * a[..., i, :] * (h_in if i == 0 else hs[..., i - 1, :])
        db[..., i, :] = dh
        c = a[..., i, :] * dh

    def cut(t):
        return t.reshape(bs, lp, wp)[:, :l, :w]

    return cut(dlog_a).to(log_a.dtype), cut(db).to(b.dtype)


def _inputs(b, l, w, dtype, strong=False, seed=7):
    """(jax arrays, torch tensors): log_a = -softplus(normal) in f32 (times
    30 under a strong decay: segment products underflow), b in ``dtype``."""
    rng = np.random.default_rng(seed)
    log_a = -np.log1p(np.exp(rng.normal(size=(b, l, w)))) * (30.0 if strong else 1.0)
    log_a = log_a.astype(np.float32)
    x = rng.normal(size=(b, l, w)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return ((jnp.asarray(log_a), jnp.asarray(x, jdt)),
            (torch.from_numpy(log_a), torch.from_numpy(x).to(getattr(torch, dtype))))


def _cotangents(b, l, w, with_state, seed=8):
    rng = np.random.default_rng(seed)
    dy = rng.normal(size=(b, l, w)).astype(np.float32)
    dh = rng.normal(size=(b, w)).astype(np.float32) if with_state else None
    return dy, dh


@functools.partial(jax.jit, static_argnames="route")
def _ref_vjp(log_a, x, dy, dh_final, route):
    """(dlog_a, db) of the reference: ``jax.vjp`` of its Pallas route (the
    kernel interpreted, its custom VJP) or of ``rglru_associative``."""
    if route == "pallas":
        fn = functools.partial(ref_ops._rglru_pallas_dif, interpret=True)
    else:
        fn = ref_ref.rglru_associative
    _, vjp = jax.vjp(fn, log_a, x)
    return vjp((dy.astype(x.dtype), dh_final))


def _model_and_reference(case, dtype, with_state, route, strong=False):
    jx, tx = _inputs(*case, dtype, strong=strong)
    dy, dh = _cotangents(*case, with_state)
    want = _ref_vjp(*jx, jnp.asarray(dy), jnp.asarray(
        dh if with_state else np.zeros((case[0], case[2]), np.float32)), route=route)
    dy_t = torch.from_numpy(dy).to(tx[1].dtype)
    dh_t = None if dh is None else torch.from_numpy(dh)
    return tx, dy_t, dh_t, [torch.from_numpy(np.array(t, np.float32)) for t in want]


def _close(got, want, dtype):
    tol = GRAD_F32 if dtype == "float32" else BF16
    return [bool(torch.allclose(g_.float(), w_, **tol)) for g_, w_ in zip(got, want)]


def _worst(got, want):
    return [float((g_.float() - w_).abs().max()) for g_, w_ in zip(got, want)]


@pytest.mark.parametrize("with_state", [False, True], ids=["dy", "dy+dh_final"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["pallas", "associative"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"L{c[1]}")
def test_onchip_model_matches_reference_vjp(case, route, dtype, with_state):
    """dlog_a and db of the decomposition within f32 1e-4 or bf16 2e-2 of
    ``jax.vjp`` of the reference, in the inputs' dtypes."""
    tx, dy, dh, want = _model_and_reference(case, dtype, with_state, route)
    got = onchip_model(*tx, dy, dh)
    for gr, t in zip(got, tx):
        assert gr.dtype == t.dtype and gr.shape == t.shape and torch.isfinite(gr.float()).all()
    assert all(_close(got, want, dtype)), _worst(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [(2, 37, 40), (2, 300, 40), (1, 2049, 72), (1, CAP, 72)],
                         ids=lambda c: f"L{c[1]}")
def test_onchip_model_matches_reference_under_strong_decay(case, dtype):
    """Segment and block products that underflow to 0, at one block, a
    cluster of 3, the first L with 9 segments a block, and the capacity."""
    tx, dy, dh, want = _model_and_reference(case, dtype, True, "associative", strong=True)
    got = onchip_model(*tx, dy, dh)
    assert all(_close(got, want, dtype)), _worst(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_onchip_model_fails_on_rolled_log_a_and_b(dtype):
    """The control the card runs: log_a and b rolled one step along L
    together move both gradients outside the limit (db does not see b)."""
    tx, dy, dh, want = _model_and_reference((2, 128, 40), dtype, True, "associative")
    rolled = onchip_model(*(t.roll(1, dims=1) for t in tx), dy, dh)
    assert not any(_close(rolled, want, dtype)), _worst(rolled, want)


@pytest.mark.parametrize("length", [1, 37, 128, 129, 256, 257, 1024, 1025, 2048, 2049, 3000,
                                    CAP])
def test_onchip_schedule_covers_l_within_the_kernel_limits(length):
    """steps <= 32, segments <= 16, blocks <= 8 (the portable cluster), the
    segments cover L and the last block holds steps of L: 8 segments a
    block of up to 16 steps (the short kernel) up to L = 1024, of up to 32
    up to L = 2048, more segments above it."""
    steps, warps, cluster = ops.onchip_schedule(length)
    assert 1 <= steps <= ops.ONCHIP_STEPS and 1 <= warps <= ops.ONCHIP_MAX_WARPS
    assert 1 <= cluster <= ops.ONCHIP_MAX_CLUSTER
    assert steps * warps * cluster >= length > steps * warps * (cluster - 1)
    assert warps == 8 if length <= 2048 else warps > 8
    assert (steps <= 16) == (length <= 1024)


def test_onchip_schedule_at_the_model_shapes_and_refuses_past_the_capacity():
    """recurrentgemma's training L (128) in one block of 8 segments of 16
    steps, the serve L (2048) in clusters of 8 blocks of 8 x 32, the
    capacity (4096) in clusters of 8 blocks of 16 x 32."""
    assert ops.onchip_schedule(128) == (16, 8, 1)
    assert ops.onchip_schedule(2048) == (32, 8, 8)
    assert ops.onchip_schedule(CAP) == (32, 16, 8)
    assert CAP == 4096
    for length in (0, CAP + 1):
        with pytest.raises(ValueError, match="on-chip path"):
            ops.onchip_schedule(length)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length,path", [(1, "bwd_onchip"), (128, "bwd_onchip"),
                                         (CAP, "bwd_onchip"), (CAP + 1, "bwd_fourpass")])
def test_choose_bwd_path_picks_by_l_alone(length, path, dtype):
    log_a = torch.empty((2, length, 40))
    assert ops.choose_bwd_path(log_a, log_a.to(dtype)) == path
    assert ops._bwd_path(log_a, log_a.to(dtype), None) == path


def test_bwd_path_refuses_onchip_past_the_capacity_from_shapes_alone():
    """A forced path is checked before any launch, on CPU tensors: the
    four-pass path takes every L, the on-chip one raises above the capacity."""
    short, long = torch.empty((1, CAP, 8)), torch.empty((1, CAP + 1, 8))
    assert ops._bwd_path(short, short, "bwd_onchip") == "bwd_onchip"
    for t in (short, long):
        assert ops._bwd_path(t, t, "bwd_fourpass") == "bwd_fourpass"
    with pytest.raises(ValueError, match="bwd_onchip path takes L <= 4096"):
        ops._bwd_path(long, long, "bwd_onchip")
    with pytest.raises(ValueError, match="unknown path"):
        ops._bwd_path(short, short, "bwd_wgmma")
    assert set(ops.PATH_LAUNCHES) == set(ops.BWD_PATHS)
    assert set(ops.BWD_LAUNCHES) == {"reverse_scan", "onchip"}
