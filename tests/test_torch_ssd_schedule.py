"""The SSD-scan wrapper's host-side logic and the ``wgmma`` path's rounding, on the CPU.

``choose_path`` picks the kernel's path before the launch from the dtype,
P, N and the operands' alignment: ``wgmma`` for bf16 whose rows 16-byte
copies can read and whose N is above 32, ``ffma`` for the rest.  These
tests hold the chooser on every condition it reads.

The ``wgmma`` path feeds the tensor cores three operands in bf16 that the
reference keeps in f32: L (the intra-chunk scores C·Bᵀ ∘ seg ∘ dt), as a
bf16 hi + lo pair; S_in (the state entering a chunk, as the read-out's
operand) and x∘w (the state update's operand), each rounded once.
``wgmma_model`` below is a plain torch model of that arithmetic, chunk by
chunk at the kernel's 64 rows (``kWgQ`` in ssd_scan.cu), with an f32 state
that is never rounded.  It is held against the JAX reference's
``ssd_sequential`` by the rule the card holds the kernel to
(tests/test_torch_kernels_cuda.py, chip_smoke.py phase 10): the final state
elementwise at 2e-2; y elementwise where N <= 32 and by its relative norm
above that.  The kernel itself is held against the plain version on the
card.

The backward's ``bwd_wgmma`` path (csrc/ssd_scan_bwd_wgmma.cu) rounds more
operands: the masked score fragments, dS's copy, S_in, x∘w, dY∘exp(cs) and
the per-head dB and dC partials, each once to bf16.  ``bwd_wgmma_model``
writes its arithmetic out chunk by chunk at 64 rows and is held against
``jax.vjp`` of the reference's ``ssd_chunked`` at bf16's relative norm 2e-2
per gradient, da included; that no operand needs a hi + lo split is pinned
beside it.  ``choose_bwd_path`` is held on every condition it reads.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ref as ref_ref
from repro_torch.kernels.ssd_scan import ops

LOG2E = 1.4426950408889634
TOL = 2e-2
Q = 64   # rows of the wgmma path's chunk


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _split(t: torch.Tensor) -> torch.Tensor:
    """t as the kernel feeds a split operand: bf16 hi plus the bf16 of the rest."""
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def wgmma_model(x, dt, a, b_mat, c_mat, split_l=True):
    """The ``wgmma`` path's arithmetic in plain torch: (y in x's dtype, f32
    final state).  ``split_l=False`` rounds L once, as S_in and x∘w are."""
    bsz, l, h, p = x.shape
    g, n = b_mat.shape[2:]
    q = Q
    nc = -(-l // q)
    pad = nc * q - l

    def heads(t):   # (B, L, G or H, K) -> (B, H, L_padded, K) in f32, zero past L
        t = t.float().repeat_interleave(h // t.shape[2], dim=2)
        return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)).transpose(1, 2)

    xs, bs, cs_in = heads(x), heads(b_mat), heads(c_mat)
    dts = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad)).transpose(1, 2)   # (B, H, Lp)
    a2 = (a.float() * LOG2E)[None, :, None]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool))
    state = torch.zeros((bsz, h, p, n))
    ys = []
    for c in range(nc):
        sl = slice(c * q, (c + 1) * q)
        xc, bc, cc, d = xs[:, :, sl], bs[:, :, sl], cs_in[:, :, sl], dts[:, :, sl]
        cs = torch.cumsum(a2 * d, dim=-1)                       # log2 units, as the kernel sums them
        total = cs[..., -1:]
        arg = torch.where(tri, cs[..., :, None] - cs[..., None, :], torch.tensor(-float("inf")))
        lmat = (_split if split_l else _bf16)(cc @ bc.transpose(-1, -2) * torch.exp2(arg)
                                              * d[..., None, :])
        y = torch.exp2(cs)[..., None] * (cc @ _bf16(state).transpose(-1, -2)) + lmat @ xc
        xw = _bf16(xc * (torch.exp2(total - cs) * d)[..., None])
        state = torch.exp2(total)[..., None] * state + xw.transpose(-1, -2) @ bc
        ys.append(y)
    y = torch.cat(ys, dim=2)[:, :, :l].transpose(1, 2)
    return y.to(x.dtype), state


def _inputs(b, l, h, p, g, n, seed=0, strong=False):
    """x, B, C in bf16; dt = softplus(normal) and a = -exp(normal) in f32
    (strong: a = -exp(normal + 2), where exp(cs) underflows within a chunk
    and a factored seg would overflow)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, l, h)))).astype(np.float32)
    a = (-np.exp(rng.normal(size=(h,)) + (2.0 if strong else 0.0))).astype(np.float32)
    bm = rng.normal(size=(b, l, g, n)).astype(np.float32)
    cm = rng.normal(size=(b, l, g, n)).astype(np.float32)
    tx = (torch.from_numpy(x).bfloat16(), torch.from_numpy(dt), torch.from_numpy(a),
          torch.from_numpy(bm).bfloat16(), torch.from_numpy(cm).bfloat16())
    jx = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt), jnp.asarray(a),
          jnp.asarray(bm, jnp.bfloat16), jnp.asarray(cm, jnp.bfloat16))
    return tx, jx


def _worst(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| / (TOL + TOL |want|): above 1, assert_close at TOL fails."""
    return float(((got.float() - want).abs() / (TOL + TOL * want.abs())).max())


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want).norm() / want.norm())


# (b, l, h, p, g, n): the reference's sweep (tests/test_kernels.py:66-68)
# and G = 2 with a ragged tail, which the card runs on ffma (N <= 32) but the
# model holds all the same; then what the wgmma path takes: a length shorter
# than one chunk with P and N off 16, the smallest N it takes with a ragged
# tail, a narrow case, and served widths at a short L
CASES = [
    (1, 64, 2, 8, 1, 8),
    (2, 128, 4, 16, 2, 16),
    (1, 96, 4, 8, 1, 16),
    (2, 45, 4, 8, 2, 16),
    (1, 7, 2, 24, 1, 40),
    (2, 75, 4, 64, 2, 40),
    (2, 200, 4, 32, 1, 64),
    (1, 256, 4, 64, 1, 128),
    (2, 130, 8, 64, 2, 128),
]
# the served head size at N = 32, the widest y held elementwise
AT_32 = [(2, 75, 4, 64, 2, 32), (2, 256, 4, 64, 1, 32)]


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_wgmma_rounding_model_matches_reference(case, strong):
    tx, jx = _inputs(*case, seed=1, strong=strong)
    y, state = wgmma_model(*tx)
    want_y, want_s = (torch.from_numpy(np.array(t, np.float32))
                      for t in ref_ref.ssd_sequential(*jx))
    assert y.dtype == torch.bfloat16 and y.shape == tx[0].shape
    assert state.dtype == torch.float32 and state.shape == want_s.shape
    assert torch.isfinite(y.float()).all() and torch.isfinite(state).all()
    assert _worst(state, want_s) <= 1.0, _worst(state, want_s)
    if case[-1] <= 32:
        assert _worst(y, want_y) <= 1.0, _worst(y, want_y)
    assert _rel(y, want_y) < TOL and _rel(state, want_s) < TOL, (_rel(y, want_y), _rel(state, want_s))


def test_rounding_each_operand_once_misses_y_elementwise_at_small_n():
    """Why bf16 with N <= 32 runs on ffma: with L rounded once, y misses 2e-2
    elementwise on the reference's sweep, where a read-out over few state
    columns cancels; with L split, as the kernel does it, it holds there
    (the test above) but still misses at P = 64, N = 32."""
    worst = []
    for case in CASES[:4]:
        tx, jx = _inputs(*case, seed=1)
        want_y = torch.from_numpy(np.array(ref_ref.ssd_sequential(*jx)[0], np.float32))
        worst.append(_worst(wgmma_model(*tx, split_l=False)[0], want_y))
    assert max(worst) > 1.0, worst
    worst = []
    for case in AT_32:
        tx, jx = _inputs(*case, seed=1)
        want_y = torch.from_numpy(np.array(ref_ref.ssd_sequential(*jx)[0], np.float32))
        y = wgmma_model(*tx)[0]
        assert _rel(y, want_y) < TOL
        worst.append(_worst(y, want_y))
    assert max(worst) > 1.0, worst


@pytest.mark.parametrize("case", CASES[-3:])
def test_splitting_l_cuts_y_error(case):
    """L split into hi + lo leaves y's relative norm several times below L
    rounded once (on the card: 6.5e-4 against 2.8e-3 at the served shape)."""
    tx, jx = _inputs(*case, seed=1)
    want_y = torch.from_numpy(np.array(ref_ref.ssd_sequential(*jx)[0], np.float32))
    assert 3 * _rel(wgmma_model(*tx)[0], want_y) < _rel(wgmma_model(*tx, split_l=False)[0], want_y)


# ---------------------------------------------------------------- the backward's bwd_wgmma path

#: where ssd_scan_bwd_wgmma.cu rounds an operand to bf16 ("bf16"), feeds it
#: as a bf16 hi + lo pair ("split") or keeps it in f32 ("f32"): the masked
#: score fragments seg∘Gᵀ, seg∘Dᵀ and seg∘D∘dt (the register A operands),
#: dS's copy in shared memory, S_in as the states pass stores it, x∘w (the
#: states pass's update operand), dY∘exp(cs) (dS's update operand) and the
#: per-head dB and dC partials the group sum reads
BWD_ROUNDING = {"seg": "bf16", "ds": "bf16", "sin": "bf16", "xw": "bf16", "dyc": "bf16",
                "part": "bf16"}
_ROUND = {"f32": lambda t: t, "bf16": _bf16, "split": _split}


def bwd_wgmma_model(x, dt, a, b_mat, c_mat, dy, dstate=None, **how):
    """The ``bwd_wgmma`` path's arithmetic in plain torch, chunk by chunk at
    its 64 rows: (dx, ddt, da, dB, dC) in the kernels' dtypes.  The states
    pass carries S in f32 and keeps each chunk's entering S_in; the chunk
    pass walks the chunks last first with dS in f32, never rounded; every
    product's operands are rounded where ``how`` (over ``BWD_ROUNDING``)
    says, and every sum is f32.  d(a·dt) sums its four terms one by one as
    ``ref.ssd_bwd_chunked`` does: exp(cs_Q)⟨dS, S_in⟩, the prefix of the
    state term, the suffix of the read-out term and the crossed pairs."""
    how = {**BWD_ROUNDING, **how}
    rnd = {k: _ROUND[v] for k, v in how.items()}
    bsz, l, h, p = x.shape
    g, n = b_mat.shape[2:]
    q = Q
    nc = -(-l // q)
    pad = nc * q - l

    def heads(t):   # (B, L, G or H, K) -> (B, H, L_padded, K) in f32, zero past L
        t = t.float().repeat_interleave(h // t.shape[2], dim=2)
        return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)).transpose(1, 2)

    xs, bs, cs_in, dys = heads(x), heads(b_mat), heads(c_mat), heads(dy)
    dts = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad)).transpose(1, 2)   # (B, H, Lp)
    a2 = (a.float() * LOG2E)[None, :, None]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool))                     # [t, s]: s <= t
    rows = torch.arange(q)
    cross = (rows[None, :, None] >= rows[:, None, None]) & (rows[None, None, :] < rows[:, None, None])

    def chunk(c):
        sl = slice(c * q, (c + 1) * q)
        d = dts[:, :, sl]
        cs = torch.cumsum(a2 * d, dim=-1)                                     # log2 units
        return xs[:, :, sl], bs[:, :, sl], cs_in[:, :, sl], dys[:, :, sl], d, cs, cs[..., -1:]

    state, s_in = torch.zeros((bsz, h, p, n)), []
    for c in range(nc):
        s_in.append(rnd["sin"](state))
        xc, bc, _, _, d, cs, total = chunk(c)
        xw = rnd["xw"](xc * (torch.exp2(total - cs) * d)[..., None])
        state = torch.exp2(total)[..., None] * state + xw.transpose(-1, -2) @ bc

    ds = torch.zeros((bsz, h, p, n)) if dstate is None else dstate.float().clone()
    dx, dbp, dcp = torch.zeros_like(xs), torch.zeros_like(bs), torch.zeros_like(bs)
    ddt, da = torch.zeros_like(dts), torch.zeros((bsz, h))
    for c in reversed(range(nc)):
        xc, bc, cc, dyc, d, cs, total = chunk(c)
        sl = slice(c * q, (c + 1) * q)
        seg = torch.exp2(torch.where(tri, cs[..., :, None] - cs[..., None, :],
                                     torch.tensor(-float("inf"))))            # [t, s]
        gm, dm = cc @ bc.transpose(-1, -2), dyc @ xc.transpose(-1, -2)        # [t, s]
        w, ecs = torch.exp2(total - cs), torch.exp2(cs)
        dsb, sinb = rnd["ds"](ds), s_in[c]
        acc = w[..., None] * (bc @ dsb.transpose(-1, -2))                     # dx: rows s
        state_term = d * (xc * acc).sum(-1)
        acc = acc + rnd["seg"]((seg * gm).transpose(-1, -2)) @ dyc
        dx[:, :, sl] = d[..., None] * acc
        xdxr = (xc * acc).sum(-1)
        accb = w[..., None] * (xc @ dsb) + rnd["seg"]((seg * dm).transpose(-1, -2)) @ cc
        dbp[:, :, sl] = rnd["part"](d[..., None] * accb)
        accc = ecs[..., None] * (dyc @ sinb)                                  # dC: rows t
        term = (cc * accc).sum(-1)
        dcp[:, :, sl] = rnd["part"](accc + rnd["seg"](seg * dm * d[..., None, :]) @ bc)
        crossed = torch.einsum("rts,bhts->bhr", cross.float(), seg * gm * dm * d[..., None, :])
        prefix = torch.nn.functional.pad(torch.cumsum(state_term, -1)[..., :-1], (1, 0))
        suffix = torch.flip(torch.cumsum(torch.flip(term, (-1,)), -1), (-1,))
        e0 = torch.exp2(total[..., 0]) * (ds * sinb).sum((-1, -2))
        dadt = e0[..., None] + prefix + suffix + crossed
        ddt[:, :, sl] = xdxr + a.float()[None, :, None] * dadt
        da = da + (d * dadt).sum(-1)
        ds = torch.exp2(total)[..., None] * ds + (
            rnd["dyc"](dyc * ecs[..., None]).transpose(-1, -2) @ cc)

    def groups(t):   # per-head partials (B, H, Lp, N) -> (B, L, G, N), heads in order
        return t.reshape(bsz, g, h // g, -1, n).sum(2)[:, :, :l].transpose(1, 2)

    return (dx[:, :, :l].transpose(1, 2).to(x.dtype), ddt[:, :, :l].transpose(1, 2), da.sum(0),
            groups(dbp).to(b_mat.dtype), groups(dcp).to(c_mat.dtype))


def _cotangents(case, seed=2, with_state=True):
    b, l, h, p, g, n = case
    rng = np.random.default_rng(seed)
    dy = torch.from_numpy(rng.normal(size=(b, l, h, p)).astype(np.float32)).bfloat16()
    ds = torch.from_numpy(rng.normal(size=(b, h, p, n)).astype(np.float32)) if with_state else None
    return dy, ds


def _reference_grads(tx, dy, ds):
    """``jax.vjp`` of the reference's ``ssd_chunked`` on f32 copies of the
    same bf16 inputs and cotangents (a missing ``ds`` is 0)."""
    jx = [jnp.asarray(t.float().numpy()) for t in tx]
    _, vjp = jax.vjp(lambda *args: ref_ref.ssd_chunked(*args, chunk=Q), *jx)
    b, _, h, p = tx[0].shape
    jds = jnp.zeros((b, h, p, tx[3].shape[-1])) if ds is None else jnp.asarray(ds.numpy())
    return [torch.from_numpy(np.array(t, np.float32))
            for t in vjp((jnp.asarray(dy.float().numpy()), jds))]


GRADS = ("dx", "ddt", "da", "dB", "dC")


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_bwd_wgmma_rounding_model_matches_reference(case, strong, with_state):
    """Every gradient, da included, within bf16's relative norm 2e-2 of
    ``jax.vjp`` of the reference, on the forward's cases (ragged tails,
    G = 2, L shorter than a chunk) under a mild and a strong decay."""
    tx, _ = _inputs(*case, seed=3, strong=strong)
    dy, ds = _cotangents(case, with_state=with_state)
    got = bwd_wgmma_model(*tx, dy, ds)
    want = _reference_grads(tx, dy, ds)
    for name, gr, t, w in zip(GRADS, got, tx, want):
        assert gr.shape == t.shape and gr.dtype == t.dtype, name
        assert torch.isfinite(gr.float()).all(), name
    errs = {name: _rel(gr, w) for name, gr, w in zip(GRADS, got, want)}
    assert max(errs.values()) < TOL, errs


@pytest.mark.parametrize("case", [CASES[3], CASES[5], CASES[7]])
def test_bwd_wgmma_needs_no_split_and_takes_bf16_partials(case):
    """Why the kernel rounds every operand once, with no hi + lo pair, and
    leaves dB and dC per head in bf16: each gradient stays within 3x of the
    floor that rounding the outputs alone leaves (every operand in f32), and
    ddt and da, which are f32 outputs, within a quarter of the limit."""
    tx, _ = _inputs(*case, seed=3)
    dy, ds = _cotangents(case)
    want = _reference_grads(tx, dy, ds)
    got = bwd_wgmma_model(*tx, dy, ds)
    floor = bwd_wgmma_model(*tx, dy, ds, **{k: "f32" for k in BWD_ROUNDING})
    f32_parts = bwd_wgmma_model(*tx, dy, ds, part="f32")
    for name, gr, fl, fp, w in zip(GRADS, got, floor, f32_parts, want):
        err = _rel(gr, w)
        if name in ("ddt", "da"):
            assert err < TOL / 4, (name, err)
        else:
            assert err < 3 * _rel(fl, w), (name, err, _rel(fl, w))
            assert err < 2 * _rel(fp, w), (name, err, _rel(fp, w))


def test_bwd_wgmma_model_fails_on_rolled_b_and_c():
    """The control the card runs: B and C rolled one step along L together
    move every gradient far outside the limit (dB does not see B, nor dC C,
    but each sees the other)."""
    case = CASES[7]
    tx, _ = _inputs(*case, seed=3)
    dy, ds = _cotangents(case)
    want = _reference_grads(tx, dy, ds)
    rolled = (*tx[:3], tx[3].roll(1, dims=1), tx[4].roll(1, dims=1))
    for name, gr, w in zip(GRADS, bwd_wgmma_model(*rolled, dy, ds), want):
        assert _rel(gr, w) > 10 * TOL, name


# ---------------------------------------------------------------- the chooser


def _xbc(b=2, l=40, h=4, p=64, g=2, n=128, dtype=torch.bfloat16):
    return (torch.zeros((b, l, h, p), dtype=dtype), torch.zeros((b, l, g, n), dtype=dtype),
            torch.zeros((b, l, g, n), dtype=dtype))


@pytest.mark.parametrize("p,n", [(8, 40), (16, 48), (24, 40), (32, 64), (64, 128), (8, 128), (64, 40)])
def test_bf16_with_16_byte_rows_takes_wgmma(p, n):
    assert ops.choose_path(*_xbc(p=p, n=n)) == "wgmma"


@pytest.mark.parametrize("p,n", [(8, 8), (16, 16), (64, 8), (64, 24), (64, 32)])
def test_bf16_with_n_up_to_32_takes_ffma(p, n):
    """y is held elementwise there, which the wgmma path's bf16 operands miss."""
    assert ops.choose_path(*_xbc(p=p, n=n)) == "ffma"


@pytest.mark.parametrize("p,n", [(8, 8), (64, 128)])
def test_f32_takes_ffma(p, n):
    assert ops.choose_path(*_xbc(p=p, n=n, dtype=torch.float32)) == "ffma"


@pytest.mark.parametrize("p,n", [(4, 16), (12, 16), (20, 64), (60, 128), (16, 4), (16, 12),
                                 (64, 100), (64, 124)])
def test_bf16_p_or_n_off_8_takes_ffma(p, n):
    assert ops.choose_path(*_xbc(p=p, n=n)) == "ffma"


@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_a_stride_off_8_takes_ffma(which, axis):
    """x, B or C with a batch, length or head (group) stride that is no
    multiple of 8 elements: its rows are not 16-byte aligned."""
    t = list(_xbc())
    strides = list(t[which].stride())
    strides[axis] += 4
    base = torch.zeros(2 * t[which].numel() + 64, dtype=t[which].dtype)
    t[which] = base.as_strided(t[which].shape, strides)
    assert ops.choose_path(*t) == "ffma"
    strides[axis] += 4                                 # 8 more elements: aligned again
    t[which] = base.as_strided(t[which].shape, strides)
    assert ops.choose_path(*t) == "wgmma"


@pytest.mark.parametrize("which", [0, 1, 2])
def test_a_pointer_off_16_bytes_takes_ffma(which):
    t = list(_xbc())
    flat = torch.zeros(t[which].numel() + 1, dtype=t[which].dtype)
    t[which] = flat[1:].view(t[which].shape)
    assert t[which].data_ptr() % 16 == 2
    assert ops.choose_path(*t) == "ffma"
    flat = torch.zeros(t[which].numel() + 8, dtype=t[which].dtype)
    t[which] = flat[8:].view(t[which].shape)          # 16 bytes past an aligned start
    assert ops.choose_path(*t) == "wgmma"


def test_slices_of_a_fused_projection_keep_wgmma():
    """x, B and C as column slices of one wider projection, as a fused
    in-projection hands them over: every offset and stride a multiple of 8."""
    b, l, h, p, g, n = 2, 40, 4, 32, 2, 64
    wide = torch.zeros((b, l, h * p + 2 * g * n), dtype=torch.bfloat16)
    xv = wide[..., :h * p].unflatten(2, (h, p))
    bv = wide[..., h * p:h * p + g * n].unflatten(2, (g, n))
    cv = wide[..., h * p + g * n:].unflatten(2, (g, n))
    assert not xv.is_contiguous()
    assert ops.choose_path(xv, bv, cv) == "wgmma"
    odd = torch.zeros((b, l, h * p + 2 * g * n + 4), dtype=torch.bfloat16)   # row stride off 8
    assert ops.choose_path(odd[..., :h * p].unflatten(2, (h, p)), bv, cv) == "ffma"


# ---------------------------------------------------------------- the backward's chooser


def _xbcdy(b=2, l=40, h=4, p=64, g=2, n=128, dtype=torch.bfloat16):
    return (*_xbc(b, l, h, p, g, n, dtype), torch.zeros((b, l, h, p), dtype=dtype))


@pytest.mark.parametrize("p,n", [(8, 40), (16, 48), (24, 40), (32, 64), (64, 128), (8, 128), (64, 40)])
def test_bwd_bf16_with_16_byte_rows_takes_bwd_wgmma(p, n):
    assert ops.choose_bwd_path(*_xbcdy(p=p, n=n)) == "bwd_wgmma"


@pytest.mark.parametrize("p,n", [(8, 8), (16, 16), (64, 8), (64, 24), (64, 32)])
def test_bwd_bf16_with_n_up_to_32_takes_bwd_ffma(p, n):
    """As the forward: N <= 32 stays on the FFMA kernels."""
    assert ops.choose_bwd_path(*_xbcdy(p=p, n=n)) == "bwd_ffma"


@pytest.mark.parametrize("p,n", [(8, 40), (64, 128)])
def test_bwd_f32_takes_bwd_ffma(p, n):
    """f32 gradients are held at 1e-4 of an f64 backward: bf16 operands would miss it."""
    assert ops.choose_bwd_path(*_xbcdy(p=p, n=n, dtype=torch.float32)) == "bwd_ffma"


@pytest.mark.parametrize("p,n", [(4, 48), (12, 48), (20, 64), (60, 128), (64, 36), (64, 100),
                                 (64, 124)])
def test_bwd_bf16_p_or_n_off_8_takes_bwd_ffma(p, n):
    assert ops.choose_bwd_path(*_xbcdy(p=p, n=n)) == "bwd_ffma"


@pytest.mark.parametrize("which", [0, 1, 2, 3])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_bwd_a_stride_off_8_takes_bwd_ffma(which, axis):
    """x, B, C or dY with a batch, length or head (group) stride that is no
    multiple of 8 elements: its rows are not 16-byte aligned."""
    t = list(_xbcdy())
    strides = list(t[which].stride())
    strides[axis] += 4
    base = torch.zeros(2 * t[which].numel() + 64, dtype=t[which].dtype)
    t[which] = base.as_strided(t[which].shape, strides)
    assert ops.choose_bwd_path(*t) == "bwd_ffma"
    strides[axis] += 4                                 # 8 more elements: aligned again
    t[which] = base.as_strided(t[which].shape, strides)
    assert ops.choose_bwd_path(*t) == "bwd_wgmma"


@pytest.mark.parametrize("which", [0, 1, 2, 3])
def test_bwd_a_pointer_off_16_bytes_takes_bwd_ffma(which):
    t = list(_xbcdy())
    flat = torch.zeros(t[which].numel() + 1, dtype=t[which].dtype)
    t[which] = flat[1:].view(t[which].shape)
    assert t[which].data_ptr() % 16 == 2
    assert ops.choose_bwd_path(*t) == "bwd_ffma"
    flat = torch.zeros(t[which].numel() + 8, dtype=t[which].dtype)
    t[which] = flat[8:].view(t[which].shape)          # 16 bytes past an aligned start
    assert ops.choose_bwd_path(*t) == "bwd_wgmma"


def test_bwd_slices_of_a_fused_projection_keep_bwd_wgmma():
    """x, B and C as column slices of one wider projection and dY as a slice
    of a wider gradient: every offset and stride a multiple of 8."""
    b, l, h, p, g, n = 2, 40, 4, 32, 2, 64
    wide = torch.zeros((b, l, h * p + 2 * g * n), dtype=torch.bfloat16)
    xv = wide[..., :h * p].unflatten(2, (h, p))
    bv = wide[..., h * p:h * p + g * n].unflatten(2, (g, n))
    cv = wide[..., h * p + g * n:].unflatten(2, (g, n))
    dyv = torch.zeros((b, l, h * p + 8), dtype=torch.bfloat16)[..., :h * p].unflatten(2, (h, p))
    assert not xv.is_contiguous() and not dyv.is_contiguous()
    assert ops.choose_bwd_path(xv, bv, cv, dyv) == "bwd_wgmma"
    odd = torch.zeros((b, l, h * p + 4), dtype=torch.bfloat16)[..., :h * p].unflatten(2, (h, p))
    assert ops.choose_bwd_path(xv, bv, cv, odd) == "bwd_ffma"


def test_a_forced_bwd_path_raises_where_it_does_not_take_the_operands():
    """``ssd_bwd(..., path=)``'s host check: bwd_wgmma refuses f32 and
    unaligned bf16; bwd_ffma takes anything; an unknown path raises."""
    assert ops._bwd_path(*_xbcdy(), None) == "bwd_wgmma"
    assert ops._bwd_path(*_xbcdy(), "bwd_ffma") == "bwd_ffma"
    with pytest.raises(ValueError, match="bwd_wgmma path takes bfloat16"):
        ops._bwd_path(*_xbcdy(dtype=torch.float32), "bwd_wgmma")
    with pytest.raises(ValueError, match="bwd_wgmma path takes bfloat16"):
        ops._bwd_path(*_xbcdy(n=32), "bwd_wgmma")
    with pytest.raises(ValueError, match="unknown path"):
        ops._bwd_path(*_xbcdy(), "wgmma")
    assert ops.BWD_PATHS == ("bwd_ffma", "bwd_wgmma")


def test_the_backward_takes_cuda_tensors_only():
    """The CPU route trains through ``ssd_chunked`` with torch's autograd;
    ``ssd_bwd`` itself is the kernels' and refuses CPU tensors on either path."""
    tx, _ = _inputs(1, 20, 2, 8, 1, 48)
    dy = torch.zeros_like(tx[0])
    for path in (None, "bwd_wgmma", "bwd_ffma"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            ops.ssd_bwd(*tx, dy, path=path)


def test_the_cpu_takes_the_plain_version_on_every_path():
    """A forced path means nothing on the CPU: the plain version serves it
    and nothing launches."""
    tx, _ = _inputs(1, 20, 2, 8, 1, 16)
    before = (ops.LAUNCHES["ssd_scan"], dict(ops.PATH_LAUNCHES))
    before_bwd = ops.LAUNCHES["ssd_scan_bwd"]
    want = ops.ssd(*tx, chunk=16, impl="chunked")
    for path in (None, "wgmma", "ffma"):
        got = ops.ssd(*tx, chunk=16, impl="pallas", path=path)
        for g_, w_ in zip(got, want):
            torch.testing.assert_close(g_, w_, rtol=0, atol=0)
    assert (ops.LAUNCHES["ssd_scan"], ops.PATH_LAUNCHES) == before
    # the forward's paths, and the backward's
    assert set(ops.PATH_LAUNCHES) == set(ops.PATHS) | set(ops.BWD_PATHS)
    assert set(ops.PATHS) == {"ffma", "wgmma"}
    # under grad on the CPU: the plain version's autograd, and still no launch
    leaves = [t.clone().requires_grad_() for t in tx]
    y, _ = ops.ssd(*leaves, chunk=16, impl="pallas")
    grads = torch.autograd.grad(y.float().sum(), leaves)
    want = torch.autograd.grad(ops.ssd(*leaves, chunk=16, impl="chunked")[0].float().sum(), leaves)
    for g_, w_ in zip(grads, want):
        torch.testing.assert_close(g_, w_, rtol=0, atol=0)
    assert ops.LAUNCHES["ssd_scan_bwd"] == before_bwd and ops.PATH_LAUNCHES == before[1]
