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
"""
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


def test_the_cpu_takes_the_plain_version_on_every_path():
    """A forced path means nothing on the CPU: the plain version serves it
    and nothing launches."""
    tx, _ = _inputs(1, 20, 2, 8, 1, 16)
    before = (ops.LAUNCHES["ssd_scan"], dict(ops.PATH_LAUNCHES))
    want = ops.ssd(*tx, chunk=16, impl="chunked")
    for path in (None, "wgmma", "ffma"):
        got = ops.ssd(*tx, chunk=16, impl="pallas", path=path)
        for g_, w_ in zip(got, want):
            torch.testing.assert_close(g_, w_, rtol=0, atol=0)
    assert (ops.LAUNCHES["ssd_scan"], ops.PATH_LAUNCHES) == before
    # the forward's paths, and the backward's one
    assert set(ops.PATH_LAUNCHES) == set(ops.PATHS) | {"bwd_ffma"}
    assert set(ops.PATHS) == {"ffma", "wgmma"}
