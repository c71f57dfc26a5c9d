"""The port's SSD scan and Mamba-2 mixer against the reference's, on the CPU.

``repro_torch.kernels.ssd_scan.ops.ssd`` on CPU tensors (its plain versions;
the ``"pallas"`` route takes ``ref.ssd_chunked`` there) against
``repro.kernels.ssd_scan.ops.ssd`` with the same impl (the Pallas kernel
interpreted on the CPU) on the reference's sweep (tests/test_kernels.py),
the plain versions with an initial state and a ragged tail, the decode step
chained over a sequence, and ``mamba2_forward``/``mamba2_decode`` on bridged
parameters.  Tolerances are the reference's: f32 2e-5, bf16 2e-2.  The
backward's two plain versions, ``ref.ssd_bwd_ref`` (autograd through
``ssd_chunked``) and ``ref.ssd_bwd_chunked`` (written out, in the backward
kernels' loop structure), are held against ``jax.vjp`` of the reference's
Pallas route (its custom VJP) and of its ``ssd_chunked``: f32 1e-4 (the
reference's grads tolerance), bf16 2e-2.  The kernels are held against the
plain versions on the card by tests/test_torch_kernels_cuda.py and
chip_smoke.py."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.kernels.ssd_scan import ops as ref_ops
from repro.kernels.ssd_scan import ref as ref_ref
from repro.models import mamba2 as ref_m2
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import registry
from repro_torch.kernels.ssd_scan import ops, ref
from repro_torch.models import mamba2 as m2

# (b, l, h, p, g, n, chunk): tests/test_kernels.py:66-68 — G = 1, G = 2, and
# L not a multiple of the chunk (the dt = 0 padding path)
SWEEP = [
    (1, 64, 2, 8, 1, 8, 16),
    (2, 128, 4, 16, 2, 16, 32),
    (1, 96, 4, 8, 1, 16, 32),
]
F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _tol(dtype):
    return BF16 if dtype == "bfloat16" else F32


def _inputs(b, l, h, p, g, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, l, h)))).astype(np.float32)   # softplus
    a = (-np.exp(rng.normal(size=(h,)))).astype(np.float32)
    bm = rng.normal(size=(b, l, g, n)).astype(np.float32)
    cm = rng.normal(size=(b, l, g, n)).astype(np.float32)
    return x, dt, a, bm, cm


def _both(arrays, dtype):
    """(jax arrays, torch tensors): x, B and C in ``dtype``, dt and a in f32."""
    x, dt, a, bm, cm = arrays
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jx = (jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(a), jnp.asarray(bm, jdt),
          jnp.asarray(cm, jdt))
    tx = (torch.from_numpy(x).to(tdt), torch.from_numpy(dt), torch.from_numpy(a),
          torch.from_numpy(bm).to(tdt), torch.from_numpy(cm).to(tdt))
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["sequential", "chunked", "pallas"])
@pytest.mark.parametrize("b,l,h,p,g,n,chunk", SWEEP)
def test_ssd_matches_reference(b, l, h, p, g, n, chunk, impl, dtype):
    jx, tx = _both(_inputs(b, l, h, p, g, n), dtype)
    want_y, want_s = ref_ops.ssd(*jx, chunk=chunk, impl=impl)
    before = ops.LAUNCHES["ssd_scan"]
    y, s = ops.ssd(*tx, chunk=chunk, impl=impl)
    assert ops.LAUNCHES["ssd_scan"] == before   # the CPU launches no kernel
    assert y.dtype == tx[0].dtype and y.shape == tx[0].shape
    assert s.dtype == torch.float32 and s.shape == (b, h, p, n)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(want_y, np.float32), **_tol(dtype))
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s, np.float32), **_tol(dtype))


@pytest.mark.parametrize("fn", ["ssd_sequential", "ssd_chunked"])
def test_initial_state_and_ragged_tail_match_reference(fn):
    """An initial state, G = 2 and L = 45 against a chunk of 16."""
    arrays = _inputs(2, 45, 4, 8, 2, 16, seed=1)
    s0 = np.random.default_rng(2).normal(size=(2, 4, 8, 16)).astype(np.float32)
    jx, tx = _both(arrays, "float32")
    kw = {"chunk": 16} if fn == "ssd_chunked" else {}
    want_y, want_s = getattr(ref_ref, fn)(*jx, init_state=jnp.asarray(s0), **kw)
    y, s = getattr(ref, fn)(*tx, init_state=torch.from_numpy(s0), **kw)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **F32)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **F32)


@pytest.mark.parametrize("g", [1, 2])
def test_decode_chain_matches_scan(g):
    """The one-token update chained over a sequence gives the scan's outputs
    and final state, and each step equals the reference's step."""
    b, l, h, p, n = 2, 8, 4, 4, 8
    jx, tx = _both(_inputs(b, l, h, p, g, n, seed=3), "float32")
    y_ref, s_ref = ref_ref.ssd_sequential(*jx)
    x, dt, a, bm, cm = tx
    st, jst = torch.zeros((b, h, p, n)), jnp.zeros((b, h, p, n))
    ys = []
    for t in range(l):
        yt, st = ops.ssd_decode_step(st, x[:, t], dt[:, t], a, bm[:, t], cm[:, t])
        jyt, jst = ref_ops.ssd_decode_step(jst, jx[0][:, t], jx[1][:, t], jx[2], jx[3][:, t],
                                           jx[4][:, t])
        np.testing.assert_allclose(yt.numpy(), np.asarray(jyt), **F32)
        ys.append(yt)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(s_ref), rtol=1e-5, atol=1e-5)


def test_wrapper_refuses_tensors_off_the_cpu_and_the_card():
    """The plain version serves CPU tensors only: any other device goes to
    the kernel's checks, which refuse what the kernel cannot take."""
    x = torch.empty((1, 8, 2, 4), device="meta")
    dt, a = torch.empty((1, 8, 2), device="meta"), torch.empty((2,), device="meta")
    bc = torch.empty((1, 8, 1, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.ssd(x, dt, a, bc, bc, impl="pallas")
    with pytest.raises(ValueError, match="CUDA tensors"):      # under grad too
        ops.ssd(x.requires_grad_(), dt, a, bc, bc, impl="pallas")
    with pytest.raises(ValueError, match="unknown ssd impl"):
        ops.ssd(x, dt, a, bc, bc, impl="scan")
    assert set(ops.LAUNCHES) == {"ssd_scan", "ssd_scan_bwd"}


# ---------------------------------------------------------------- the backward

# the sweep, and G = 2 with L = 45 against a chunk of 16 (a ragged tail)
GRAD_CASES = SWEEP + [(2, 45, 4, 8, 2, 16, 16)]
GRAD_TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("reference", ["pallas", "ssd_chunked"])
@pytest.mark.parametrize("b,l,h,p,g,n,chunk", GRAD_CASES)
def test_grads_match_reference_vjp(b, l, h, p, g, n, chunk, reference, with_state, dtype):
    """dx, ddt, da, dB, dC of both plain backwards against ``jax.vjp`` of the
    reference's ``ssd(impl="pallas")`` (its Pallas forward interpreted and
    its custom VJP) or of its ``ssd_chunked``, for a cotangent of y and, with
    ``with_state``, of the final state (else 0 there, None here)."""
    jx, tx = _both(_inputs(b, l, h, p, g, n, seed=4), dtype)
    rng = np.random.default_rng(5)
    dy = rng.normal(size=(b, l, h, p)).astype(np.float32)
    ds = rng.normal(size=(b, h, p, n)).astype(np.float32) * with_state
    if reference == "pallas":
        fn = functools.partial(ref_ops.ssd, chunk=chunk, impl="pallas", interpret=True)
    else:
        fn = functools.partial(ref_ref.ssd_chunked, chunk=chunk)
    _, vjp = jax.vjp(fn, *jx)
    want = vjp((jnp.asarray(dy, jx[0].dtype), jnp.asarray(ds)))
    tdy, tds = torch.from_numpy(dy).to(tx[0].dtype), torch.from_numpy(ds) if with_state else None
    for how, got in (("ssd_bwd_ref", ref.ssd_bwd_ref(*tx, tdy, tds, chunk=chunk)),
                     ("ssd_bwd_chunked", ref.ssd_bwd_chunked(*tx, tdy, tds))):
        for name, gr, t, w in zip(("dx", "ddt", "da", "dB", "dC"), got, tx, want):
            assert gr.dtype == t.dtype and gr.shape == t.shape, (how, name)
            np.testing.assert_allclose(gr.float().numpy(), np.asarray(w, np.float32),
                                       **GRAD_TOL[dtype], err_msg=f"{how} {name}")


def test_the_chunked_backward_does_not_depend_on_its_chunk():
    """``ssd_bwd_chunked`` at the kernels' 32 rows, at 8 and at one chunk
    over the whole length compute one gradient (the chunk orders the sums)."""
    _, tx = _both(_inputs(2, 45, 4, 8, 2, 16, seed=6), "float32")
    rng = np.random.default_rng(7)
    dy = torch.from_numpy(rng.normal(size=(2, 45, 4, 8)).astype(np.float32))
    ds = torch.from_numpy(rng.normal(size=(2, 4, 8, 16)).astype(np.float32))
    want = ref.ssd_bwd_chunked(*tx, dy, ds)
    for chunk in (8, 45):
        for w, gr in zip(want, ref.ssd_bwd_chunked(*tx, dy, ds, chunk=chunk)):
            np.testing.assert_allclose(gr.numpy(), w.numpy(), **GRAD_TOL["float32"])


# ---------------------------------------------------------------- the mixer


def _mixer(compute_dtype, seed=0):
    over = dict(ssm_impl="pallas", compute_dtype=compute_dtype)
    ref_cfg = ref_registry.get_config("mamba2-1.3b", reduced=True).replace(**over)
    cfg = registry.get_config("mamba2-1.3b", reduced=True).replace(**over)
    params, _ = ref_m2.init_mamba2(jax.random.PRNGKey(seed), ref_cfg)
    rng = np.random.default_rng(seed)   # norm scale, dt bias and D skip off their 1s and 0s
    host = {k: np.asarray(v) + rng.normal(scale=0.05, size=v.shape).astype(np.float32)
            for k, v in jax.device_get(params).items()}
    return ref_cfg, cfg, host, params_from_numpy(host, "cpu")


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_mamba2_forward_and_decode_match_reference(compute_dtype):
    ref_cfg, cfg, host, params = _mixer(compute_dtype)
    tol = _tol(compute_dtype)
    jparams = {k: jnp.asarray(v) for k, v in host.items()}
    x = np.random.default_rng(5).normal(size=(2, 21, cfg.d_model)).astype(np.float32)
    want, want_cache = ref_m2.mamba2_forward(jparams, jnp.asarray(x), ref_cfg, return_cache=True)
    out, cache = m2.mamba2_forward(params, torch.from_numpy(x), cfg, return_cache=True)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32), **tol)
    for key in ("conv", "ssm"):
        assert cache[key].dtype == getattr(torch, str(want_cache[key].dtype)), key
        np.testing.assert_allclose(cache[key].float().numpy(),
                                   np.asarray(want_cache[key], np.float32), **tol)
    steps = np.random.default_rng(6).normal(size=(4, 2, 1, cfg.d_model)).astype(np.float32)
    for i, xt in enumerate(steps):
        want, want_cache = ref_m2.mamba2_decode(jparams, jnp.asarray(xt), want_cache, ref_cfg)
        out, cache = m2.mamba2_decode(params, torch.from_numpy(xt), cache, cfg)
        np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32), **tol,
                                   err_msg=f"decode step {i}")
        for key in ("conv", "ssm"):
            np.testing.assert_allclose(cache[key].float().numpy(),
                                       np.asarray(want_cache[key], np.float32), **tol,
                                       err_msg=f"decode step {i} {key}")


def test_causal_depthwise_conv_matches_reference():
    rng = np.random.default_rng(7)
    for l in (1, 2, 9):   # shorter than, and longer than, the width
        u = rng.normal(size=(2, l, 6)).astype(np.float32)
        w = rng.normal(size=(4, 6)).astype(np.float32)
        want = ref_m2.causal_depthwise_conv(jnp.asarray(u), jnp.asarray(w))
        got = m2.causal_depthwise_conv(torch.from_numpy(u), torch.from_numpy(w))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
