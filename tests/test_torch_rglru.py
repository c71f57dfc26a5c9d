"""The port's RG-LRU scan and recurrent block against the reference's, on
the CPU.

``repro_torch.kernels.rglru_scan.ops.rglru_scan`` on CPU tensors (its plain
versions; the ``"pallas"`` route takes ``ref.rglru_associative`` there)
against ``repro.kernels.rglru_scan.ops.rglru_scan`` with the same impl (the
Pallas kernel interpreted on the CPU) on the reference's sweep
(tests/test_kernels.py), ragged lengths the Pallas kernel refuses against
its oracle, an initial state, the decode step chained over a sequence, and
``rglru_forward``/``rglru_decode`` on bridged parameters.  Tolerances are
the reference's: y at f32 2e-5 or bf16 2e-2, the final state at 1e-4.  The
backward's plain version ``ref.rglru_bwd`` (and torch's autograd through the
CPU route) against ``jax.vjp`` of the reference's Pallas route (its custom
VJP) and of ``rglru_associative``, with and without a cotangent of the final
state: gradients at f32 1e-4 and bf16 2e-2.  The kernels are held against
the plain versions on the card by tests/test_torch_kernels_cuda.py and
chip_smoke.py."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.kernels.rglru_scan import ops as ref_ops
from repro.kernels.rglru_scan import ref as ref_ref
from repro.models import rglru as ref_rg
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import registry
from repro_torch.kernels.rglru_scan import ops, ref
from repro_torch.models import rglru as rg

SWEEP = [(1, 64, 32), (2, 256, 128), (2, 96, 64)]   # (b, l, w): tests/test_kernels.py:111
RAGGED = [(2, 37, 48), (1, 1, 16), (3, 300, 40)]    # lengths off the Pallas kernel's chunk
F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
STATE = dict(rtol=1e-4, atol=1e-4)


def _tol(dtype):
    return BF16 if dtype == "bfloat16" else F32


def _inputs(b, l, w, dtype, seed=0):
    """(jax arrays, torch tensors): log_a in f32, b in ``dtype``."""
    rng = np.random.default_rng(seed)
    log_a = (-np.log1p(np.exp(rng.normal(size=(b, l, w))))).astype(np.float32)
    x = rng.normal(size=(b, l, w)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return ((jnp.asarray(log_a), jnp.asarray(x, jdt)),
            (torch.from_numpy(log_a), torch.from_numpy(x).to(getattr(torch, dtype))))


def _check(got, want, dtype):
    (y, h), (want_y, want_h) = got, want
    np.testing.assert_allclose(y.float().numpy(), np.asarray(want_y, np.float32), **_tol(dtype))
    assert h.dtype == torch.float32
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **STATE)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["sequential", "associative", "pallas"])
@pytest.mark.parametrize("b,l,w", SWEEP)
def test_rglru_matches_reference(b, l, w, impl, dtype):
    jx, tx = _inputs(b, l, w, dtype)
    before = ops.LAUNCHES["rglru_scan"]
    got = ops.rglru_scan(*tx, impl=impl)
    assert ops.LAUNCHES["rglru_scan"] == before   # the CPU launches no kernel
    assert got[0].dtype == tx[1].dtype and got[0].shape == tx[1].shape
    _check(got, ref_ops.rglru_scan(*jx, impl=impl), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,w", RAGGED)
def test_ragged_lengths_match_reference_oracle(b, l, w, dtype):
    jx, tx = _inputs(b, l, w, dtype, seed=1)
    _check(ops.rglru_scan(*tx, impl="pallas"), ref_ref.rglru_associative(*jx), dtype)


@pytest.mark.parametrize("fn", ["rglru_sequential", "rglru_associative"])
def test_initial_state_matches_reference(fn):
    jx, tx = _inputs(2, 50, 24, "float32", seed=2)
    h0 = np.random.default_rng(3).normal(size=(2, 24)).astype(np.float32)
    _check(getattr(ref, fn)(*tx, h0=torch.from_numpy(h0)),
           getattr(ref_ref, fn)(*jx, h0=jnp.asarray(h0)), "float32")


def test_decode_chain_matches_scan():
    """The one-step update chained over a sequence gives the scan's outputs
    and final state, and each step equals the reference's step."""
    jx, tx = _inputs(2, 16, 24, "float32", seed=4)
    y_ref, h_ref = ref_ref.rglru_sequential(*jx)
    h, jh = torch.zeros((2, 24)), jnp.zeros((2, 24))
    ys = []
    for t in range(16):
        yt, h = ops.rglru_decode_step(h, tx[0][:, t], tx[1][:, t])
        jyt, jh = ref_ops.rglru_decode_step(jh, jx[0][:, t], jx[1][:, t])
        np.testing.assert_allclose(yt.numpy(), np.asarray(jyt), **F32)
        ys.append(yt)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), np.asarray(y_ref), **F32)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), **STATE)


def test_wrapper_refuses_tensors_off_the_cpu_and_the_card():
    """The plain version serves CPU tensors only: any other device goes to
    the kernel's checks, which refuse what the kernel cannot take."""
    t = torch.empty((1, 8, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.rglru_scan(t, t, impl="pallas")
    with pytest.raises(ValueError, match="unknown rglru impl"):
        ops.rglru_scan(t, t, impl="scan")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.rglru_bwd(t, t, t)
    assert set(ops.LAUNCHES) == {"rglru_scan", "rglru_scan_bwd"}


# ---------------------------------------------------------------- the backward

GRAD_F32 = dict(rtol=1e-4, atol=1e-4)


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


@pytest.mark.parametrize("with_state", [False, True], ids=["dy", "dy+dh_final"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["pallas", "associative"])
@pytest.mark.parametrize("b,l,w", SWEEP + RAGGED[:2])
def test_backward_matches_reference_vjp(b, l, w, route, dtype, with_state):
    jx, tx = _inputs(b, l, w, dtype, seed=7)
    rng = np.random.default_rng(8)
    dy = rng.normal(size=(b, l, w)).astype(np.float32)
    dh_final = rng.normal(size=(b, w)).astype(np.float32) if with_state else None
    want = _ref_vjp(*jx, jnp.asarray(dy), jnp.asarray(
        dh_final if with_state else np.zeros((b, w), np.float32)), route=route)
    dy_t = torch.from_numpy(dy).to(tx[1].dtype)
    dh_t = None if dh_final is None else torch.from_numpy(dh_final)
    plain = ref.rglru_bwd(*tx, dy_t, dh_t)
    # the CPU route of impl="pallas" under grad: torch's autograd, no launch
    la, x = (t.clone().requires_grad_() for t in tx)
    before = dict(ops.LAUNCHES)
    y, h = ops.rglru_scan(la, x, impl="pallas")
    assert ops.LAUNCHES == before
    outs, cots = (y, h), (dy_t, dh_t)
    used = [i for i in range(2) if cots[i] is not None]
    routed = torch.autograd.grad([outs[i] for i in used], (la, x), [cots[i] for i in used],
                                 allow_unused=True, materialize_grads=True)
    tol = GRAD_F32 if dtype == "float32" else BF16
    for name, got in (("ref.rglru_bwd", plain), ("autograd, pallas route", routed)):
        for what, g, wt, t in zip(("dlog_a", "db"), got, want, tx):
            assert g.dtype == t.dtype and g.shape == t.shape, (name, what)
            np.testing.assert_allclose(g.float().numpy(), np.asarray(wt, np.float32), **tol,
                                       err_msg=f"{name} {what}")


# ---------------------------------------------------------------- the block


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_rglru_forward_and_decode_match_reference(compute_dtype):
    over = dict(rglru_impl="pallas", compute_dtype=compute_dtype)
    ref_cfg = ref_registry.get_config("recurrentgemma-9b", reduced=True).replace(**over)
    cfg = registry.get_config("recurrentgemma-9b", reduced=True).replace(**over)
    params, _ = ref_rg.init_rglru(jax.random.PRNGKey(0), ref_cfg)
    rng = np.random.default_rng(0)   # the gate biases off their zeros
    host = {k: np.asarray(v) + rng.normal(scale=0.05, size=v.shape).astype(np.float32)
            for k, v in jax.device_get(params).items()}
    jparams = {k: jnp.asarray(v) for k, v in host.items()}
    tparams = params_from_numpy(host, "cpu")
    tol = _tol(compute_dtype)

    x = np.random.default_rng(5).normal(size=(2, 19, cfg.d_model)).astype(np.float32)
    want, want_cache = ref_rg.rglru_forward(jparams, jnp.asarray(x), ref_cfg, return_cache=True)
    out, cache = rg.rglru_forward(tparams, torch.from_numpy(x), cfg, return_cache=True)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32), **tol)
    for key in ("conv", "h"):
        assert cache[key].dtype == getattr(torch, str(want_cache[key].dtype)), key
        np.testing.assert_allclose(cache[key].float().numpy(),
                                   np.asarray(want_cache[key], np.float32), **tol)
    steps = np.random.default_rng(6).normal(size=(4, 2, 1, cfg.d_model)).astype(np.float32)
    for i, xt in enumerate(steps):
        want, want_cache = ref_rg.rglru_decode(jparams, jnp.asarray(xt), want_cache, ref_cfg)
        out, cache = rg.rglru_decode(tparams, torch.from_numpy(xt), cache, cfg)
        np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32), **tol,
                                   err_msg=f"decode step {i}")
        for key in ("conv", "h"):
            np.testing.assert_allclose(cache[key].float().numpy(),
                                       np.asarray(want_cache[key], np.float32), **tol,
                                       err_msg=f"decode step {i} {key}")


def test_init_draws_the_decay_law():
    """Λ is drawn so that a^c = exp(-c·softplus(Λ)) lies in (0.9, 0.999)."""
    cfg = registry.get_config("recurrentgemma-9b", reduced=True)
    params, _ = rg.init_rglru(torch.Generator().manual_seed(0), cfg)
    ac = torch.exp(-rg.RGLRU_C * torch.nn.functional.softplus(params["lam"]))
    assert params["lam"].dtype == torch.float32
    assert float(ac.min()) > 0.9 - 1e-6 and float(ac.max()) < 0.999 + 1e-6
