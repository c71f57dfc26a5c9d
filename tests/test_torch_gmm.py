"""The port's grouped matmul against the reference's: forward against
``grouped_matmul(impl="pallas")`` (the Pallas kernel, interpreted on the
CPU) and gradients against the reference's custom VJP and its ``tgmm_ref``
oracle.  Tolerances are the reference's own (tests/test_kernels.py):
f32 2e-5, bf16 2e-2, grads 1e-5.  On the CPU the port runs its plain
versions; the kernels are held against those on the card by
tests/test_torch_kernels_cuda.py and by chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.grouped_matmul import ops as ref_ops
from repro.kernels.grouped_matmul import ref as ref_ref
from repro_torch.kernels.grouped_matmul import ops, ref

SHAPES = [(128, 32, 64, 4), (256, 64, 96, 8), (64, 16, 32, 3)]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _inputs(m, kdim, n, groups, seed=0, sizes=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, kdim)).astype(np.float32)
    # weights at the client model's init scale (±1/√fan_in), so outputs and
    # grads are O(1) as in training and the stated tolerances measure the
    # summation order, not the magnitude of random weights
    w = (rng.normal(size=(groups, kdim, n)) / np.sqrt(kdim)).astype(np.float32)
    if sizes is None:  # random group sizes incl. empty groups
        cuts = np.sort(rng.integers(0, m + 1, size=groups - 1))
        sizes = np.diff(np.concatenate([[0], cuts, [m]]))
    return x, w, np.asarray(sizes, np.int32)


def _cases():
    cases = [(s, None) for s in SHAPES]
    # explicit empty groups: the first, a middle and the last group
    cases.append(((96, 16, 40, 5), [0, 30, 0, 66, 0]))
    return cases


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,sizes", _cases())
def test_forward_matches_reference_pallas(shape, sizes, dtype):
    x, w, gs = _inputs(*shape, sizes=sizes)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = ref_ops.grouped_matmul(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                                  jnp.asarray(gs), impl="pallas", interpret=True)
    tdt = getattr(torch, dtype)
    got = ops.grouped_matmul(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                             torch.from_numpy(gs))
    assert got.dtype == tdt and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **_tol(dtype))


@pytest.mark.parametrize("shape,sizes", _cases())
def test_grads_match_reference_vjp_and_tgmm_oracle(shape, sizes):
    x, w, gs = _inputs(*shape, seed=1, sizes=sizes)

    def f(xx, ww):
        return (ref_ops.grouped_matmul(xx, ww, jnp.asarray(gs), impl="pallas") ** 2).sum()

    gx_ref, gw_ref = jax.grad(f, (0, 1))(jnp.asarray(x), jnp.asarray(w))
    y_ref = ref_ops.grouped_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs),
                                   impl="pallas")
    dw_oracle = ref_ref.tgmm_ref(jnp.asarray(x), 2.0 * y_ref, jnp.asarray(gs), w.shape[0])

    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    (ops.grouped_matmul(xt, wt, torch.from_numpy(gs)) ** 2).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_ref), **tol)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_ref), **tol)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_oracle), **tol)


def test_plain_versions_match_reference_oracles_with_trailing_rows():
    """Rows past the last group are zero (as the one-hot oracle gives), and
    an empty group's dw is exactly zero."""
    x, w, gs = _inputs(40, 8, 6, 3, seed=2, sizes=[10, 0, 20])  # 10 rows uncovered
    dy = np.random.default_rng(3).normal(size=(40, 6)).astype(np.float32)
    y = ref.grouped_matmul_ref(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(gs))
    want = ref_ref.grouped_matmul_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    assert not y[30:].any()
    dw = ref.tgmm_ref(torch.from_numpy(x), torch.from_numpy(dy), torch.from_numpy(gs), 3)
    dw_want = ref_ref.tgmm_ref(jnp.asarray(x), jnp.asarray(dy), jnp.asarray(gs), 3)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_want), rtol=2e-5, atol=2e-5)
    assert not dw[1].any()
