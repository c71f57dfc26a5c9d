"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card (the kernels have no CPU mode) and skip
without one.  They import neither JAX nor the reference package, so they
run where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.grouped_matmul import ops, ref

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
