"""The port's flash attention against the reference's, on the CPU.

``repro_torch.kernels.flash_attention.ops.flash_attention`` on CPU tensors
(its plain version) against ``repro.kernels.flash_attention.ops.
flash_attention`` (the Pallas kernel, interpreted on the CPU) on the
reference's own sweep (tests/test_kernels.py) and a suffix case, and
against the reference's oracle where the Pallas kernel's tiling refuses the
shape.  Tolerances are the reference's: f32 2e-5, bf16 2e-2.  The
gradients (torch's autograd through the plain version, the CPU's path)
against ``jax.vjp`` of the reference's ``flash_attention`` (the Pallas
forward interpreted, its custom VJP through ``attention_chunked``) on the
reference's grads case and the sweep: f32 1e-4 (the reference's grads
tolerance), bf16 2e-2.  The kernels are held against the plain versions on
the card by tests/test_torch_kernels_cuda.py and chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as ref_ops
from repro.kernels.flash_attention import ref as ref_ref
from repro_torch.kernels.flash_attention import ops, ref

# (b, sq, skv, hq, hk, d, causal, window): tests/test_kernels.py:26-34, then
# the suffix convention (queries are the last Sq of Skv positions)
SWEEP = [
    (1, 128, 128, 4, 4, 32, True, None),
    (2, 256, 256, 8, 2, 64, True, None),     # GQA
    (2, 256, 256, 8, 2, 64, True, 64),       # sliding window
    (1, 384, 384, 4, 1, 32, True, 128),      # MQA + window, non-pow2 seq
    (2, 128, 128, 4, 4, 64, False, None),    # bidirectional (encoder)
    (1, 128, 512, 4, 2, 64, True, None),     # suffix: Sq < Skv
    (1, 256, 256, 12, 2, 128, True, None),   # GQA 6:1 at D=128 (internvl2-26b's heads)
]
# shapes the Pallas kernel's tiling refuses (S not a multiple of its tile):
# held against the reference's oracle
RAGGED = [
    (2, 200, 200, 4, 2, 32, True, None),
    (1, 37, 150, 4, 4, 16, True, 24),
    (1, 70, 70, 2, 2, 48, False, None),
]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _inputs(b, sq, skv, hq, hk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, hq, d)).astype(np.float32),
            rng.normal(size=(b, skv, hk, d)).astype(np.float32),
            rng.normal(size=(b, skv, hk, d)).astype(np.float32))


def _port(arrays, dtype, causal, window):
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrays)
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert ops.LAUNCHES["flash_attention"] == before   # the CPU launches no kernel
    assert out.dtype == tdt and out.shape == q.shape
    return out.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,skv,hq,hk,d,causal,window", SWEEP)
def test_matches_reference_pallas_kernel(b, sq, skv, hq, hk, d, causal, window, dtype):
    arrays = _inputs(b, sq, skv, hq, hk, d)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = ref_ops.flash_attention(*(jnp.asarray(a, jdt) for a in arrays),
                                   causal=causal, window=window)
    got = _port(arrays, dtype, causal, window)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,skv,hq,hk,d,causal,window", RAGGED)
def test_ragged_shapes_match_reference_oracle(b, sq, skv, hq, hk, d, causal, window, dtype):
    arrays = _inputs(b, sq, skv, hq, hk, d, seed=1)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = ref_ref.attention_ref(*(jnp.asarray(a, jdt) for a in arrays),
                                 causal=causal, window=window)
    got = _port(arrays, dtype, causal, window)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **_tol(dtype))


# tests/test_kernels.py:46-54: q (1, 128, 4, 32), k/v with 2 heads, causal
GRADS_CASE = (1, 128, 128, 4, 2, 32, True, None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,skv,hq,hk,d,causal,window", [GRADS_CASE] + SWEEP)
def test_grads_match_reference_vjp(b, sq, skv, hq, hk, d, causal, window, dtype):
    arrays = _inputs(b, sq, skv, hq, hk, d, seed=3)
    do = np.random.default_rng(4).normal(size=(b, sq, hq, d)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    _, vjp = jax.vjp(lambda q, k, v: ref_ops.flash_attention(q, k, v, causal=causal,
                                                             window=window),
                     *(jnp.asarray(a, jdt) for a in arrays))
    want = vjp(jnp.asarray(do, jdt))
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(tdt).requires_grad_() for a in arrays)
    before = dict(ops.LAUNCHES)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    got = torch.autograd.grad(out, (q, k, v), torch.from_numpy(do).to(tdt))
    assert ops.LAUNCHES == before          # the CPU launches no kernel, forward or backward
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else _tol(dtype)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == tdt and g.shape == (q, k, v)["qkv".index(name)].shape
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), **tol,
                                   err_msg=f"d{name}")


def test_positions_are_ignored_as_in_the_reference():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 16, 16, 2, 2, 8, seed=2))
    junk = torch.full((1, 16), 99)
    torch.testing.assert_close(ops.flash_attention(q, k, v, junk, junk, window=4),
                               ref.attention_ref(q, k, v, window=4), rtol=0, atol=0)


def test_wrapper_refuses_tensors_off_the_cpu_and_the_card():
    """The plain version serves CPU tensors only: any other device goes to
    the kernel's checks, which refuse what the kernel cannot take."""
    q = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.flash_attention(q, q, q)
    assert set(ops.LAUNCHES) == {"flash_attention", "flash_attention_bwd"}
