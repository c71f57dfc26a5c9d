"""The port's int8 split-KV decode against the reference's, on the CPU.

``repro_torch.kernels.flash_attention.decode_ref.flash_decode_int8_ref``
against ``repro.kernels.flash_attention.decode_kernel.flash_decode_int8``
(the Pallas kernel, interpreted on the CPU) on the reference's own cases
(tests/test_kernels.py:166-168) and a bf16 query; then the port's wrapper
reading the model's ``(B, S, Hk, D)`` int8 cache in place through views, at
a ragged S, against the reference's ``dequantize_kv`` and
``attention_reference``, as tests/test_kernels.py holds the Pallas kernel.
Tolerance 1e-5, the reference's.  The CUDA kernel is held against the plain
version on the card by tests/test_torch_kernels_cuda.py and chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.decode_kernel import flash_decode_int8 as ref_decode
from repro.models import layers as ref_L
from repro_torch.kernels.flash_attention import decode_ops, decode_ref
from repro_torch.models import layers as L

TOL = dict(rtol=1e-5, atol=1e-5)
# (b, hq, hk, s, d, kv_len, tk): tests/test_kernels.py:166-168
CASES = [(1, 4, 4, 128, 32, 100, 32), (2, 8, 2, 256, 64, 200, 64), (1, 4, 1, 512, 64, 511, 128)]


def _quantized(b, hq, hk, s, d, seed):
    """q (B, Hq, D) and the reference's int8 cache of normal K/V, as numpy:
    k, v (B, S, Hk, D) int8, scales (B, S, Hk) bf16."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    kq, ks = ref_L.quantize_kv(jnp.asarray(rng.normal(size=(b, s, hk, d)), jnp.float32))
    vq, vs = ref_L.quantize_kv(jnp.asarray(rng.normal(size=(b, s, hk, d)), jnp.float32))
    return q, *(np.asarray(a) for a in (kq, vq, ks, vs))


def _torch(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_decode_ref_matches_the_interpreted_pallas_kernel(case, qdtype):
    b, hq, hk, s, d, kv_len, tk = case
    q, kq, vq, ks, vs = _quantized(b, hq, hk, s, d, seed=s + d)
    t = (0, 2, 1, 3)
    want = ref_decode(jnp.asarray(q).astype(jnp.dtype(qdtype)),
                      *(jnp.asarray(a).transpose(t) for a in (kq, vq)),
                      *(jnp.asarray(a).transpose(0, 2, 1) for a in (ks, vs)),
                      kv_len=kv_len, tk=tk, interpret=True)
    got = decode_ref.flash_decode_int8_ref(
        _torch(q).to(getattr(torch, qdtype)), *(_torch(a).permute(t) for a in (kq, vq)),
        *(_torch(a).transpose(1, 2) for a in (ks, vs)), kv_len=kv_len)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, hq, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("b,hq,hk,s,d,kv_len", [(2, 8, 2, 37, 16, 30), (1, 4, 1, 130, 64, 130),
                                                (2, 4, 4, 75, 48, 1)])
def test_wrapper_reads_the_model_cache_in_place(b, hq, hk, s, d, kv_len):
    """The port's int8 cache (built by its own ``prefill_cache_from_kv``) read
    through transposed views at a ragged S, against dequantize + the
    reference's full-score attention (tests/test_kernels.py:185-192)."""
    rng = np.random.default_rng(s)
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hk, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hk, d)).astype(np.float32)
    cache = L.prefill_cache_from_kv(torch.from_numpy(k), torch.from_numpy(v), s, ring=False,
                                    quantized=True)
    before = decode_ops.LAUNCHES["flash_decode_int8"]
    got = decode_ops.flash_decode_int8(
        torch.from_numpy(q), cache["k"].transpose(1, 2), cache["v"].transpose(1, 2),
        cache["k_scale"].transpose(1, 2), cache["v_scale"].transpose(1, 2), kv_len=kv_len)
    assert decode_ops.LAUNCHES["flash_decode_int8"] == before   # the CPU launches no kernel

    to_j = lambda t: jnp.asarray(t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy())
    kd = ref_L.dequantize_kv(to_j(cache["k"]), to_j(cache["k_scale"]).astype(jnp.bfloat16))
    vd = ref_L.dequantize_kv(to_j(cache["v"]), to_j(cache["v_scale"]).astype(jnp.bfloat16))
    qpos = jnp.full((b, 1), kv_len - 1)
    kvpos = jnp.broadcast_to(jnp.where(jnp.arange(s) < kv_len, jnp.arange(s), -1), (b, s))
    want = ref_L.attention_reference(jnp.asarray(q)[:, None], kd, vd, qpos, kvpos, causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want[:, 0]), **TOL)
    # within quantization error of the f32 cache
    want_fp = ref_L.attention_reference(jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v),
                                        qpos, kvpos, causal=False)
    assert float(np.abs(got.numpy() - np.asarray(want_fp[:, 0])).max()) < 0.05


@pytest.mark.parametrize("kv_len", [0, -1, 38])
def test_wrapper_refuses_kv_len_outside_the_cache(kv_len):
    q, kq, vq, ks, vs = (_torch(a) for a in _quantized(1, 2, 1, 37, 16, seed=0))
    with pytest.raises(ValueError, match="kv_len"):
        decode_ops.flash_decode_int8(q, kq.transpose(1, 2), vq.transpose(1, 2),
                                     ks.transpose(1, 2), vs.transpose(1, 2), kv_len=kv_len)


def test_split_len_fills_the_card_at_the_serve_shape():
    """qwen1.5-0.5b's decode (B = 4, Hk = 16, 2,081 slots) on 132 SMs: whole
    tiles, about four blocks an SM, and every position in some split."""
    chunk = decode_ops.split_len(4, 16, 2081, 132)
    splits = -(-2081 // chunk)
    assert chunk % 64 == 0 and chunk * splits >= 2081 > chunk * (splits - 1)
    assert 4 * 132 <= 4 * 16 * splits < 8 * 132
    assert decode_ops.split_len(1, 1, 10, 132) == 64


def test_wrapper_takes_only_cpu_or_cuda_tensors():
    """The plain version serves CPU tensors only: any other device goes to
    the kernel's checks, which refuse what the kernel cannot take."""
    q = torch.empty((1, 2, 16), device="meta")
    kv = torch.empty((1, 1, 37, 16), dtype=torch.int8, device="meta")
    scale = torch.empty((1, 1, 37), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        decode_ops.flash_decode_int8(q, kv, kv, scale, scale, kv_len=37)
    assert set(decode_ops.LAUNCHES) == {"flash_decode_int8"}
