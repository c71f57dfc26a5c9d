"""The port's int8 split-KV decode against the reference's, on the CPU.

``repro_torch.kernels.flash_attention.decode_ref.flash_decode_int8_ref``
against ``repro.kernels.flash_attention.decode_kernel.flash_decode_int8``
(the Pallas kernel, interpreted on the CPU) on the reference's own cases
(tests/test_kernels.py:166-168) and a bf16 query; then the port's wrapper
reading the model's ``(B, S, Hk, D)`` int8 cache in place through views, at
a ragged S, against the reference's ``dequantize_kv`` and
``attention_reference``, as tests/test_kernels.py holds the Pallas kernel.
Tolerance 1e-5, the reference's.  Last, the kernel's split of the positions
(``split_len``) and the way its cluster combines the splits, modelled in
PyTorch, idle splits included.  The CUDA kernel is held against the plain
version on the card by tests/test_torch_kernels_cuda.py and chip_smoke.py."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - dev extra not installed
    from _hypothesis_fallback import given, settings, strategies as st

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


@pytest.mark.parametrize("kv_len", [0, -1, 38, 42])
def test_wrapper_refuses_kv_len_outside_the_cache(kv_len):
    """``kv_len`` outside ``[1, S]`` is no longer refused: the wrapper gives
    the interpreted Pallas kernel's values.  At ``kv_len <= 0`` every score
    is masked alike (a uniform softmax: the mean of the dequantized V over
    all S slots); past S every slot is live.  A cache with no position is
    still refused."""
    b, hq, hk, s, d = 1, 2, 1, 37, 16
    q, kq, vq, ks, vs = _quantized(b, hq, hk, s, d, seed=0)
    want = ref_decode(jnp.asarray(q), *(jnp.asarray(a).transpose(0, 2, 1, 3) for a in (kq, vq)),
                      *(jnp.asarray(a).transpose(0, 2, 1) for a in (ks, vs)),
                      kv_len=kv_len, interpret=True)
    got = decode_ops.flash_decode_int8(_torch(q), *(_torch(a).transpose(1, 2) for a in (kq, vq)),
                                       *(_torch(a).transpose(1, 2) for a in (ks, vs)),
                                       kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if kv_len <= 0:
        v = _torch(vq).float() * _torch(vs).float()[..., None]       # (B, S, Hk, D)
        np.testing.assert_allclose(got.numpy(), v.mean(1).repeat_interleave(hq // hk, 1).numpy(),
                                   **TOL)
    empty = torch.empty((b, hk, 0, d), dtype=torch.int8)
    with pytest.raises(ValueError, match="no position"):
        decode_ops.flash_decode_int8(_torch(q), empty, empty, torch.empty((b, hk, 0)),
                                     torch.empty((b, hk, 0)), kv_len=kv_len)


# clusters of 1, 2, 4 and 8 of the kernel's 512-thread blocks that fit on an
# H100 SXM at once (cudaOccupancyMaxActiveClusters there): a cluster stays
# inside one GPC, so the two largest sizes hold fewer than 132 / size
H100_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15}


def _model(sms):
    """Clusters that fit at once with one block an SM and no GPC bounds."""
    return {c: sms // c for c in decode_ops.CLUSTER_SIZES}


def _splits(b, hk, s, clusters):
    chunk = decode_ops.split_len(b, hk, s, clusters)
    return [(i * chunk, min((i + 1) * chunk, s)) for i in range(-(-s // chunk))]


def test_split_len_fills_the_card_at_the_serve_shape():
    """qwen1.5-0.5b's decode (B = 4, Hk = 16, 2,081 slots) on an H100: two
    splits, since 64 clusters of two fit at once and 64 of four do not
    (128 blocks of 512 threads for 132 SMs), every position in some split;
    eight splits where one (b, KV head) leaves the card idle; one where
    B * Hk alone fills it."""
    chunk = decode_ops.split_len(4, 16, 2081, H100_CLUSTERS)
    splits = -(-2081 // chunk)
    assert splits == 2 and chunk * splits >= 2081 > chunk * (splits - 1)
    assert 4 * 16 * splits <= 132 < 4 * 16 * 2 * splits
    assert _splits(4, 16, 2081, H100_CLUSTERS) == [(0, chunk), (chunk, 2081)]
    assert decode_ops.split_len(4, 16, 32768, H100_CLUSTERS) == 16384   # decode_32k's length
    assert len(_splits(1, 4, 2081, H100_CLUSTERS)) == 8
    assert len(_splits(2, 16, 2081, H100_CLUSTERS)) == 2     # 32 clusters of four do not fit
    assert len(_splits(2, 16, 2081, _model(132))) == 4      # in the model (132 // 4 = 33) they do
    assert decode_ops.split_len(4, 33, 2081, H100_CLUSTERS) >= 2081
    assert decode_ops.split_len(1, 1, 10, _model(132)) == 64


@settings(max_examples=300, deadline=None)
@given(b=st.integers(1, 64), hk=st.integers(1, 64), s=st.integers(1, 600_000),
       sms=st.integers(1, 264))
def test_splits_cover_the_positions_once(b, hk, s, sms):
    """For any (B, Hk, S, SMs): at most eight splits, each non-empty, that
    cover [0, S) exactly once in order; no more than the largest cluster
    size of which all B * Hk clusters fit (one split where two do not)."""
    splits = _splits(b, hk, s, _model(sms))
    assert 1 <= len(splits) <= 8
    assert splits[0][0] == 0 and splits[-1][1] == s
    assert all(lo < hi for lo, hi in splits)
    assert all(a[1] == c[0] for a, c in zip(splits, splits[1:]))
    fits = [c for c in decode_ops.CLUSTER_SIZES if b * hk <= sms // c]
    assert len(splits) <= max(fits, default=1)
    if b * hk > sms // 2:
        assert len(splits) == 1


def _cluster_combine(q, kq, vq, ks, vs, kv_len, splits):
    """What the kernel computes, in PyTorch: each split's (m, l, acc) over its
    live positions (an idle split keeps m = -1e30, l = 0, acc = 0), then
    every split weighted by exp(m - max m), as the cluster's blocks read
    their peers' partials."""
    b, hq, d = q.shape
    hk = kq.shape[1]
    qs = (q.float() * (1.0 / math.sqrt(d))).to(q.dtype).float().reshape(b, hk, hq // hk, d)
    parts = []
    for lo, hi in splits:
        hi = min(hi, kv_len)
        m = torch.full((b, hk, hq // hk, 1), -1e30)
        l, acc = torch.zeros_like(m), torch.zeros((b, hk, hq // hk, d))
        if hi > lo:
            sc = (torch.einsum("bhgd,bhsd->bhgs", qs, kq[:, :, lo:hi].float())
                  * ks[:, :, None, lo:hi].float())
            m = sc.amax(-1, keepdim=True)
            p = torch.exp(sc - m)
            l = p.sum(-1, keepdim=True)
            acc = torch.einsum("bhgs,bhsd->bhgd", p * vs[:, :, None, lo:hi].float(),
                               vq[:, :, lo:hi].float())
        parts.append((m, l, acc))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp(m - mx) for m, _, _ in parts]
    l = sum(wi * li for wi, (_, li, _) in zip(w, parts))
    acc = sum(wi * ai for wi, (_, _, ai) in zip(w, parts))
    return (acc / torch.clamp(l, min=1e-37)).reshape(b, hq, d)


@pytest.mark.parametrize("b,hq,hk,s,d,kv_len", [
    (4, 16, 16, 2081, 64, 2080), (1, 4, 4, 2081, 64, 65), (2, 8, 2, 1000, 64, 1),
    (1, 16, 1, 300, 256, 290)])
def test_cluster_combine_matches_decode_ref(b, hq, hk, s, d, kv_len):
    """The kernel's split and combine, idle splits included, against the plain
    version within 1e-5 (the served shape, the last seven splits past
    kv_len, one live position, MQA at D = 256)."""
    q, kq, vq, ks, vs = (_torch(a) for a in _quantized(b, hq, hk, s, d, seed=kv_len))
    q = q.to(torch.bfloat16)
    views = [kq.transpose(1, 2), vq.transpose(1, 2), ks.transpose(1, 2), vs.transpose(1, 2)]
    splits = _splits(b, hk, s, H100_CLUSTERS)
    assert len(splits) > 1
    got = _cluster_combine(q, *views, kv_len, splits)
    want = decode_ref.flash_decode_int8_ref(q, *views, kv_len=kv_len)
    torch.testing.assert_close(got, want, **TOL)


def test_wrapper_takes_only_cpu_or_cuda_tensors():
    """The plain version serves CPU tensors only: any other device goes to
    the kernel's checks, which refuse what the kernel cannot take."""
    q = torch.empty((1, 2, 16), device="meta")
    kv = torch.empty((1, 1, 37, 16), dtype=torch.int8, device="meta")
    scale = torch.empty((1, 1, 37), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        decode_ops.flash_decode_int8(q, kv, kv, scale, scale, kv_len=37)
    assert set(decode_ops.LAUNCHES) == {"flash_decode_int8"}
