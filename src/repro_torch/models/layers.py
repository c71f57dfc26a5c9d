"""Core neural-net layers: norms, RoPE, GQA attention (three impls), KV
caches, MLPs, embeddings.  The port of ``repro.models.layers``.

Conventions (the reference's)
-----------------------------
* ``init_*`` returns ``(params, axes)``: ``axes`` mirrors the params tree
  with tuples of *logical* axis names for the sharding rules
  (``repro_torch.dist.sharding.tree_shardings`` places a tree by them).  Draws come from a
  ``torch.Generator``, on the generator's device; they differ from
  ``jax.random``'s, so a parity test bridges the reference's weights.
* Weights live in ``cfg.param_dtype``; matmuls run in ``cfg.compute_dtype``;
  softmax/norm accumulations in float32.
* Attention impls:
    - ``reference``: full-score softmax (oracle; O(S²) memory)
    - ``chunked``:   flash-style online-softmax loop over KV chunks
    - ``pallas``:    the hand-written Hopper kernel in
                     ``repro_torch.kernels.flash_attention`` (the name is the
                     reference's config value)
* Local attention uses ring-buffer KV caches of window size at decode.
  ``update_cache`` writes the cache in place (the reference gets the same
  from buffer donation).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import shard_map as SM
from repro_torch.dist.sharding import is_dtensor

Params = Dict[str, Any]
# finite on purpose: the online softmax relies on exp(-1e30 - m) == 0 and on
# rows that saw only masked scores being wiped by ``corr`` later; -inf
# would give NaN there
MASK_VALUE = -1e30


def _dt(cfg: ModelConfig, kind: str) -> torch.dtype:
    return getattr(torch, getattr(cfg, kind))


def _normal(gen: torch.Generator, shape, std: float, dtype: torch.dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device) * std).to(dtype)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------


def init_rmsnorm(d: int, cfg: ModelConfig, device=None) -> Tuple[Params, Params]:
    return ({"scale": torch.ones((d,), dtype=_dt(cfg, "param_dtype"), device=device)},
            {"scale": ("embed",)})


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# --------------------------------------------------------------------------
# Rotary position embeddings
# --------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = rope_freqs(d, theta, x.device)                 # (half,)
    angles = positions[..., None].float() * freqs          # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal absolute position table (S, D), computed in
    f32 and cast to ``dtype``."""
    return sinusoid_at(torch.arange(seq, device=device), d, dtype)


def sinusoid_at(pos: torch.Tensor, d: int, dtype=torch.float32) -> torch.Tensor:
    """Sinusoidal embedding (..., D) of the positions ``pos`` (...,)."""
    half = d // 2
    scale = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32, device=pos.device)
                      / max(half - 1, 1))
    ang = pos.float()[..., None] * scale
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# --------------------------------------------------------------------------
# Attention parameter init and projections
# --------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig) -> Tuple[Params, Params]:
    d, hq, hk = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dh = cfg.resolved_head_dim
    pd = _dt(cfg, "param_dtype")
    std = 0.02
    out_std = 0.02 / math.sqrt(2.0 * max(cfg.total_layers, 1))
    params = {
        "wq": _normal(gen, (d, hq, dh), std, pd),
        "wk": _normal(gen, (d, hk, dh), std, pd),
        "wv": _normal(gen, (d, hk, dh), std, pd),
        "wo": _normal(gen, (hq, dh, d), out_std, pd),
    }
    axes = {
        "wq": ("embed", "qheads", "head"),
        "wk": ("embed", "kvheads", "head"),
        "wv": ("embed", "kvheads", "head"),
        "wo": ("qheads", "head", "embed"),
    }
    if cfg.qkv_bias:
        params["bq"] = torch.zeros((hq, dh), dtype=pd, device=gen.device)
        params["bk"] = torch.zeros((hk, dh), dtype=pd, device=gen.device)
        params["bv"] = torch.zeros((hk, dh), dtype=pd, device=gen.device)
        axes["bq"] = ("qheads", "head")
        axes["bk"] = ("kvheads", "head")
        axes["bv"] = ("kvheads", "head")
    return params, axes


def proj_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def qkv_project(params: Params, x: torch.Tensor, cfg: ModelConfig):
    cd = _dt(cfg, "compute_dtype")
    x = x.to(cd)
    q = proj_in(x, params["wq"].to(cd))
    k = proj_in(x, params["wk"].to(cd))
    v = proj_in(x, params["wv"].to(cd))
    if "bq" in params:
        q = q + params["bq"].to(cd)
        k = k + params["bk"].to(cd)
        v = v + params["bv"].to(cd)
    return q, k, v


def out_project(params: Params, o: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    cd = _dt(cfg, "compute_dtype")
    h, k, d = params["wo"].shape
    return o.to(cd).reshape(*o.shape[:-2], h * k) @ params["wo"].to(cd).reshape(h * k, d)


# --------------------------------------------------------------------------
# Attention cores.  q: (B,Sq,Hq,D)  k,v: (B,Skv,Hk,D)
# kv_positions: (B,Skv) absolute positions of cache slots (-1 = invalid)
# q_positions:  (B,Sq)
# --------------------------------------------------------------------------


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    mask = kpos >= 0
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Full-materialization oracle attention (O(Sq·Skv) memory).  DTensor
    q, k, v attend on each rank's local shards (``_reference_sharded``)."""
    if is_dtensor(q, k, v):
        return _reference_sharded(q, k, v, q_positions, kv_positions, causal=causal,
                                  window=window, softmax_scale=softmax_scale)
    b, sq, hq, d = q.shape
    n_kv = k.shape[2]
    g = hq // n_kv
    scale = softmax_scale or (1.0 / math.sqrt(d))
    qg = q.reshape(b, sq, n_kv, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    scores = scores * scale
    mask = _mask(q_positions[:, None, None, :, None], kv_positions[:, None, None, None, :],
                 causal, window)
    scores = torch.where(mask, scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def _reference_sharded(q, k, v, q_positions, kv_positions, **kw) -> torch.Tensor:
    """``attention_reference`` of DTensor q, k, v under ``shard_map``: rows
    split over the batch axes and KV heads split over the others are
    independent pieces, so each rank attends its own rows and heads (torch
    2.11's DTensor cannot flatten the einsum's sharded batch dim without a
    redistribution).  k and v (a decode step's cache) stay where they are,
    and q, the plain positions (replicated) and the output take their
    split: one token's q may be reduced (a pending sum) or cut, never the
    cache gathered.  k and v split unlike each other, or on another dim (a
    sequence-sharded cache, the GQA head-dim fallback), and q split on one,
    are ROADMAP queue 1 row 9b-v."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.dist.sharding import P

    if not all(isinstance(t, DTensor) for t in (q, k, v)):
        raise TypeError("attention_reference got DTensor and plain operands together: "
                        "distribute every operand")
    mesh = q.device_mesh
    names = tuple(mesh.mesh_dim_names)

    def split(t):   # (batch axes, heads axes) of a (B, S, H, D) operand
        by_dim = {0: [], 2: []}
        for name, p in zip(names, t.placements):
            if p.is_shard() and p.dim % t.dim() not in by_dim:
                raise NotImplementedError(
                    f"attention_reference on an operand placed {tuple(t.placements)} "
                    f"(sequence or head dim): ROADMAP queue 1 row 9b-v")
            if p.is_shard():
                by_dim[p.dim % t.dim()].append(name)
        return tuple(by_dim[0]), tuple(by_dim[2])

    split(q)
    b_axes, h_axes = split(k)
    if split(v) != (b_axes, h_axes) or {k.device_mesh, v.device_mesh} != {mesh}:
        raise NotImplementedError(
            f"attention_reference on DTensors placed {tuple(k.placements)} for k and "
            f"{tuple(v.placements)} for v: ROADMAP queue 1 row 9b-v")

    def placed(t):
        if isinstance(t, DTensor):
            return t
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)

    heads = P(b_axes or None, None, h_axes or None, None)
    rows = P(b_axes or None, None)
    fn = SM.shard_map(functools.partial(attention_reference, **kw), mesh,
                      in_specs=(heads, heads, heads, rows, rows), out_specs=heads)
    return fn(q, k, v, placed(q_positions), placed(kv_positions))


def attention_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softmax_scale: Optional[float] = None,
    chunk: int = 1024,
) -> torch.Tensor:
    """Flash-style online-softmax attention looping over KV chunks; never
    materializes (Sq × Skv) scores."""
    b, sq, hq, d = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    g = hq // n_kv
    scale = softmax_scale or (1.0 / math.sqrt(d))
    chunk = min(chunk, skv)
    n_chunks = (skv + chunk - 1) // chunk
    pad = n_chunks * chunk - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = F.pad(kv_positions, (0, pad), value=-1)

    qg = q.reshape(b, sq, n_kv, g, d).float() * scale
    qpos = q_positions[:, None, None, :, None]  # (b,1,1,sq,1)
    m = torch.full((b, n_kv, g, sq), MASK_VALUE, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, n_kv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, n_kv, g, sq, d), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k[:, sl].float())
        mask = _mask(qpos, kv_positions[:, None, None, None, sl], causal, window)
        s = torch.where(mask, s, MASK_VALUE)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, v[:, sl].float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-37)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)
    return out.to(q.dtype)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    *,
    impl: str = "chunked",
    causal: bool = True,
    window: Optional[int] = None,
    chunk: int = 1024,
) -> torch.Tensor:
    if impl == "reference":
        return attention_reference(
            q, k, v, q_positions, kv_positions, causal=causal, window=window
        )
    if impl == "pallas":
        from repro_torch.kernels.flash_attention import ops as fa_ops

        return fa_ops.flash_attention(
            q, k, v, q_positions, kv_positions, causal=causal, window=window
        )
    return attention_chunked(
        q, k, v, q_positions, kv_positions, causal=causal, window=window, chunk=chunk
    )


# --------------------------------------------------------------------------
# KV caches.  Global layers: linear cache of size S_max.  Local layers:
# ring buffer of size window.  Slot -> absolute position bookkeeping keeps
# masking exact in both.
# --------------------------------------------------------------------------


def make_kv_cache(
    batch: int, size: int, n_kv: int, head_dim: int, dtype: torch.dtype,
    quantized: bool = False, device=None,
) -> Dict[str, torch.Tensor]:
    """KV cache.  ``quantized=True`` stores int8 K/V with per-(b,s,h) bf16
    scales (KIVI/KVQuant-style): halves decode HBM traffic vs bf16."""
    shape = (batch, size, n_kv, head_dim)
    if quantized:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:3], dtype=torch.bfloat16, device=device),
            "v_scale": torch.zeros(shape[:3], dtype=torch.bfloat16, device=device),
        }
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def kv_cache_axes(quantized: bool = False) -> Dict[str, Tuple[str, ...]]:
    axes = {
        "k": ("act_batch", "cache_seq", "kvheads", "head"),
        "v": ("act_batch", "cache_seq", "kvheads", "head"),
    }
    if quantized:
        axes["k_scale"] = ("act_batch", "cache_seq", "kvheads")
        axes["v_scale"] = ("act_batch", "cache_seq", "kvheads")
    return axes


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(…, S, H, D) -> int8 values + per-(…,S,H) bf16 scale."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale.float()[..., None]


def cache_positions(size: int, pos: int, ring: bool, device=None) -> torch.Tensor:
    """Absolute position stored in each cache slot after writing at ``pos``.

    Linear cache: slot i holds position i (valid iff i <= pos).
    Ring cache:   slot i holds the largest a <= pos with a % size == i.
    Returns (size,) int32 with -1 for unwritten slots.
    """
    idx = torch.arange(size, dtype=torch.int32, device=device)
    if not ring:
        return torch.where(idx <= pos, idx, -1)
    a = pos - ((pos - idx) % size)   # floor modulo, as jnp's
    return torch.where(a >= 0, a, -1).to(torch.int32)


def update_cache(
    cache: Dict[str, torch.Tensor],
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    pos: int,
    *,
    ring: bool,
) -> Dict[str, torch.Tensor]:
    """Write one step (Sq=1) of k/v at ``pos`` (ring: pos % size), in place;
    returns ``cache``.

    A DTensor cache is written in each rank's ``to_local()`` shard: the new
    slot, moved to the leaf's placements (a local slice where it is
    replicated or placed alike), lands in the rank's own storage, and the
    placements stay.  A cache whose sequence dim is sharded (``cache_seq``)
    raises ``NotImplementedError`` before any leaf is written: each rank
    would have to write only the slots it holds, the split-KV decode of
    ROADMAP queue 1 row 9b-v (DTensor's own ``__setitem__`` gathers such a
    leaf and drops the write without a word)."""
    size = cache["k"].shape[1]
    slot = min(max(pos % size if ring else pos, 0), size - 1)  # clamped, as dynamic_update_slice
    if "k_scale" in cache:  # int8 cache
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        new = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        new = {"k": k_new, "v": v_new}
    for name in new:
        _refuse_sequence_sharded(name, cache[name])
    for name, t in new.items():
        _write_slot(cache[name], t, slot)
    return cache


def _refuse_sequence_sharded(name: str, leaf: torch.Tensor) -> None:
    for p in getattr(leaf, "placements", ()):
        if p.is_shard(1):
            raise NotImplementedError(
                f"a decode write into cache leaf {name!r} placed {tuple(leaf.placements)}, its "
                f"sequence dim sharded: ROADMAP queue 1 row 9b-v (split-KV decode)")


def _write_slot(dst: torch.Tensor, new: torch.Tensor, slot: int) -> None:
    """``dst[:, slot:slot + 1] = new`` in place; a DTensor ``dst`` (sequence
    dim whole) in its local shard, the DTensor ``new`` moved to ``dst``'s
    placements first."""
    if not is_dtensor(dst):
        dst[:, slot:slot + 1] = new.to(dst.dtype)
        return
    if tuple(new.placements) != tuple(dst.placements):
        new = new.redistribute(dst.device_mesh, dst.placements)
    dst.to_local()[:, slot:slot + 1] = new.to_local().to(dst.dtype)


def cache_kv_arrays(cache: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dequantized (k, v) views of a cache (no-op for bf16 caches)."""
    if "k_scale" in cache:
        return (
            dequantize_kv(cache["k"], cache["k_scale"]),
            dequantize_kv(cache["v"], cache["v_scale"]),
        )
    return cache["k"], cache["v"]


def prefill_cache_from_kv(
    k: torch.Tensor, v: torch.Tensor, size: int, *, ring: bool, quantized: bool = False
) -> Dict[str, torch.Tensor]:
    """Build a cache of ``size`` slots from a full prefill's k/v (B,S,Hk,D).
    A linear cache of DTensor k/v whose sequence dim is whole on every rank
    is padded (or cut) in each rank's local shard, under k/v's placements:
    nothing is sent (torch 2.11's DTensor fails to plan a redistribution
    for ``F.pad`` of k sharded on batch and heads)."""
    b, s, hk, d = k.shape
    if not ring:
        kk, vv = _slots(k, size), _slots(v, size)
    else:
        # ring: keep the last `size` positions, placed at slot = abs_pos % size
        take = min(s, size)
        slots = torch.arange(s - take, s, device=k.device) % size
        kk = torch.zeros((b, size, hk, d), dtype=k.dtype, device=k.device)
        vv = torch.zeros((b, size, hk, d), dtype=v.dtype, device=v.device)
        kk[:, slots] = k[:, s - take:]
        vv[:, slots] = v[:, s - take:]
    if quantized:
        kq, ks = quantize_kv(kk)
        vq, vs = quantize_kv(vv)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return {"k": kk.contiguous(), "v": vv.contiguous()}


def _slots(t: torch.Tensor, size: int) -> torch.Tensor:
    """``t`` (B, S, ...) zero-padded or cut to ``size`` along dim 1; a
    DTensor whose dim 1 no mesh dim shards, in its local shard."""
    def resized(x):
        pad = size - x.shape[1]
        return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad)) if pad > 0 else x[:, :size]

    placements = getattr(t, "placements", None)
    if placements is None or any(p.is_shard(1) for p in placements):
        return resized(t)
    from torch.distributed.tensor import DTensor

    shape = (t.shape[0], size, *t.shape[2:])
    return DTensor.from_local(resized(t.to_local()), t.device_mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg: ModelConfig) -> Tuple[Params, Params]:
    d, f = cfg.d_model, cfg.d_ff
    pd = _dt(cfg, "param_dtype")
    std = 0.02
    out_std = 0.02 / math.sqrt(2.0 * max(cfg.total_layers, 1))
    if cfg.mlp_act == "gelu":
        params = {
            "w1": _normal(gen, (d, f), std, pd),
            "b1": torch.zeros((f,), dtype=pd, device=gen.device),
            "w2": _normal(gen, (f, d), out_std, pd),
            "b2": torch.zeros((d,), dtype=pd, device=gen.device),
        }
        axes = {"w1": ("embed", "mlp"), "b1": ("mlp",), "w2": ("mlp", "embed"), "b2": ("embed",)}
        return params, axes
    params = {
        "wg": _normal(gen, (d, f), std, pd),
        "wu": _normal(gen, (d, f), std, pd),
        "wd": _normal(gen, (f, d), out_std, pd),
    }
    axes = {"wg": ("embed", "mlp"), "wu": ("embed", "mlp"), "wd": ("mlp", "embed")}
    return params, axes


def mlp(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    cd = _dt(cfg, "compute_dtype")
    x = x.to(cd)
    if cfg.mlp_act == "gelu":
        h = x @ params["w1"].to(cd) + params["b1"].to(cd)
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
        return h @ params["w2"].to(cd) + params["b2"].to(cd)
    g = x @ params["wg"].to(cd)
    u = x @ params["wu"].to(cd)
    h = F.silu(g) * u
    return h @ params["wd"].to(cd)


# --------------------------------------------------------------------------
# Embeddings / logits
# --------------------------------------------------------------------------


def init_embedding(gen: torch.Generator, cfg: ModelConfig) -> Tuple[Params, Params]:
    pd = _dt(cfg, "param_dtype")
    params = {"embedding": _normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, pd)}
    axes = {"embedding": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        params["unembed"] = _normal(gen, (cfg.d_model, cfg.vocab_size), 0.02, pd)
        axes["unembed"] = ("embed", "vocab")
    return params, axes


def embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``table[tokens]`` in the compute dtype.  A DTensor table is looked up
    vocab-parallel under ``shard_map``: each rank runs ``_embed_rows`` on
    its block of the vocabulary and the rows are summed over the
    vocabulary's shards (one holds each token); the gradient scatters into
    each rank's own block, and no rank gathers the table's vocabulary."""
    table = params["embedding"]
    cd = _dt(cfg, "compute_dtype")
    if not is_dtensor(table):
        return _embed_rows(table, tokens).to(cd)
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.dist.sharding import P

    mesh = table.device_mesh
    names = tuple(mesh.mesh_dim_names)
    v_axes = tuple(n for n, p in zip(names, table.placements) if p.is_shard(0))
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    b_axes = tuple(n for n, p in zip(names, tokens.placements) if p.is_shard(0))
    spec = P(b_axes or None, *([None] * (tokens.dim() - 1)))
    fn = SM.shard_map(functools.partial(_embed_rows, v_axes=v_axes), mesh,
                      in_specs=(P(v_axes or None, None), spec), out_specs=P(*spec, None))
    return fn(table, tokens).to(cd)


def _embed_rows(tab: torch.Tensor, tok: torch.Tensor, v_axes=()) -> torch.Tensor:
    """The rows of ``tok`` that ``tab``, this rank's block of the
    vocabulary along ``v_axes`` (the whole table over none), holds, zeros
    for the rest, summed over ``v_axes``."""
    v_loc = tab.shape[0]
    idx = tok.long() - SM.flat_index(v_axes) * v_loc
    held = (idx >= 0) & (idx < v_loc)
    rows = F.embedding(idx.clamp(0, v_loc - 1), tab)
    return SM.psum(torch.where(held[..., None], rows, torch.zeros_like(rows)), v_axes)


def logits_from_hidden(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    cd = _dt(cfg, "compute_dtype")
    if "unembed" in params:
        return x.to(cd) @ params["unembed"].to(cd)
    return x.to(cd) @ params["embedding"].to(cd).T
