"""Residual block: {attn | mamba2 | rglru} mixer, an optional
cross-attention over an encoder's output, then a {dense | moe | none} FFN.
The port of ``repro.models.blocks``.

The ``LayerSpec`` selects the mixer/FFN per layer; ``LayerGroup`` patterns
hold stacked parameters (see ``repro_torch.models.lm``).  An MoE FFN runs
the local (one device) path of ``repro_torch.models.moe`` and returns its
aux loss.  Cross-attention (whisper's decoder) attends through
``attention_chunked`` in every mode, as the reference's does.

Modes:
  * ``full``    — whole-sequence forward with no cache (whisper's encoder;
    the training forward of the decoder trunk comes with LM training)
  * ``prefill`` — whole-sequence forward that also emits a decode cache
  * ``decode``  — single-token step against the cache, written in place
    (attention writes its slot; the recurrent mixers copy their new conv
    window and state over the old; the cross cache is read, never written)

Caches are per-block dicts; local-attention layers use ring buffers of
window size.  The residual stream is constrained to ``("act_batch",
"act_seq", None)`` after the mixer and after the FFN, where the reference
constrains it (``repro_torch.dist.sharding.with_logical_constraint``: a
no-op outside a ``logical_sharding`` context), and an MoE FFN gets the
context's mesh.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import (
    FFN_DENSE,
    FFN_MOE,
    FFN_NONE,
    MIXER_ATTN,
    MIXER_MAMBA2,
    MIXER_RGLRU,
    LayerSpec,
    ModelConfig,
)
from repro_torch.dist.sharding import current_context, with_logical_constraint
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.tree import tree_map

Params = Dict[str, Any]


def _check_spec(spec: LayerSpec) -> None:
    if spec.mixer not in (MIXER_ATTN, MIXER_MAMBA2, MIXER_RGLRU):
        raise ValueError(spec.mixer)
    if spec.ffn not in (FFN_DENSE, FFN_MOE, FFN_NONE):
        raise ValueError(spec.ffn)


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------


def init_block(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec) -> Tuple[Params, Params]:
    _check_spec(spec)
    p, a = {}, {}
    p["norm1"], a["norm1"] = L.init_rmsnorm(cfg.d_model, cfg, gen.device)
    if spec.mixer == MIXER_ATTN:
        p["mixer"], a["mixer"] = L.init_attention(gen, cfg)
    elif spec.mixer == MIXER_MAMBA2:
        p["mixer"], a["mixer"] = M2.init_mamba2(gen, cfg)
    else:
        p["mixer"], a["mixer"] = RG.init_rglru(gen, cfg)
    if spec.cross_attn:
        p["norm_c"], a["norm_c"] = L.init_rmsnorm(cfg.d_model, cfg, gen.device)
        p["cross"], a["cross"] = L.init_attention(gen, cfg)
    if spec.ffn != FFN_NONE:
        p["norm2"], a["norm2"] = L.init_rmsnorm(cfg.d_model, cfg, gen.device)
        init_ffn = L.init_mlp if spec.ffn == FFN_DENSE else MOE.init_moe
        p["ffn"], a["ffn"] = init_ffn(gen, cfg)
    return p, a


# --------------------------------------------------------------------------
# Cache allocation
# --------------------------------------------------------------------------


def block_cache(
    cfg: ModelConfig,
    spec: LayerSpec,
    batch: int,
    cache_len: int,
    enc_len: int = 0,
    device=None,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A block's decode cache; a cross-attention block also holds the
    encoder's K/V (``enc_len`` slots, never quantized)."""
    _check_spec(spec)
    cd = getattr(torch, cfg.compute_dtype)
    dh = cfg.resolved_head_dim
    if spec.mixer == MIXER_MAMBA2:
        c, ax = {"ssm": M2.mamba2_cache(cfg, batch, device)}, {"ssm": M2.mamba2_cache_axes()}
    elif spec.mixer == MIXER_RGLRU:
        c, ax = {"lru": RG.rglru_cache(cfg, batch, device)}, {"lru": RG.rglru_cache_axes()}
    else:
        ring = spec.window is not None and spec.window < cache_len
        size = spec.window if ring else cache_len
        c = {"kv": L.make_kv_cache(batch, size, cfg.n_kv_heads, dh, cd,
                                   quantized=cfg.kv_cache_quant, device=device)}
        ax = {"kv": L.kv_cache_axes(quantized=cfg.kv_cache_quant)}
    if spec.cross_attn:
        c["cross"] = L.make_kv_cache(batch, enc_len, cfg.n_kv_heads, dh, cd, device=device)
        ax["cross"] = {"k": ("act_batch", "enc_seq", "kvheads", "head"),
                       "v": ("act_batch", "enc_seq", "kvheads", "head")}
    return c, ax


def _is_ring(spec: LayerSpec, cache_size: int) -> bool:
    return spec.window is not None and spec.window == cache_size


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------


def _attn_full(params, x, cfg, spec, positions, causal, mode, cache_len):
    q, k, v = L.qkv_project(params, x, cfg)
    if cfg.use_rope:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    y = L.attention(
        q, k, v, positions, positions,
        impl=cfg.attn_impl, causal=causal, window=spec.window, chunk=cfg.attn_chunk,
    )
    out = L.out_project(params, y, cfg)
    cache = None
    if mode == "prefill":
        ring = spec.window is not None and spec.window < cache_len
        size = spec.window if ring else cache_len
        cache = L.prefill_cache_from_kv(k, v, size, ring=ring, quantized=cfg.kv_cache_quant)
    return out, cache


def _attn_decode(params, x, cfg, spec, pos: int, cache):
    """One token against the whole cache through the plain attention, as the
    reference does (an int8 cache is dequantized first); ``cache`` is
    written in place."""
    b = x.shape[0]
    q, k, v = L.qkv_project(params, x, cfg)  # (B,1,·,·)
    qpos = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.use_rope:
        q = L.apply_rope(q, qpos, cfg.rope_theta)
        k = L.apply_rope(k, qpos, cfg.rope_theta)
    size = cache["k"].shape[1]
    ring = _is_ring(spec, size)
    cache = L.update_cache(cache, k, v, pos, ring=ring)
    kvpos = L.cache_positions(size, pos, ring, x.device).expand(b, size)
    kc, vc = L.cache_kv_arrays(cache)
    y = L.attention_reference(q, kc, vc, qpos, kvpos, causal=True, window=spec.window)
    return L.out_project(params, y, cfg), cache


def _cross_kv(params, enc_out, cfg):
    """The encoder output's K and V under a cross-attention's projections."""
    cd = getattr(torch, cfg.compute_dtype)
    enc_out = enc_out.to(cd)
    return L.proj_in(enc_out, params["wk"].to(cd)), L.proj_in(enc_out, params["wv"].to(cd))


def _cross_attn(params, x, kv, cfg):
    """Cross-attention of ``x`` over the encoder's ``kv`` = (K, V): no mask,
    through ``attention_chunked`` (the reference fixes ``impl="chunked"``
    here, so this attention never reaches its kernel)."""
    cd = getattr(torch, cfg.compute_dtype)
    b, s = x.shape[0], x.shape[1]
    q = L.proj_in(x.to(cd), params["wq"].to(cd))
    k, v = kv
    qpos = torch.zeros((b, s), dtype=torch.int32, device=x.device)
    kvpos = torch.arange(k.shape[1], device=x.device).expand(b, k.shape[1])
    y = L.attention_chunked(q, k, v, qpos, kvpos, causal=False, window=None,
                            chunk=cfg.attn_chunk)
    return L.out_project(params, y, cfg)


def block_apply(
    params: Params,
    x: torch.Tensor,
    *,
    cfg: ModelConfig,
    spec: LayerSpec,
    mode: str = "prefill",
    positions: Optional[torch.Tensor] = None,
    pos: Optional[int] = None,
    cache: Optional[Dict[str, Any]] = None,
    enc_out: Optional[torch.Tensor] = None,
    causal: bool = True,
    cache_len: int = 0,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], torch.Tensor]:
    """Returns (x_out, new_cache (None in ``full`` mode), aux_loss scalar).
    A cross-attention block attends over ``enc_out`` in ``full`` and
    ``prefill`` mode (and prefill puts its K/V in the cache's ``cross``),
    over ``cache["cross"]`` at decode."""
    _check_spec(spec)
    if mode not in ("full", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.rmsnorm(params["norm1"], x, cfg.norm_eps)
    if spec.mixer == MIXER_ATTN:
        key = "kv"
        if mode == "decode":
            out, st = _attn_decode(params["mixer"], h, cfg, spec, pos, cache["kv"])
        else:
            out, st = _attn_full(params["mixer"], h, cfg, spec, positions, causal, mode,
                                 cache_len)
    else:
        key, forward, decode = (("ssm", M2.mamba2_forward, M2.mamba2_decode)
                                if spec.mixer == MIXER_MAMBA2 else
                                ("lru", RG.rglru_forward, RG.rglru_decode))
        if mode == "decode":
            out, st = decode(params["mixer"], h, cache[key], cfg)
            st = tree_map(lambda old, new: old.copy_(new), cache[key], st)
        else:
            out, st = forward(params["mixer"], h, cfg, return_cache=(mode == "prefill"))
    x = x + out.to(x.dtype)
    x = with_logical_constraint(x, "act_batch", "act_seq", None)
    new_cache = None if mode == "full" else {key: st}
    if spec.cross_attn:
        h = L.rmsnorm(params["norm_c"], x, cfg.norm_eps)
        if mode == "decode":
            kv = cache["cross"]["k"], cache["cross"]["v"]
            new_cache["cross"] = cache["cross"]
        else:
            kv = _cross_kv(params["cross"], enc_out, cfg)
            if mode == "prefill":
                new_cache["cross"] = {"k": kv[0], "v": kv[1]}
        x = x + _cross_attn(params["cross"], h, kv, cfg).to(x.dtype)
    if spec.ffn != FFN_NONE:
        h = L.rmsnorm(params["norm2"], x, cfg.norm_eps)
        if spec.ffn == FFN_DENSE:
            out = L.mlp(params["ffn"], h, cfg)
        else:
            ctx = current_context()
            resident = mode == "decode" and cfg.moe_resident_serve
            out, aux = MOE.moe_ffn(params["ffn"], h, cfg, mesh=None if ctx is None else ctx.mesh,
                                   gmm_impl=cfg.moe_gmm_impl, resident=resident)
        x = x + out.to(x.dtype)
        x = with_logical_constraint(x, "act_batch", "act_seq", None)
    return x, new_cache, aux
