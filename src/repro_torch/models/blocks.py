"""Residual block: {attn | mamba2 | rglru} mixer + {dense | moe | none} FFN.
The port of ``repro.models.blocks`` for the dense, moe, ssm and hybrid
families.

The ``LayerSpec`` selects the mixer/FFN per layer; ``LayerGroup`` patterns
hold stacked parameters (see ``repro_torch.models.lm``).  Cross-attention
blocks are not ported yet and raise.  An MoE FFN runs the local (one
device) path of ``repro_torch.models.moe`` and returns its aux loss.

Modes:
  * ``prefill`` — whole-sequence forward that also emits a decode cache
  * ``decode``  — single-token step against the cache, written in place
    (attention writes its slot; the recurrent mixers copy their new conv
    window and state over the old)
  (``full``, the training forward, comes with the training slice.)

Caches are per-block dicts; local-attention layers use ring buffers of
window size.  The reference's sharding constraints have no counterpart
until the port's sharding rules exist (ROADMAP item 17).
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
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.tree import tree_map

Params = Dict[str, Any]


def _check_ported(spec: LayerSpec) -> None:
    if spec.mixer not in (MIXER_ATTN, MIXER_MAMBA2, MIXER_RGLRU):
        raise ValueError(spec.mixer)
    if spec.cross_attn:
        raise NotImplementedError(
            "cross-attention blocks are not ported yet (ROADMAP: models/encdec.py)")
    if spec.ffn not in (FFN_DENSE, FFN_MOE, FFN_NONE):
        raise ValueError(spec.ffn)


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------


def init_block(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec) -> Tuple[Params, Params]:
    _check_ported(spec)
    p, a = {}, {}
    p["norm1"], a["norm1"] = L.init_rmsnorm(cfg.d_model, cfg, gen.device)
    if spec.mixer == MIXER_ATTN:
        p["mixer"], a["mixer"] = L.init_attention(gen, cfg)
    elif spec.mixer == MIXER_MAMBA2:
        p["mixer"], a["mixer"] = M2.init_mamba2(gen, cfg)
    else:
        p["mixer"], a["mixer"] = RG.init_rglru(gen, cfg)
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
    device=None,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    _check_ported(spec)
    if spec.mixer == MIXER_MAMBA2:
        return {"ssm": M2.mamba2_cache(cfg, batch, device)}, {"ssm": M2.mamba2_cache_axes()}
    if spec.mixer == MIXER_RGLRU:
        return {"lru": RG.rglru_cache(cfg, batch, device)}, {"lru": RG.rglru_cache_axes()}
    ring = spec.window is not None and spec.window < cache_len
    size = spec.window if ring else cache_len
    c = {"kv": L.make_kv_cache(batch, size, cfg.n_kv_heads, cfg.resolved_head_dim,
                               getattr(torch, cfg.compute_dtype),
                               quantized=cfg.kv_cache_quant, device=device)}
    return c, {"kv": L.kv_cache_axes(quantized=cfg.kv_cache_quant)}


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
    causal: bool = True,
    cache_len: int = 0,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], torch.Tensor]:
    """Returns (x_out, new_cache (or None), aux_loss scalar)."""
    _check_ported(spec)
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(
            f"mode {mode!r} is not ported yet (ROADMAP: LM training, launch/train.py)")
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
            out, st = forward(params["mixer"], h, cfg, return_cache=True)
    x = x + out.to(x.dtype)
    if spec.ffn != FFN_NONE:
        h = L.rmsnorm(params["norm2"], x, cfg.norm_eps)
        if spec.ffn == FFN_DENSE:
            out = L.mlp(params["ffn"], h, cfg)
        else:
            out, aux = MOE.moe_ffn(params["ffn"], h, cfg, gmm_impl=cfg.moe_gmm_impl)
        x = x + out.to(x.dtype)
    return x, {key: st}, aux
