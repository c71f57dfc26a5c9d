"""Whisper-style encoder-decoder backbone [arXiv:2212.04356].  The port of
``repro.models.encdec``: its loss and its serving.

The conv frontend is a stub, as in the reference: the caller supplies frame
embeddings (B, S_enc, d_model).  Encoder: bidirectional attention + GELU
MLP with sinusoidal positions, ``ENC_SPEC`` blocks stacked on a leading
layer axis and run in a Python loop.  Decoder: the LM trunk of
``repro_torch.models.lm`` (``tok``, ``groups``, ``final_norm``) whose
blocks carry cross-attention, with sinusoidal positions added to the
token embeddings and no RoPE (the reference's ``_sinusoid_at`` is
``layers.sinusoid_at``).  The encoder's layer bodies run under
``maybe_remat``, as the decoder's do in ``lm_hidden``'s training forward.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.sharding import with_logical_constraint
from repro_torch.models import layers as L
from repro_torch.models.blocks import block_apply, init_block
from repro_torch.models.lm import (
    chunked_ce,
    init_lm,
    init_stacked,
    lm_hidden,
    make_lm_cache,
    maybe_remat,
    next_token_targets,
    unbind_layers,
)
from repro_torch.tree import tree_map

Params = Dict[str, Any]

ENC_SPEC = LayerSpec(mixer="attn", ffn="dense", window=None, cross_attn=False)


def init_encdec(gen: torch.Generator, cfg: ModelConfig,
                device: DeviceLike = None) -> Tuple[Params, Params]:
    """(params, axes): ``init_lm``'s decoder trunk, then ``enc/blocks``
    stacked on a leading layer axis and ``enc/norm``, the reference's tree."""
    dev = resolve_device(device)
    params, axes = init_lm(gen, cfg, dev)
    stack, stack_axes = init_stacked(cfg.n_enc_layers, lambda: init_block(gen, cfg, ENC_SPEC))
    norm, norm_axes = L.init_rmsnorm(cfg.d_model, cfg, gen.device)
    params["enc"] = tree_map(lambda t: t.to(dev), {"blocks": stack, "norm": norm})
    axes["enc"] = {"blocks": stack_axes, "norm": norm_axes}
    return params, axes


def encode(params: Params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, S_enc, d_model), the stubbed conv frontend's output."""
    b, s, d = frames.shape
    cd = L._dt(cfg, "compute_dtype")
    x = frames.to(cd) + L.sinusoidal_positions(s, d, cd, frames.device)[None]
    x = with_logical_constraint(x, "act_batch", "act_seq", None)
    positions = torch.arange(s, dtype=torch.int32, device=frames.device).expand(b, s)

    def body(xx, layer_params):
        return block_apply(layer_params, xx, cfg=cfg, spec=ENC_SPEC, mode="full",
                           positions=positions, causal=False)[0]

    rbody = maybe_remat(body, cfg)
    for lp in unbind_layers(params["enc"]["blocks"], cfg.n_enc_layers):
        x = rbody(x, lp)
    return L.rmsnorm(params["enc"]["norm"], x, cfg.norm_eps)


def _dec_embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig, pos0: int = 0):
    """Token embeddings plus the sinusoids of positions ``pos0 ..``."""
    x = L.embed(params["tok"], tokens, cfg)
    pos = torch.arange(pos0, pos0 + tokens.shape[1], device=tokens.device)
    x = x + L.sinusoid_at(pos, cfg.d_model, L._dt(cfg, "compute_dtype"))[None]
    return with_logical_constraint(x, "act_batch", "act_seq", None)


def encdec_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """batch: frames (B, S_enc, D) float, tokens (B, S_dec) int.  The
    decoder's next-token CE (the aux loss is reported, not added, as the
    reference does).  Returns (loss, {ce, aux, tokens})."""
    enc_out = encode(params, batch["frames"], cfg)
    tokens = batch["tokens"]
    x = _dec_embed(params, tokens, cfg)
    hidden, _, aux = lm_hidden(params, x, cfg, mode="full", enc_out=enc_out)
    targets, mask = next_token_targets(tokens)
    tot, cnt = chunked_ce(params, hidden, targets, mask, cfg)
    ce = tot / torch.clamp(cnt, min=1.0)
    return ce, {"ce": ce, "aux": aux, "tokens": cnt}


def encdec_prefill(
    params: Params,
    frames: torch.Tensor,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    *,
    cache_len: int = 0,
):
    """Encode, then run the decoder prompt; returns (last logits (B,V), caches)."""
    enc_out = encode(params, frames, cfg)
    cache_len = cache_len or tokens.shape[1]
    x = _dec_embed(params, tokens, cfg)
    hidden, caches, _ = lm_hidden(params, x, cfg, mode="prefill", cache_len=cache_len,
                                  enc_out=enc_out)
    logits = L.logits_from_hidden(params["tok"], hidden[:, -1:], cfg)
    return logits[:, 0], caches


def encdec_decode_step(
    params: Params,
    cache: Dict[str, Any],
    token: torch.Tensor,  # (B,) int
    pos: int,             # position being written
    cfg: ModelConfig,
):
    """One decode step; ``cache`` is written in place and returned."""
    pos = int(pos)
    x = _dec_embed(params, token[:, None], cfg, pos0=pos)
    hidden, caches, _ = lm_hidden(params, x, cfg, mode="decode", pos=pos, cache=cache)
    logits = L.logits_from_hidden(params["tok"], hidden, cfg)
    logits = with_logical_constraint(logits, "act_batch", None, "vocab")
    return logits[:, 0], caches


def make_encdec_cache(cfg: ModelConfig, batch: int, cache_len: int, enc_len: int,
                      device: DeviceLike = None):
    return make_lm_cache(cfg, batch, cache_len, device, enc_len=enc_len)
