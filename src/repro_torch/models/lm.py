"""Decoder-only language model over layer groups.  The port of
``repro.models.lm`` for serving (prefill and decode) of the dense, moe
(olmoe), ssm (mamba2), hybrid (recurrentgemma) and vlm (internvl2)
families, and the decoder trunk of the encoder-decoder (whisper,
``repro_torch.models.encdec``).

Layer groups (``cfg.groups``) hold stacked parameters on a leading layer
axis, as the reference's scanned groups do; the port loops over that axis
in Python, and within one step unrolls the group's (short) pattern, so
gemma3's local/global pattern is a two-block body run ``repeat`` times.
Caches keep the reference's structure: a dict of groups, a tuple per
pattern position, a leading layer axis; an attention block holds ``{"kv":
{"k", "v"}}``, a Mamba-2 block ``{"ssm": {"conv", "ssm"}}`` and an RG-LRU
block ``{"lru": {"conv", "h"}}``, and a cross-attention block also
``{"cross": {"k", "v"}}``, with the reference's shapes and dtypes.  The
prefill sums the MoE layers' aux losses, as the reference does.  A VLM's
patch embeddings go through ``vis_proj`` and in front of the tokens.

Not ported yet: the ``full`` training forward, ``chunked_ce`` and
``lm_loss`` (LM training, ROADMAP queue 1 row 8).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.blocks import block_apply, block_cache, init_block
from repro_torch.tree import tree_map

Params = Dict[str, Any]


def _layer_axes(ax):
    """Prefix every axis tuple of ``ax`` with the stacked ``layers`` axis."""
    if isinstance(ax, dict):
        return {k: _layer_axes(v) for k, v in ax.items()}
    return ("layers",) + tuple(ax)


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------


def init_stacked(n: int, init_one) -> Tuple[Params, Params]:
    """(params, axes) of ``n`` layers drawn by ``init_one() -> (params,
    axes)``, on a leading ``layers`` axis.  Each layer is copied into the
    stack as soon as it is drawn, so the peak is the stack and one layer."""
    stack = axes = None
    for r in range(n):
        p, axes = init_one()
        if stack is None:
            stack = tree_map(lambda t: t.new_empty((n, *t.shape)), p)
        tree_map(lambda dst, src: dst[r].copy_(src), stack, p)
    return stack, _layer_axes(axes)


def init_lm(gen: torch.Generator, cfg: ModelConfig,
            device: DeviceLike = None) -> Tuple[Params, Params]:
    """(params, axes): the reference's tree (``tok``, a VLM's ``vis_proj``,
    ``groups/g{i}/p{j}/…`` stacked on a leading layer axis, ``final_norm``)
    with its shapes, dtypes and init laws.  Draws come from ``gen`` on its
    own device (a CUDA generator draws on the card), then move to
    ``device``.  Each layer is copied into its group's stack as soon as it
    is drawn, so the peak is the weights and one layer (olmoe's f32 experts
    are 25.8 GB)."""
    dev = resolve_device(device)
    params: Params = {}
    axes: Params = {}
    params["tok"], axes["tok"] = L.init_embedding(gen, cfg)
    if cfg.n_vision_tokens:
        params["vis_proj"] = L._normal(gen, (cfg.d_model, cfg.d_model), 0.02,
                                       L._dt(cfg, "param_dtype"))
        axes["vis_proj"] = ("embed", None)
    groups_p, groups_a = {}, {}
    for gi, group in enumerate(cfg.groups):

        def init_one(_group=group):
            p, a = {}, {}
            for j, spec in enumerate(_group.pattern):
                p[f"p{j}"], a[f"p{j}"] = init_block(gen, cfg, spec)
            return p, a

        groups_p[f"g{gi}"], groups_a[f"g{gi}"] = init_stacked(group.repeat, init_one)
    params["groups"] = groups_p
    axes["groups"] = groups_a
    params["final_norm"], axes["final_norm"] = L.init_rmsnorm(cfg.d_model, cfg, gen.device)
    return tree_map(lambda t: t.to(dev), params), axes


# --------------------------------------------------------------------------
# Embedding of inputs
# --------------------------------------------------------------------------


def embed_inputs(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                 prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings, after the projected ``prefix_embeds`` (B, N, D) if given."""
    x = L.embed(params["tok"], tokens, cfg)
    if prefix_embeds is not None:
        cd = L._dt(cfg, "compute_dtype")
        vis = prefix_embeds.to(cd) @ params["vis_proj"].to(cd)
        x = torch.cat([vis, x], dim=1)
    return x


# --------------------------------------------------------------------------
# Trunk
# --------------------------------------------------------------------------


def _layer(tree, r: int):
    """Layer ``r`` of a stacked tree: views, so writes reach the stack."""
    return tree_map(lambda t: t[r], tree)


def lm_hidden(
    params: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    mode: str = "prefill",
    positions: Optional[torch.Tensor] = None,
    pos: Optional[int] = None,
    cache: Optional[Dict[str, Any]] = None,
    cache_len: int = 0,
    enc_out: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], torch.Tensor]:
    """Run all layer groups.  Returns (hidden, caches, aux).

    ``prefill`` builds new caches; ``decode`` writes ``cache`` in place and
    returns it.  Cross-attention blocks attend over ``enc_out`` at prefill
    and over their cache at decode."""
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(
            f"mode {mode!r} is not ported yet (ROADMAP: queue 1 row 8, LM training)")
    b, s = x.shape[0], x.shape[1]
    if positions is None and mode == "prefill":
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches: Dict[str, Any] = {}

    for gi, group in enumerate(cfg.groups):
        gp = params["groups"][f"g{gi}"]
        if mode == "prefill":
            per_layer = []
            for r in range(group.repeat):
                lp, caches = _layer(gp, r), []
                for j, spec in enumerate(group.pattern):
                    x, c, a = block_apply(
                        lp[f"p{j}"], x, cfg=cfg, spec=spec, mode="prefill",
                        positions=positions, causal=causal, cache_len=cache_len,
                        enc_out=enc_out,
                    )
                    caches.append(c)
                    aux = aux + a
                per_layer.append(tuple(caches))
            new_caches[f"g{gi}"] = tree_map(lambda *ts: torch.stack(ts), *per_layer)
        else:
            gc = cache[f"g{gi}"]
            for r in range(group.repeat):
                lp, lc = _layer(gp, r), _layer(gc, r)
                for j, spec in enumerate(group.pattern):
                    x, _, _ = block_apply(
                        lp[f"p{j}"], x, cfg=cfg, spec=spec, mode="decode",
                        pos=pos, cache=lc[j],
                    )
            new_caches[f"g{gi}"] = gc

    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, new_caches, aux


# --------------------------------------------------------------------------
# Serving
# --------------------------------------------------------------------------


def make_lm_cache(
    cfg: ModelConfig, batch: int, cache_len: int, device: DeviceLike = None,
    enc_len: int = 0,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Zeroed decode caches and their axes; ``enc_len`` sizes the cross
    caches of an encoder-decoder."""
    dev = resolve_device(device)
    caches, axes = {}, {}
    for gi, group in enumerate(cfg.groups):
        cs, axs = [], []
        for spec in group.pattern:
            c, a = block_cache(cfg, spec, batch, cache_len, enc_len, "meta")   # shapes and dtypes only
            cs.append(tree_map(
                lambda t: torch.zeros((group.repeat,) + tuple(t.shape), dtype=t.dtype,
                                      device=dev), c))
            axs.append(_layer_axes(a))
        caches[f"g{gi}"] = tuple(cs)
        axes[f"g{gi}"] = tuple(axs)
    return caches, axes


def lm_prefill(
    params: Params,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    *,
    cache_len: int = 0,
    prefix_embeds: Optional[torch.Tensor] = None,
):
    """Returns (last-token logits (B,V), caches)."""
    x = embed_inputs(params, tokens, cfg, prefix_embeds)
    cache_len = cache_len or x.shape[1]
    hidden, caches, _ = lm_hidden(params, x, cfg, mode="prefill", cache_len=cache_len)
    logits = L.logits_from_hidden(params["tok"], hidden[:, -1:], cfg)
    return logits[:, 0], caches


def lm_decode_step(
    params: Params,
    cache: Dict[str, Any],
    token: torch.Tensor,  # (B,) int
    pos: int,             # position being written
    cfg: ModelConfig,
):
    """One decode step.  Returns (logits (B,V), cache): ``cache`` is written
    in place and returned (the reference donates its buffer instead)."""
    x = embed_inputs(params, token[:, None], cfg)
    hidden, caches, _ = lm_hidden(params, x, cfg, mode="decode", pos=int(pos), cache=cache)
    logits = L.logits_from_hidden(params["tok"], hidden, cfg)
    return logits[:, 0], caches
