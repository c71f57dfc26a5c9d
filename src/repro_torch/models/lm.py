"""Decoder-only language model over layer groups.  The port of
``repro.models.lm``: training (the ``full`` forward, ``chunked_ce`` and
``lm_loss``) and serving (prefill and decode) of the dense, moe (olmoe),
ssm (mamba2), hybrid (recurrentgemma) and vlm (internvl2) families, and
the decoder trunk of the encoder-decoder (whisper,
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

The training forward runs each layer body under ``maybe_remat``
(``cfg.remat``): ``none`` keeps every activation, ``full`` recomputes the
body in the backward (``torch.utils.checkpoint``), ``dots`` recomputes it
but keeps the matrix products' outputs.  A stacked group is unbound into
its layers once, so each stacked leaf's gradient is one ``stack`` of its
layers' gradients.  The cross-entropy runs over sequence chunks of
``cfg.loss_chunk`` in a Python loop, each chunk's ``logsumexp`` in f32.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist import shard_map as SM
from repro_torch.dist.sharding import (
    current_context,
    is_dtensor,
    require_distributed,
    use_context,
    with_logical_constraint,
)
from repro_torch.models import layers as L
from repro_torch.models.blocks import block_apply, block_cache, init_block
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Params = Dict[str, Any]


def _layer_axes(ax):
    """Prefix every axis tuple of ``ax`` with the stacked ``layers`` axis."""
    if isinstance(ax, dict):
        return {k: _layer_axes(v) for k, v in ax.items()}
    return ("layers",) + tuple(ax)


#: the products whose outputs ``remat="dots"`` keeps
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def maybe_remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """``fn`` under ``cfg.remat``: ``none`` as it is; ``full`` recomputed in
    the backward; ``dots`` recomputed but for the outputs of ``mm``, ``bmm``
    and ``addmm``, which are kept (the reference's
    ``dots_with_no_batch_dims_saveable`` keeps only the unbatched dots; what
    is kept moves memory and time, never the gradients).  Without grad mode
    nothing is saved for a backward, so ``fn`` runs as it is.  The
    recomputation runs inside the ``logical_sharding`` context of the
    forward, on whatever thread autograd runs it."""
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        ctx = current_context()

        def in_context(*a):   # the recomputation may run on autograd's device thread
            with use_context(ctx):
                return fn(*a)

        return checkpoint(in_context, *args, use_reentrant=False, **kw)

    return run


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
    """Token embeddings, after the projected ``prefix_embeds`` (B, N, D) if
    given.  Inside a context on a mesh of more than one device the tokens
    (and the prefix) must be DTensors."""
    require_distributed("embed_inputs", tokens, prefix_embeds)
    x = L.embed(params["tok"], tokens, cfg)
    if prefix_embeds is not None:
        cd = L._dt(cfg, "compute_dtype")
        vis = prefix_embeds.to(cd) @ params["vis_proj"].to(cd)
        x = torch.cat([vis, x], dim=1)
    return with_logical_constraint(x, "act_batch", "act_seq", None)


# --------------------------------------------------------------------------
# Trunk
# --------------------------------------------------------------------------


def _layer(tree, r: int):
    """Layer ``r`` of a stacked tree: views, so writes reach the stack (a
    DTensor's select on its unsharded layer axis is a DTensor whose local
    shard is a view of the stack's)."""
    return tree_map(lambda t: t[r], tree)


def unbind_layers(tree, n: int):
    """The ``n`` layers of a stacked tree, as views from one ``unbind`` a
    leaf: its backward stacks the layers' gradients into the leaf's at once,
    where ``n`` selects would each add a zero-filled copy of the leaf."""
    parts = [t.unbind(0) for t in tree_leaves(tree)]
    return [tree_unflatten(tree, [p[r] for p in parts]) for r in range(n)]


def lm_hidden(
    params: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    mode: str = "full",
    positions: Optional[torch.Tensor] = None,
    pos: Optional[int] = None,
    cache: Optional[Dict[str, Any]] = None,
    cache_len: int = 0,
    enc_out: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], torch.Tensor]:
    """Run all layer groups.  Returns (hidden, caches (None in ``full``
    mode), aux).

    ``full`` is the training forward: no cache, each layer body under
    ``maybe_remat``.  ``prefill`` builds new caches; ``decode`` writes
    ``cache`` in place and returns it.  Cross-attention blocks attend over
    ``enc_out`` in ``full`` and ``prefill`` mode and over their cache at
    decode."""
    if mode not in ("full", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}")
    b, s = x.shape[0], x.shape[1]
    if positions is None and mode != "decode":
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches: Dict[str, Any] = {}

    for gi, group in enumerate(cfg.groups):
        gp = params["groups"][f"g{gi}"]
        if mode == "full":

            def body(xx, au, layer_params, _group=group):
                for j, spec in enumerate(_group.pattern):
                    xx, _, a = block_apply(
                        layer_params[f"p{j}"], xx, cfg=cfg, spec=spec, mode="full",
                        positions=positions, causal=causal, enc_out=enc_out,
                    )
                    au = au + a
                return xx, au

            rbody = maybe_remat(body, cfg)
            for lp in unbind_layers(gp, group.repeat):
                x, aux = rbody(x, aux, lp)
        elif mode == "prefill":
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
    return x, (new_caches if mode != "full" else None), aux


# --------------------------------------------------------------------------
# Loss (chunked cross-entropy)
# --------------------------------------------------------------------------


def chunked_ce(
    params: Params,
    hidden: torch.Tensor,
    targets: torch.Tensor,
    mask: torch.Tensor,
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (sum CE over masked tokens, mask count), the logits of one
    chunk of ``cfg.loss_chunk`` positions at a time; unchunked where the
    chunk does not divide the sequence, as the reference does."""
    s = hidden.shape[1]
    chunk = min(cfg.loss_chunk or s, s)
    if s % chunk != 0:
        chunk = s  # fall back to unchunked rather than pad

    def ce_chunk(h, t, m):
        logits = L.logits_from_hidden(params["tok"], h, cfg)
        logits = with_logical_constraint(logits, "act_batch", None, "vocab")
        if is_dtensor(logits):
            return _ce_sharded(logits, t, m)
        return _ce_sums(logits, t, m)

    if chunk == s:
        return ce_chunk(hidden, targets, mask)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        lsum, lcnt = ce_chunk(hidden[:, c0:c0 + chunk], targets[:, c0:c0 + chunk],
                              mask[:, c0:c0 + chunk])
        tot, cnt = tot + lsum, cnt + lcnt
    return tot, cnt


def _ce_sharded(logits, targets, mask):
    """``_ce_sums`` on DTensor logits (B, S, V), vocab-parallel under
    ``shard_map``: each rank holds its rows and its block of the
    vocabulary, and no rank gathers a vocabulary row."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.dist.sharding import P

    mesh = logits.device_mesh
    names = tuple(mesh.mesh_dim_names)
    by_dim = {0: [], 2: []}
    for name, p in zip(names, logits.placements):
        if p.is_shard() and p.dim in by_dim:
            by_dim[p.dim].append(name)
    b_axes, v_axes = tuple(by_dim[0]), tuple(by_dim[2])

    def placed(t):
        if isinstance(t, DTensor):
            return t
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)

    row = P(b_axes or None, None)
    fn = SM.shard_map(functools.partial(_ce_sums, b_axes=b_axes, v_axes=v_axes), mesh,
                      in_specs=(P(b_axes or None, None, v_axes or None), row, row),
                      out_specs=(P(), P()))
    return fn(logits, placed(targets), placed(mask))


def _ce_sums(lg, tg, mk, b_axes=(), v_axes=()):
    """(sum of the masked tokens' cross-entropy, mask count) of logits
    ``lg`` (B, S, V_loc): this rank's rows along ``b_axes`` and block of
    the vocabulary along ``v_axes`` (all of either over no axes).  The
    log-sum-exp takes the max and the sum of exponentials over the
    vocabulary's shards, the target's logit comes from the one shard that
    holds it, and both sums are summed over the batch's shards."""
    lg = lg.float()
    v_loc = lg.shape[-1]
    mx = SM.pmax(lg.amax(-1), v_axes)
    logz = mx + torch.log(SM.psum(torch.exp(lg - mx[..., None]).sum(-1), v_axes))
    idx = tg.long() - SM.flat_index(v_axes) * v_loc
    held = (idx >= 0) & (idx < v_loc)
    tl = torch.gather(lg, -1, idx.clamp(0, v_loc - 1)[..., None])[..., 0]
    tgt = SM.psum(torch.where(held, tl, torch.zeros_like(tl)), v_axes)
    return SM.psum(torch.sum((logz - tgt) * mk), b_axes), SM.psum(torch.sum(mk), b_axes)


def next_token_targets(tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(targets, mask): each position's next token, and 1 at every position
    but the last, which has none (its target is 0, masked out)."""
    b, s = tokens.shape
    targets = torch.cat([tokens[:, 1:], tokens.new_zeros((b, 1))], dim=1)
    mask = torch.ones((b, s), dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    return targets, mask


def lm_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """batch: tokens (B,S) int, optional loss_mask (B,S), optional
    patch_embeds (B, n_vis, D) for a VLM.  Next-token CE plus
    ``router_aux_coef`` times the MoE layers' aux loss.  Returns (loss,
    {ce, aux, tokens})."""
    tokens = batch["tokens"]
    prefix = batch.get("patch_embeds")
    x = embed_inputs(params, tokens, cfg, prefix)
    hidden, _, aux = lm_hidden(params, x, cfg, mode="full")
    if prefix is not None and prefix.shape[1]:
        hidden = hidden[:, prefix.shape[1]:]
    targets, mask = next_token_targets(tokens)
    if "loss_mask" in batch:
        mask = mask * batch["loss_mask"].float()
    tot, cnt = chunked_ce(params, hidden, targets, mask, cfg)
    ce = tot / torch.clamp(cnt, min=1.0)
    loss = ce + cfg.router_aux_coef * aux
    return loss, {"ce": ce, "aux": aux, "tokens": cnt}


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
    logits = with_logical_constraint(logits, "act_batch", None, "vocab")
    return logits[:, 0], caches


def lm_decode_step(
    params: Params,
    cache: Dict[str, Any],
    token: torch.Tensor,  # (B,) int
    pos: int,             # position being written
    cfg: ModelConfig,
):
    """One decode step.  Returns (logits (B,V), cache): ``cache`` is written
    in place and returned (the reference donates its buffer instead).
    ``pos`` may be a replicated DTensor scalar: ``int`` reads its local
    value, with no collective."""
    x = embed_inputs(params, token[:, None], cfg)
    hidden, caches, _ = lm_hidden(params, x, cfg, mode="decode", pos=int(pos), cache=cache)
    logits = L.logits_from_hidden(params["tok"], hidden, cfg)
    logits = with_logical_constraint(logits, "act_batch", None, "vocab")
    return logits[:, 0], caches
