"""Model registry: family-dispatched init/loss/prefill/decode and the step
factories.  The port of ``repro.models.registry`` for the dense, moe
(olmoe, on one device), ssm (mamba2), hybrid (recurrentgemma) and vlm
(internvl2) families and the encoder-decoder (whisper).

``shapes_and_axes`` is the port's ``jax.eval_shape`` of a constructor: it
runs on the ``meta`` device, so a trillion-parameter config's tree costs no
memory.  Not ported yet: ``input_specs`` (the dry-run planner, ROADMAP
queue 1 row 9c), which raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as ED
from repro_torch.models import lm as LM
from repro_torch.optim.optimizers import clip_by_global_norm, make_optimizer
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

_NO_SPECS = "input_specs is not ported yet (ROADMAP: queue 1 row 9c, launch/dryrun.py)"

# Whisper cross-attention context at decode (native 30 s window = 1500 frames).
WHISPER_ENC_LEN = 1500
# VLM stub prefix length (InternViT patch embeddings, already projected).
VLM_PREFIX = 256


def decode_cache_len(seq_len: int, multiple: int = 512) -> int:
    """Decode-cache slots for a context of ``seq_len``: +1 for the new token,
    rounded up to ``multiple`` (the reference's rule, kept so both packages
    size caches alike)."""
    return ((seq_len + 1 + multiple - 1) // multiple) * multiple


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on ``meta``: the constructors draw on
    their generator's device, and ``torch.randn(..., generator=g,
    device="meta")`` takes a CPU generator."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def shapes_and_axes(fn, *args):
    """``(tensors, axes)`` of a constructor ``fn(*args, device=) -> (tensors,
    axes)`` run on the ``meta`` device: the tensors carry shapes and dtypes
    and no storage, the reference's ``jax.eval_shape``.  A generator among
    ``args`` draws on ``meta`` too."""
    args = tuple(_MetaGenerator() if isinstance(a, torch.Generator) else a for a in args)
    with torch.device("meta"):
        return fn(*args, device="meta")


@dataclass
class ModelFns:
    cfg: ModelConfig
    init: Callable        # (generator, device=None) -> (params, axes)
    loss: Callable        # (params, batch) -> (loss, metrics{ce, aux, tokens})
    prefill: Callable     # (params, batch{tokens, cache_len}) -> (logits, caches)
    decode: Callable      # (params, cache, batch{token, pos}) -> (logits, cache), in place
    make_cache: Callable  # (batch_size, cache_len, device=None) -> (caches, axes)
    input_specs: Callable


def model_fns(cfg: ModelConfig) -> ModelFns:
    if cfg.is_encdec:
        return _encdec_fns(cfg)
    return _lm_fns(cfg)


def _lm_fns(cfg: ModelConfig) -> ModelFns:
    def loss(params, batch):
        return LM.lm_loss(params, batch, cfg)

    def prefill(params, batch):
        return LM.lm_prefill(
            params,
            batch["tokens"],
            cfg,
            cache_len=batch.get("cache_len", 0) or batch["tokens"].shape[1],
            prefix_embeds=batch.get("patch_embeds"),
        )

    def decode(params, cache, batch):
        return LM.lm_decode_step(params, cache, batch["token"], batch["pos"], cfg)

    def make_cache(batch_size: int, cache_len: int, device=None):
        return LM.make_lm_cache(cfg, batch_size, cache_len, device)

    def input_specs(shape):
        raise NotImplementedError(_NO_SPECS)

    return ModelFns(
        cfg=cfg,
        init=lambda gen, device=None: LM.init_lm(gen, cfg, device),
        loss=loss,
        prefill=prefill,
        decode=decode,
        make_cache=make_cache,
        input_specs=input_specs,
    )


def _encdec_fns(cfg: ModelConfig) -> ModelFns:
    def loss(params, batch):
        return ED.encdec_loss(params, batch, cfg)

    def prefill(params, batch):
        return ED.encdec_prefill(
            params,
            batch["frames"],
            batch["tokens"],
            cfg,
            cache_len=batch.get("cache_len", 0) or batch["tokens"].shape[1],
        )

    def decode(params, cache, batch):
        return ED.encdec_decode_step(params, cache, batch["token"], batch["pos"], cfg)

    def make_cache(batch_size: int, cache_len: int, device=None):
        return ED.make_encdec_cache(cfg, batch_size, cache_len, WHISPER_ENC_LEN, device)

    def input_specs(shape):
        raise NotImplementedError(_NO_SPECS)

    return ModelFns(
        cfg=cfg,
        init=lambda gen, device=None: ED.init_encdec(gen, cfg, device),
        loss=loss,
        prefill=prefill,
        decode=decode,
        make_cache=make_cache,
        input_specs=input_specs,
    )


def value_and_grad(loss_fn: Callable, params, batch):
    """((loss, metrics), grads) of ``loss_fn(params, batch) -> (loss,
    metrics)``, as ``jax.value_and_grad(loss_fn, has_aux=True)`` gives them:
    ``grads`` is a tree like ``params``, zeros where the loss does not
    reach a leaf; ``loss`` and ``metrics`` are detached.  A DTensor leaf's
    gradient comes back under the leaf's own placements (a partial sum
    reduced, as ``jax.jit`` hands a gradient the parameter's sharding)."""
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, metrics = loss_fn(tree_unflatten(params, live), batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = tree_unflatten(params, [torch.zeros_like(p) if g is None else _placed_like(g, p)
                                    for p, g in zip(live, grads)])
    return tree_map(torch.Tensor.detach, (loss, metrics)), grads


def _placed_like(g, p):
    """``g`` under ``p``'s placements where both are DTensors."""
    placements = getattr(p, "placements", None)
    if placements is None or tuple(g.placements) == tuple(placements):
        return g
    return g.redistribute(p.device_mesh, placements)


def make_train_step(cfg: ModelConfig):
    """Returns (train_step, optimizer).  train_step: (params, opt_state,
    batch) -> (params, opt_state, metrics{ce, aux, tokens, loss,
    grad_norm}), new trees: the inputs are left as they were.  Inside a
    ``logical_sharding`` context on a mesh of several devices the trees are
    DTensors (``repro_torch.dist.sharding.distribute``) and so is every
    output, under its input's placements, as the reference's
    ``jax.jit(train_step, in_shardings=..., out_shardings=(params_sh,
    opt_sh, None))`` gives them."""
    fns = model_fns(cfg)
    opt = make_optimizer(cfg.optimizer, cfg.learning_rate, cfg.weight_decay)

    def train_step(params, opt_state, batch):
        (loss, metrics), grads = value_and_grad(fns.loss, params, batch)
        if cfg.grad_clip:
            grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        else:
            gnorm = torch.zeros((), device=loss.device)
        with torch.no_grad():
            params, opt_state = opt.update(grads, opt_state, params)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return params, opt_state, metrics

    return train_step, opt


def make_prefill_step(cfg: ModelConfig):
    fns = model_fns(cfg)

    def prefill_step(params, batch):
        return fns.prefill(params, batch)

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One decode step: (params, cache, batch{token,pos}) -> (logits, cache);
    the cache is written in place.  Inside a ``logical_sharding`` context
    on a mesh of several devices params, cache and batch are DTensors
    (``repro_torch.dist.sharding.distribute``: the cache by
    ``tree_shardings`` of ``make_cache``'s axes under a ``decode`` shape's
    ``default_rules``, the batch by ``batch_shardings``, ``pos``
    replicated).  What comes back is the logits, a DTensor under
    ``("act_batch", "vocab")``, and the cache under its input's placements,
    each leaf the same DTensor, written in each rank's local shard, as the
    reference's ``jax.jit(serve_step, in_shardings=(params_sh, cache_sh,
    batch_sh), out_shardings=(None, cache_sh))`` gives them.  A cache whose
    sequence dim is sharded raises ``NotImplementedError`` (ROADMAP queue 1
    row 9b-v)."""
    fns = model_fns(cfg)

    def serve_step(params, cache, batch):
        return fns.decode(params, cache, batch)

    return serve_step
