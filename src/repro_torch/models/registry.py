"""Model registry: family-dispatched init/prefill/decode.  The port of
``repro.models.registry`` for the families it serves: dense, moe (olmoe,
on one device), ssm (mamba2), hybrid (recurrentgemma), vlm (internvl2)
and the encoder-decoder (whisper).

Not ported yet: the losses and ``make_train_step`` (LM training, ROADMAP
queue 1 row 8) and ``input_specs`` (the dry-run planner, queue 1 row 9);
each raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as ED
from repro_torch.models import lm as LM

_TRAINING = "is not ported yet (ROADMAP: queue 1 row 8, LM training)"
_NO_SPECS = "input_specs is not ported yet (ROADMAP: queue 1 row 9, launch/dryrun.py)"

# Whisper cross-attention context at decode (native 30 s window = 1500 frames).
WHISPER_ENC_LEN = 1500
# VLM stub prefix length (InternViT patch embeddings, already projected).
VLM_PREFIX = 256


def decode_cache_len(seq_len: int, multiple: int = 512) -> int:
    """Decode-cache slots for a context of ``seq_len``: +1 for the new token,
    rounded up to ``multiple`` (the reference's rule, kept so both packages
    size caches alike)."""
    return ((seq_len + 1 + multiple - 1) // multiple) * multiple


@dataclass
class ModelFns:
    cfg: ModelConfig
    init: Callable        # (generator, device=None) -> (params, axes)
    loss: Callable
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
        raise NotImplementedError(f"the LM loss {_TRAINING}")

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


def make_train_step(cfg: ModelConfig):
    raise NotImplementedError(f"make_train_step {_TRAINING}")


def make_prefill_step(cfg: ModelConfig):
    fns = model_fns(cfg)

    def prefill_step(params, batch):
        return fns.prefill(params, batch)

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One decode step: (params, cache, batch{token,pos}) -> (logits, cache);
    the cache is written in place."""
    fns = model_fns(cfg)

    def serve_step(params, cache, batch):
        return fns.decode(params, cache, batch)

    return serve_step
