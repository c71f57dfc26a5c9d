"""Batched serving entry point: prefill a prompt batch, decode N tokens.  The
port of ``repro.launch.serve``, with the same flags and printed lines.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b --reduced \
        --batch 4 --prompt-len 64 --decode-steps 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b --reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b --reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b --reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base --reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-26b --reduced

It runs on the CUDA card (and raises without one); ``serve(...,
device="cpu")`` runs it on the CPU.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.registry import make_serve_step, model_fns


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg: ModelConfig, batch: int = 4, prompt_len: int = 64, decode_steps: int = 32,
          temperature: float = 0.0, seed: int = 0, device: DeviceLike = None,
          log=print) -> Dict[str, Any]:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then decode
    ``decode_steps`` tokens (greedy at ``temperature`` 0, else sampled).
    An encoder-decoder also gets ``frames`` (B, prompt_len, d_model) and a
    VLM ``patch_embeds`` (B, n_vision_tokens, d_model), stubs drawn as the
    reference draws them (f32 normals); decode starts at position
    ``prompt_len + n_vision_tokens``.

    Where it differs from the reference's entry point:

    * the model runs with ``attn_impl``, ``ssm_impl``, ``rglru_impl`` and
      ``moe_gmm_impl`` set to ``"pallas"`` whatever ``cfg`` says, so on the
      card every prefill self-attention (an encoder's too), SSD scan and
      RG-LRU scan, and every expert product of prefill and decode, goes
      through its hand-written kernel (flash attention, ``ssd_scan``,
      ``rglru_scan``, ``gmm``); decode attends through the plain attention
      (an int8 cache is dequantized first) and steps the recurrences in
      plain torch, and cross-attention runs ``attention_chunked`` in
      prefill and decode, as the reference's do;
    * weights come from a ``torch.Generator`` seeded with ``seed``, prompts,
      stubs and sampling from one seeded with ``seed + 1`` (the reference's
      ``PRNGKey(0)`` and ``PRNGKey(1)``; the draws differ);
    * decode writes the caches in place (the reference donates them);
    * the self-attention caches hold ``prompt_len + n_vision_tokens +
      decode_steps + 1`` slots: the reference sizes them without the
      vision prefix, which truncates a VLM's prefilled cache and makes
      every decode step write its last slot.

    Returns the parameters, prompts, the stubs (``frames``,
    ``patch_embeds``: None where the model takes none), generated tokens
    ``(B, 1 + decode_steps)``, the logits of every step, and the wall
    seconds of prefill and decode."""
    dev = resolve_device(device)
    cfg = cfg.replace(attn_impl="pallas", ssm_impl="pallas", rglru_impl="pallas",
                      moe_gmm_impl="pallas")
    fns = model_fns(cfg)
    params, _ = fns.init(torch.Generator(device=dev).manual_seed(seed), dev)
    serve_step = make_serve_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    b, s = batch, prompt_len
    n_prefix = s + cfg.n_vision_tokens
    prompts = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
    inputs = {"tokens": prompts, "cache_len": n_prefix + decode_steps + 1}
    frames = patch_embeds = None
    if cfg.is_encdec:
        frames = inputs["frames"] = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
    if cfg.n_vision_tokens:
        patch_embeds = inputs["patch_embeds"] = torch.randn(
            (b, cfg.n_vision_tokens, cfg.d_model), generator=gen, device=dev)
    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = fns.prefill(params, inputs)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        log(f"prefill: {b}×{s} tokens in {t_prefill:.2f}s ({b*s/t_prefill:.0f} tok/s)")

        tok = torch.argmax(logits, -1)
        out, step_logits = [tok], [logits]
        t0 = time.perf_counter()
        for i in range(decode_steps):
            logits, cache = serve_step(params, cache, {"token": tok, "pos": n_prefix + i})
            if temperature > 0:
                probs = torch.softmax(logits.float() / temperature, -1)
                tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
            else:
                tok = torch.argmax(logits, -1)
            out.append(tok)
            step_logits.append(logits)
        _sync(dev)
        t_dec = time.perf_counter() - t0
    log(f"decode: {decode_steps} steps × batch {b} in {t_dec:.2f}s "
        f"({b*decode_steps/t_dec:.1f} tok/s)")
    tokens = torch.stack(out, dim=1)
    log("sample token ids:", tokens[0, :16].tolist())
    return {"params": params, "prompts": prompts, "frames": frames,
            "patch_embeds": patch_embeds, "tokens": tokens, "logits": step_logits,
            "prefill_s": t_prefill, "decode_s": t_dec}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    args = ap.parse_args()
    serve(get_config(args.arch, reduced=args.reduced), batch=args.batch,
          prompt_len=args.prompt_len, decode_steps=args.decode_steps,
          temperature=args.temperature)


if __name__ == "__main__":
    main()
