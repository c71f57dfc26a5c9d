"""The plain version of the int8 split-KV decode kernel.

``flash_decode_int8_ref`` computes what the TPU kernel
``repro/kernels/flash_attention/decode_kernel.py:70-115`` computes: one
query per (batch, head) against an int8 K/V cache whose per-(position,
head) scales are applied on the fly, GQA through ``h // (Hq / Hk)``,
positions ``>= kv_len`` masked.  Step for step:

* q is pre-scaled by ``1/√D`` in f32 and rounded back to q's dtype (``:90``),
  then widened to f32 for the scores;
* K and V are dequantized as ``int8 · f32(scale)``;
* scores at positions ``>= kv_len`` are ``-1e30``;
* softmax with the ``1e-37`` floor on its sum; the output is f32.

It is the CPU path of ``decode_ops.flash_decode_int8`` and the oracle the
kernel is held against on the card; never the path of a CUDA tensor.  It
materializes the dequantized f32 K/V and the full score row.
"""
from __future__ import annotations

import math

import torch

MASK_VALUE = -1e30


def flash_decode_int8_ref(
    q: torch.Tensor,        # (B, Hq, D) f32 or bf16
    k_q: torch.Tensor,      # (B, Hk, S, D) int8
    v_q: torch.Tensor,      # (B, Hk, S, D) int8
    k_scale: torch.Tensor,  # (B, Hk, S)
    v_scale: torch.Tensor,  # (B, Hk, S)
    *,
    kv_len: int,
) -> torch.Tensor:
    """Returns o (B, Hq, D) in f32."""
    b, hq, d = q.shape
    hk, s = k_q.shape[1], k_q.shape[2]
    g = hq // hk
    qs = (q.float() * (1.0 / math.sqrt(d))).to(q.dtype).float()
    k = k_q.float() * k_scale.float()[..., None]          # (B, Hk, S, D)
    v = v_q.float() * v_scale.float()[..., None]
    scores = torch.einsum("bhgd,bhsd->bhgs", qs.reshape(b, hk, g, d), k)
    live = torch.arange(s, device=q.device) < kv_len
    scores = torch.where(live, scores, MASK_VALUE)
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgs,bhsd->bhgd", p, v) / torch.clamp(l, min=1e-37)
    return o.reshape(b, hq, d)
