"""The plain version of the flash-attention kernel.

``attention_ref`` is the model's full-score attention
(``repro_torch.models.layers.attention_reference``) with the contiguous
positions the kernel assumes: query positions ``arange(Sq) + (Skv - Sq)``,
key positions ``arange(Skv)`` (``repro/kernels/flash_attention/ref.py``).
It is the CPU path of ``ops.flash_attention`` and the oracle the kernel is
held against on the card; never the path of a CUDA tensor.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.layers import attention_reference


def attention_ref(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Skv, Hk, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    b, sq, skv = q.shape[0], q.shape[1], k.shape[1]
    qpos = torch.arange(skv - sq, skv, device=q.device).expand(b, sq)
    kpos = torch.arange(skv, device=q.device).expand(b, skv)
    return attention_reference(q, k, v, qpos, kpos, causal=causal, window=window)
