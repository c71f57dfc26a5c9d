"""The plain versions of the flash-attention kernels.

``attention_ref`` is the model's full-score attention
(``repro_torch.models.layers.attention_reference``) with the contiguous
positions the kernel assumes: query positions ``arange(Sq) + (Skv - Sq)``,
key positions ``arange(Skv)`` (``repro/kernels/flash_attention/ref.py``).
It is the CPU path of ``ops.flash_attention`` (its gradient torch's
autograd) and the oracle the forward is held against on the card.
``attention_lse_ref`` is the log-sum-exp the forward saves under grad and
``attention_bwd_ref`` the backward's (dq, dk, dv): the oracles of the
backward's kernels on the card.  None of them is the path of a CUDA tensor.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.models.layers import MASK_VALUE, _mask, attention_reference


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


def attention_lse_ref(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Skv, Hk, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """(B, Hq, Sq) f32: each row's log-sum-exp of the scores the kernel
    computes, q / sqrt(D) rounded to q's dtype times k, masked pairs at
    MASK_VALUE (the same for a row with a live key: a masked pair's term
    is 0)."""
    b, sq, hq, d = q.shape
    skv, hk = k.shape[1], k.shape[2]
    qs = (q.float() * (1.0 / math.sqrt(d))).to(q.dtype).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qs.reshape(b, sq, hk, hq // hk, d), k.float())
    qpos = torch.arange(skv - sq, skv, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    scores = torch.where(_mask(qpos, kpos, causal, window), scores, MASK_VALUE)
    return torch.logsumexp(scores, dim=-1).reshape(b, hq, sq)


def attention_bwd_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``attention_ref`` for the cotangent ``do``: torch's
    autograd through it in f32, cast to q's dtype."""
    with torch.enable_grad():
        qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
        out = attention_ref(qf, kf, vf, causal=causal, window=window)
        grads = torch.autograd.grad(out, (qf, kf, vf), do.float())
    return tuple(g.to(q.dtype) for g in grads)
