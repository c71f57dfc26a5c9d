"""Plain PyTorch versions of the RG-LRU linear recurrence (Griffin [2402.19427];
``repro/kernels/rglru_scan/ref.py``).

The scan is the diagonal first-order recurrence
    h_t = a_t * h_{t-1} + b_t
with per-(time, lane) decay a_t in (0, 1] given as ``log_a`` and the input
``b`` computed by the block.

``rglru_sequential`` is the step recurrence (the ground truth);
``rglru_associative`` combines the monoid ((a1·a2), (a2·b1 + b2)) by
recursive doubling: log2(L) whole-tensor steps, no loop over time.  It is
the CPU path of ``ops.rglru_scan(impl="pallas")`` and the oracle the kernel
is held against on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def rglru_sequential(
    log_a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """log_a, b: (B, L, W).  Returns (y (B,L,W) in b's dtype, h_final (B,W) f32)."""
    bs, l, w = b.shape
    a = torch.exp(log_a.float())
    bf = b.float()
    h = torch.zeros((bs, w), dtype=torch.float32, device=b.device) if h0 is None else h0.float()
    ys = []
    for t in range(l):
        h = a[:, t] * h + bf[:, t]
        ys.append(h)
    y = torch.stack(ys, dim=1) if ys else bf
    return y.to(b.dtype), h


def rglru_associative(
    log_a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    a = torch.exp(log_a.float())
    hs = b.float()
    if h0 is not None:  # fold the initial state into the first step
        hs = hs.clone()
        hs[:, 0] += a[:, 0] * h0.float()
    l = hs.shape[1]
    shift = 1
    while shift < l:  # step k: each position absorbs the segment ending `shift` before it
        prev_h = F.pad(hs[:, :-shift], (0, 0, shift, 0))
        prev_a = F.pad(a[:, :-shift], (0, 0, shift, 0), value=1.0)
        hs = a * prev_h + hs
        a = a * prev_a
        shift *= 2
    return hs.to(b.dtype), hs[:, -1].float()
