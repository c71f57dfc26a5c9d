"""Griffin / RecurrentGemma recurrent block with RG-LRU [arXiv:2402.19427].
The port of ``repro.models.rglru``.

Block: two input branches (recurrent branch with a short causal depthwise
conv + RG-LRU; gate branch with GELU), elementwise merge, output projection.
RG-LRU: r/i gates from the post-conv branch, log-decay
``log a = -c·softplus(Λ)·r`` (c = 8), input scaled by sqrt(1 - a²).  The
scan is ``cfg.rglru_impl``: the plain versions, or ``"pallas"``, the
hand-written Hopper kernels in ``repro_torch.kernels.rglru_scan``; under
grad on the card its forward and backward are both kernels, so the hybrid
family trains on them (with ``attn_impl="pallas"``, its local attention on
the flash kernels too).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru_scan import ops as lru_ops
from repro_torch.models.layers import _dt, _normal
from repro_torch.models.mamba2 import causal_depthwise_conv

Params = Dict[str, Any]

RGLRU_C = 8.0


def init_rglru(gen: torch.Generator, cfg: ModelConfig) -> Tuple[Params, Params]:
    d = cfg.d_model
    w = cfg.resolved_lru_width
    cw = cfg.lru_conv_width
    pd = _dt(cfg, "param_dtype")
    dev = gen.device
    std = 0.02
    out_std = 0.02 / math.sqrt(2.0 * max(cfg.total_layers, 1))
    # Λ init so that a^c ~ uniform(0.9, 0.999) as in Griffin
    u = 0.9 + 0.099 * torch.rand((w,), generator=gen, device=dev)
    lam = torch.log(torch.expm1(-torch.log(u) / RGLRU_C))  # softplus^-1(-log u / c)
    params = {
        "wx": _normal(gen, (d, w), std, pd),
        "wgate": _normal(gen, (d, w), std, pd),
        "conv": _normal(gen, (cw, w), 1.0 / math.sqrt(cw), pd),
        "wa": _normal(gen, (w, w), 1.0 / math.sqrt(w), pd),
        "ba": torch.zeros((w,), dtype=torch.float32, device=dev),
        "wi": _normal(gen, (w, w), 1.0 / math.sqrt(w), pd),
        "bi": torch.zeros((w,), dtype=torch.float32, device=dev),
        "lam": lam.float(),
        "wo": _normal(gen, (w, d), out_std, pd),
    }
    axes = {
        "wx": ("embed", "lru"),
        "wgate": ("embed", "lru"),
        "conv": ("conv", "lru"),
        "wa": ("lru", "lru_out"),
        "ba": ("lru",),
        "wi": ("lru", "lru_out"),
        "bi": ("lru",),
        "lam": ("lru",),
        "wo": ("lru", "embed"),
    }
    return params, axes


def _gates(params: Params, xb: torch.Tensor):
    """log_a, b_input from the post-conv recurrent branch xb (…, W)."""
    x32 = xb.float()
    r = torch.sigmoid(x32 @ params["wa"].float() + params["ba"])
    i = torch.sigmoid(x32 @ params["wi"].float() + params["bi"])
    log_a = -RGLRU_C * F.softplus(params["lam"]) * r
    scale = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = scale * (i * x32)
    return log_a, b


def rglru_forward(
    params: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    return_cache: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    cd = _dt(cfg, "compute_dtype")
    xc = x.to(cd)
    xb = xc @ params["wx"].to(cd)
    gate = F.gelu(xc @ params["wgate"].to(cd), approximate="tanh")   # jax.nn.gelu's default
    xb_raw = xb
    xb = causal_depthwise_conv(xb, params["conv"].to(cd))
    log_a, b = _gates(params, xb)
    y, h_final = lru_ops.rglru_scan(log_a, b, impl=cfg.rglru_impl)
    out = (y.to(cd) * gate) @ params["wo"].to(cd)
    cache = None
    if return_cache:
        cw = cfg.lru_conv_width
        tail = xb_raw[:, -(cw - 1):]
        pad = (cw - 1) - tail.shape[1]
        if pad > 0:
            tail = F.pad(tail, (0, 0, pad, 0))
        cache = {"conv": tail, "h": h_final}
    return out, cache


def rglru_cache(cfg: ModelConfig, batch: int, device=None) -> Dict[str, torch.Tensor]:
    w = cfg.resolved_lru_width
    return {
        "conv": torch.zeros((batch, cfg.lru_conv_width - 1, w),
                            dtype=_dt(cfg, "compute_dtype"), device=device),
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }


def rglru_cache_axes() -> Dict[str, Tuple[str, ...]]:
    return {"conv": ("act_batch", "conv", "lru"), "h": ("act_batch", "lru")}


def rglru_decode(
    params: Params,
    x: torch.Tensor,  # (B, 1, D)
    cache: Dict[str, torch.Tensor],
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token against the cache.  Returns (out, new cache); ``cache`` is
    not written (the caller writes the new one in place)."""
    cd = _dt(cfg, "compute_dtype")
    xc = x.to(cd)
    xb_t = xc @ params["wx"].to(cd)                                  # (B,1,W)
    gate = F.gelu(xc @ params["wgate"].to(cd), approximate="tanh")
    window = torch.cat([cache["conv"], xb_t], dim=1)                 # (B, CW, W)
    conv_out = torch.einsum("bcw,cw->bw", window, params["conv"].to(cd))
    log_a, b = _gates(params, conv_out)
    y, h_new = lru_ops.rglru_decode_step(cache["h"], log_a, b)
    out = (y.to(cd) * gate[:, 0]) @ params["wo"].to(cd)
    return out[:, None], {"conv": window[:, 1:], "h": h_new}
