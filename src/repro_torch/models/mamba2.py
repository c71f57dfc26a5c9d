"""Mamba-2 (SSD) mixer block [arXiv:2405.21060].  The port of
``repro.models.mamba2``.

Block layout follows the reference Mamba-2: separate input projections for
(z, x, B, C, dt), a short causal depthwise conv on (x, B, C), softplus dt
with a learned bias, the SSD scan (``cfg.ssm_impl``: the plain versions, or
``"pallas"``, the hand-written Hopper kernel in
``repro_torch.kernels.ssd_scan``), a per-head D skip, gated RMSNorm, and an
output projection.  Parameters keep the reference's layout (dense ``(in,
out)``) and dtypes, and the compute-dtype casts come in its order.

Decode carries two states: the (W-1)-step conv window and the (H, P, N)
SSM state, both O(1) in sequence length.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers import _dt, _normal

Params = Dict[str, Any]


def init_mamba2(gen: torch.Generator, cfg: ModelConfig) -> Tuple[Params, Params]:
    d = cfg.d_model
    di = cfg.d_inner
    g, n = cfg.ssm_groups, cfg.ssm_state
    h = cfg.n_ssm_heads
    w = cfg.ssm_conv_width
    pd = _dt(cfg, "param_dtype")
    dev = gen.device
    std = 0.02
    out_std = 0.02 / math.sqrt(2.0 * max(cfg.total_layers, 1))
    params = {
        "wz": _normal(gen, (d, di), std, pd),
        "wx": _normal(gen, (d, di), std, pd),
        "wb": _normal(gen, (d, g * n), std, pd),
        "wc": _normal(gen, (d, g * n), std, pd),
        "wdt": _normal(gen, (d, h), std, pd),
        "conv_x": _normal(gen, (w, di), 1.0 / math.sqrt(w), pd),
        "conv_b": _normal(gen, (w, g * n), 1.0 / math.sqrt(w), pd),
        "conv_c": _normal(gen, (w, g * n), 1.0 / math.sqrt(w), pd),
        # A in [-16, -1]: log-spaced per head, as Mamba-2 initialises it
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=dev),
        "norm": torch.ones((di,), dtype=pd, device=dev),
        "wo": _normal(gen, (di, d), out_std, pd),
    }
    axes = {
        "wz": ("embed", "inner"),
        "wx": ("embed", "inner"),
        "wb": ("embed", None),
        "wc": ("embed", None),
        "wdt": ("embed", "ssd_heads"),
        "conv_x": ("conv", "inner"),
        "conv_b": ("conv", None),
        "conv_c": ("conv", None),
        "a_log": ("ssd_heads",),
        "dt_bias": ("ssd_heads",),
        "d_skip": ("ssd_heads",),
        "norm": ("inner",),
        "wo": ("inner", "embed"),
    }
    return params, axes


def causal_depthwise_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u: (B, L, C), w: (W, C).  y[t] = sum_j w[j] * u[t - W + 1 + j]."""
    width = w.shape[0]
    y = u * w[width - 1]
    for j in range(width - 1):
        shift = width - 1 - j
        shifted = F.pad(u, (0, 0, shift, 0))[:, : u.shape[1]]
        y = y + shifted * w[j]
    return y


def _project(params: Params, x: torch.Tensor, cfg: ModelConfig):
    cd = _dt(cfg, "compute_dtype")
    xc = x.to(cd)
    z = xc @ params["wz"].to(cd)
    xs = xc @ params["wx"].to(cd)
    b = xc @ params["wb"].to(cd)
    c = xc @ params["wc"].to(cd)
    dt_raw = xc @ params["wdt"].to(cd)
    return z, xs, b, c, dt_raw


def _finish(params: Params, y_heads: torch.Tensor, x_heads: torch.Tensor, z: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    cd = _dt(cfg, "compute_dtype")
    y = y_heads + params["d_skip"].float()[..., :, None] * x_heads.float()
    y = y.reshape(*y.shape[:-2], cfg.d_inner).to(cd)
    gated = y * F.silu(z.to(cd))
    g32 = gated.float()
    var = torch.mean(torch.square(g32), dim=-1, keepdim=True)
    normed = g32 * torch.rsqrt(var + cfg.norm_eps) * params["norm"].float()
    return normed.to(cd) @ params["wo"].to(cd)


def mamba2_forward(
    params: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    return_cache: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full-sequence forward.  x: (B, L, D)."""
    bsz, l, _ = x.shape
    h, p = cfg.n_ssm_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state

    z, xs, b, c, dt_raw = _project(params, x, cfg)
    xs = F.silu(causal_depthwise_conv(xs, params["conv_x"].to(xs.dtype)))
    b = F.silu(causal_depthwise_conv(b, params["conv_b"].to(b.dtype)))
    c = F.silu(causal_depthwise_conv(c, params["conv_c"].to(c.dtype)))

    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    x_heads = xs.reshape(bsz, l, h, p)
    y, final_state = ssd_ops.ssd(
        x_heads,
        dt,
        a,
        b.reshape(bsz, l, g, n),
        c.reshape(bsz, l, g, n),
        chunk=cfg.ssm_chunk,
        impl=cfg.ssm_impl,
    )
    out = _finish(params, y.float(), x_heads, z, cfg)

    cache = None
    if return_cache:
        w = cfg.ssm_conv_width
        # conv state carries the raw (pre-conv) last W-1 inputs of each stream
        _, xs_raw, b_raw, c_raw, _ = _project(params, x[:, -(w - 1):], cfg)
        u_tail = torch.cat([xs_raw, b_raw, c_raw], dim=-1)
        pad = (w - 1) - u_tail.shape[1]
        if pad > 0:
            u_tail = F.pad(u_tail, (0, 0, pad, 0))
        cache = {"conv": u_tail, "ssm": final_state}
    return out, cache


def mamba2_cache(cfg: ModelConfig, batch: int, device=None) -> Dict[str, torch.Tensor]:
    h, p, n = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    cdim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, cdim),
                            dtype=_dt(cfg, "compute_dtype"), device=device),
        "ssm": torch.zeros((batch, h, p, n), dtype=torch.float32, device=device),
    }


def mamba2_cache_axes() -> Dict[str, Tuple[Optional[str], ...]]:
    return {
        "conv": ("act_batch", "conv", "inner"),
        "ssm": ("act_batch", "ssd_heads", None, None),
    }


def mamba2_decode(
    params: Params,
    x: torch.Tensor,  # (B, 1, D)
    cache: Dict[str, torch.Tensor],
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token against the cache.  Returns (out, new cache); ``cache`` is
    not written (the caller writes the new one in place)."""
    bsz = x.shape[0]
    h, p = cfg.n_ssm_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state
    di = cfg.d_inner

    z, xs, b, c, dt_raw = _project(params, x, cfg)
    u_t = torch.cat([xs, b, c], dim=-1)                          # (B, 1, C)
    window = torch.cat([cache["conv"], u_t], dim=1)              # (B, W, C)
    conv_w = torch.cat([params["conv_x"], params["conv_b"], params["conv_c"]],
                       dim=-1).to(window.dtype)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", window, conv_w))
    xs1 = conv_out[:, :di]
    b1 = conv_out[:, di: di + g * n]
    c1 = conv_out[:, di + g * n:]

    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"])   # (B,H)
    a = -torch.exp(params["a_log"])
    y, new_state = ssd_ops.ssd_decode_step(
        cache["ssm"],
        xs1.reshape(bsz, h, p),
        dt,
        a,
        b1.reshape(bsz, g, n),
        c1.reshape(bsz, g, n),
    )
    out = _finish(params, y[:, None].float(), xs1.reshape(bsz, 1, h, p), z, cfg)
    return out, {"conv": window[:, 1:], "ssm": new_state}
