"""Dropless token-choice top-k Mixture-of-Experts (OLMoE / Kimi-K2 style).
The port of ``repro.models.moe`` for one device.

Dispatch is MegaBlocks-style: flatten tokens, replicate ×k, stable-sort by
expert id, run three grouped matmuls, unsort, and combine with renormalized
router weights.  No capacity factor, no token dropping.

``gmm_impl`` picks the grouped matmul, as in the reference:

* ``"ragged"`` and ``"pallas"`` both go to the port's ``grouped_matmul``:
  ``lax.ragged_dot`` is XLA's grouped matmul and ``"pallas"`` the TPU
  kernel, and the port's counterpart of either is its own kernel.  On a
  CUDA tensor that is the hand-written ``gmm`` kernel; on a CPU tensor its
  plain per-group loop;
* ``"dense"`` always takes the plain ``grouped_matmul_ref`` (the
  reference's one-hot oracle; on the card, the plain route the kernel is
  held against).

``block_apply`` hands ``moe_ffn`` the mesh of the active
``logical_sharding`` context, as the reference does.  The sharded bodies
(``_moe_shard_body``, ``_moe_shard_body_ep``, ``_moe_shard_body_ep_resident``)
are not ported yet (ROADMAP queue 1 row 9b): ``moe_ffn`` with a mesh of
more than one device raises.  Group sizes are counted with a scatter-add
on the tensor's device, so the kernel route never waits for the card.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.grouped_matmul import ops as gmm_ops
from repro_torch.kernels.grouped_matmul import ref as gmm_ref
from repro_torch.models.layers import _dt, _normal

Params = Dict[str, Any]


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> Tuple[Params, Params]:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    pd = _dt(cfg, "param_dtype")
    std = 0.02
    out_std = 0.02 / math.sqrt(2.0 * max(cfg.total_layers, 1))
    params = {
        "router": _normal(gen, (d, e), std, torch.float32),
        "wg": _normal(gen, (e, d, f), std, pd),
        "wu": _normal(gen, (e, d, f), std, pd),
        "wd": _normal(gen, (e, f, d), out_std, pd),
    }
    axes = {
        "router": ("embed", None),
        "wg": ("expert", "expert_embed", "expert_mlp"),
        "wu": ("expert", "expert_embed", "expert_mlp"),
        "wd": ("expert", "expert_mlp", "expert_embed"),
    }
    return params, axes


def route(router_w: torch.Tensor, x_flat: torch.Tensor, cfg: ModelConfig):
    """Return (top_probs (T,k), top_idx (T,k), probs (T,E)).  ``topk`` sorts
    descending, as ``lax.top_k``; the two may order exact ties differently."""
    probs = torch.softmax(x_flat.float() @ router_w, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    return top_p / top_p.sum(-1, keepdim=True), top_i, probs


def _grouped_matmul(impl: str):
    if impl in ("ragged", "pallas"):
        return gmm_ops.grouped_matmul
    if impl == "dense":
        return gmm_ref.grouped_matmul_ref
    raise ValueError(f"unknown grouped_matmul impl: {impl}")


def _moe_local(
    router_w: torch.Tensor,
    wg: torch.Tensor,
    wu: torch.Tensor,
    wd: torch.Tensor,
    x: torch.Tensor,
    cfg: ModelConfig,
    gmm_impl: str = "ragged",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) local tokens.  Returns (out (B,S,D), aux loss scalar)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cd = _dt(cfg, "compute_dtype")
    t = b * s
    mm = _grouped_matmul(gmm_impl)
    xf = x.reshape(t, d)

    top_p, top_i, probs = route(router_w, xf, cfg)

    flat_e = top_i.reshape(-1)                                   # (t*k,)
    sort_idx = torch.argsort(flat_e, stable=True)
    tok_idx = sort_idx // k                                      # source token per row
    xs = xf.index_select(0, tok_idx).to(cd)                      # (t*k, d)
    group_sizes = torch.zeros(e, dtype=torch.int32, device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e, dtype=torch.int32))

    g = mm(xs, wg.to(cd), group_sizes)
    u = mm(xs, wu.to(cd), group_sizes)
    h = F.silu(g) * u
    ys = mm(h, wd.to(cd), group_sizes)

    gates = top_p.reshape(-1)[sort_idx].float()
    contrib = ys.float() * gates[:, None]
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device).index_add_(0, tok_idx, contrib)

    # Switch-style load-balancing auxiliary loss.
    frac = group_sizes.float() / max(t * k, 1)
    aux = e * torch.sum(frac * probs.mean(0))
    return out.reshape(b, s, d).to(x.dtype), aux


def moe_ffn(
    params: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    mesh: Optional[Any] = None,
    gmm_impl: str = "ragged",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mixture-of-experts FFN.  (B,S,D) -> ((B,S,D), aux-loss scalar).

    ``mesh`` is a device mesh with ``size()`` (``torch.distributed``'s
    ``DeviceMesh``); one device, or none, runs the local path."""
    if mesh is not None and mesh.size() > 1:
        raise NotImplementedError(
            "the sharded MoE bodies are not ported yet (ROADMAP queue 1 row 9b)")
    return _moe_local(params["router"], params["wg"], params["wu"], params["wd"], x, cfg,
                      gmm_impl)
