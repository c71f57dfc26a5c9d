"""Dropless token-choice top-k Mixture-of-Experts (OLMoE / Kimi-K2 style).
The port of ``repro.models.moe``.

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
``logical_sharding`` context, as the reference does.  On a mesh of more
than one device the layer runs one of the reference's three bodies under
``repro_torch.dist.shard_map`` (tokens split over the batch axes; forward
only, so an input that requires grad raises):

* ``_moe_shard_body`` ("gather"): experts ZeRO-3 over the batch axes,
  all-gathered before use; d_ff tensor-parallel over "model", the partial
  outputs summed over it;
* ``_moe_shard_body_ep``: each "model" shard owns E/n_model experts, keeps
  the rows routed to them up to a static capacity (the rest land in a zero
  "trash" expert) and the partial outputs are summed over "model";
* ``_moe_shard_body_ep_resident`` (decode): the EP weights stay where they
  are and the few tokens are all-gathered instead.

A mesh of one device, or none, runs ``_moe_local``.  Group sizes are
counted with a scatter-add on the tensor's device, so the kernel route
never waits for the card.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import shard_map as SM
from repro_torch.dist.mesh_utils import axis_sizes, mesh_size
from repro_torch.dist.sharding import P
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


def _bincount(idx: torch.Tensor, length: int) -> torch.Tensor:
    """``jnp.bincount(idx, length=length)`` as int32, on ``idx``'s device."""
    return torch.zeros(length, dtype=torch.int32, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx, dtype=torch.int32))


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
    group_sizes = _bincount(flat_e, e)

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


def _with_trash(w: torch.Tensor) -> torch.Tensor:
    """``w`` with one zero expert appended: the group of dropped rows."""
    return torch.cat([w, w.new_zeros((1, *w.shape[1:]))], dim=0)


def _moe_shard_body(router_w, wg, wu, wd, x, *, cfg: ModelConfig, fsdp_axes, gmm_impl):
    """ZeRO-3 "gather" impl: experts sharded over the batch axes at rest,
    all-gathered before use; d_ff is tensor-parallel over the model axis."""
    if fsdp_axes:
        wg = SM.all_gather(wg, fsdp_axes, dim=0)
        wu = SM.all_gather(wu, fsdp_axes, dim=0)
        wd = SM.all_gather(wd, fsdp_axes, dim=0)
    out, aux = _moe_local(router_w, wg, wu, wd, x, cfg, gmm_impl)
    out = SM.psum(out, "model")
    axes = tuple(fsdp_axes) + ("model",) if fsdp_axes else ("model",)
    aux = SM.pmean(aux, axes)
    return out, aux


def _ep_dispatch(router_w, xf, cfg: ModelConfig, e_loc: int, m_idx: int, cap: int):
    """The rows of ``xf`` routed to this model shard's experts, sorted by
    local expert (stable, the sentinel ``e_loc`` last) and cut at ``cap``:
    (take, local expert of each kept row, group sizes with the trash group
    last, top_p, top_i, probs)."""
    top_p, top_i, probs = route(router_w, xf, cfg)
    flat_e = top_i.reshape(-1)
    local = (flat_e // e_loc) == m_idx
    sort_key = torch.where(local, flat_e - m_idx * e_loc, torch.full_like(flat_e, e_loc))
    order = torch.argsort(sort_key, stable=True)
    take = order[:cap]
    rel_e = sort_key[take]                                      # in [0, e_loc]
    # the trash group counts the kept rows of other shards' experts: the
    # reference's cap - Σ local, since ``take`` holds exactly cap rows
    group_sizes = _bincount(rel_e, e_loc + 1)
    return take, rel_e, group_sizes, top_p, top_i, probs


def _ep_products(xs, wg_p, wu_p, wd_p, group_sizes, cd, gmm_impl):
    mm = _grouped_matmul(gmm_impl)
    g = mm(xs, wg_p.to(cd), group_sizes)
    u = mm(xs, wu_p.to(cd), group_sizes)
    return mm(F.silu(g) * u, wd_p.to(cd), group_sizes)


def _ep_combine(ys, top_p, take, rel_e, tok_idx, e_loc, n_tokens, cd):
    """Gate the kept rows in the compute dtype (a trash row's gate is 0)
    and scatter-add them into f32 token rows, as the reference rounds."""
    gates = top_p.reshape(-1)[take].to(cd) * (rel_e < e_loc).to(cd)
    contrib = ys.to(cd) * gates[:, None]
    return torch.zeros((n_tokens, ys.shape[1]), dtype=torch.float32,
                       device=ys.device).index_add_(0, tok_idx, contrib.float())


def _moe_shard_body_ep(
    router_w, wg, wu, wd, x, *, cfg: ModelConfig, fsdp_axes, gmm_impl, n_model: int
):
    """Expert-parallel impl: each model shard OWNS E/n_model experts, takes
    the rows routed to them up to a static per-shard capacity (overflow is
    dropped, standard EP behaviour) and the partial outputs are summed over
    the model axis.  Routing is computed redundantly per shard (tokens are
    replicated over the model axis), so no token all-to-all is needed."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    e_loc = wg.shape[0]
    cd = _dt(cfg, "compute_dtype")
    if fsdp_axes:  # ZeRO-3 on the per-expert FFN dim
        wg = SM.all_gather(wg, fsdp_axes, dim=2)
        wu = SM.all_gather(wu, fsdp_axes, dim=2)
        wd = SM.all_gather(wd, fsdp_axes, dim=1)
    wg_p, wu_p, wd_p = _with_trash(wg), _with_trash(wu), _with_trash(wd)

    m_idx = SM.axis_index("model")
    t = b * s
    xf = x.reshape(t, d)
    nc = max(1, min(cfg.moe_token_chunks, t))
    if t % nc:
        raise ValueError(f"{t} tokens do not split into moe_token_chunks={nc} chunks")
    tc = t // nc
    cap = int(cfg.moe_ep_capacity * tc * k / max(n_model, 1))
    cap = max(min(cap, tc * k), 1)

    outs, auxs = [], []
    for xc in xf.reshape(nc, tc, d):       # lax.map over the token chunks
        take, rel_e, group_sizes, top_p, top_i, probs = _ep_dispatch(
            router_w, xc, cfg, e_loc, m_idx, cap)
        tok_idx = take // k
        ys = _ep_products(xc[tok_idx].to(cd), wg_p, wu_p, wd_p, group_sizes, cd, gmm_impl)
        outs.append(_ep_combine(ys, top_p, take, rel_e, tok_idx, e_loc, tc, cd))
        frac = _bincount(top_i.reshape(-1), e).float() / max(tc * k, 1)
        auxs.append(e * torch.sum(frac * probs.mean(0)))
    out = outs[0] if nc == 1 else torch.cat(outs)
    aux = auxs[0] if nc == 1 else torch.stack(auxs).mean()

    out = SM.psum(out, "model").to(x.dtype).reshape(b, s, d)
    if fsdp_axes:
        aux = SM.pmean(aux, tuple(fsdp_axes))
    return out, aux


def _moe_shard_body_ep_resident(
    router_w, wg, wu, wd, x, *, cfg: ModelConfig, fsdp_axes, gmm_impl, n_model: int
):
    """Decode-time EP with RESIDENT weights: the experts are never
    all-gathered.  They stay 2-D sharded (experts over "model", per-expert
    d_ff over the batch axes); the few decode tokens are all-gathered
    instead, every shard computes its (expert, f-slice) partial for all of
    them, and one psum over the model and batch axes assembles the output."""
    b, s, d = x.shape
    k = cfg.top_k
    e_loc = wg.shape[0]
    cd = _dt(cfg, "compute_dtype")
    wg_p, wu_p, wd_p = _with_trash(wg), _with_trash(wu), _with_trash(wd)

    xg = SM.all_gather(x, fsdp_axes, dim=0) if fsdp_axes else x   # (B_full, s, d)
    t = xg.shape[0] * s
    xf = xg.reshape(t, d)

    m_idx = SM.axis_index("model")
    cap = max(min(int(cfg.moe_ep_capacity * t * k / max(n_model, 1)), t * k), 1)
    take, rel_e, group_sizes, top_p, _, _ = _ep_dispatch(router_w, xf, cfg, e_loc, m_idx, cap)
    tok_idx = take // k
    ys = _ep_products(xf[tok_idx].to(cd), wg_p, wu_p, wd_p, group_sizes, cd, gmm_impl)
    out_full = _ep_combine(ys, top_p, take, rel_e, tok_idx, e_loc, t, cd)
    out_full = SM.psum(out_full, ("model",) + tuple(fsdp_axes))
    if fsdp_axes:   # this shard's rows: the flattened batch index, first axis major
        idx, stride = 0, 1
        for a in reversed(fsdp_axes):
            idx += SM.axis_index(a) * stride
            stride *= SM.axis_size(a)
        out = out_full.reshape(-1, s, d)[idx * b:(idx + 1) * b]
    else:
        out = out_full.reshape(b, s, d)
    return out.to(x.dtype), torch.zeros((), dtype=torch.float32, device=x.device)


def moe_ffn(
    params: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    mesh: Optional[Any] = None,
    gmm_impl: str = "ragged",
    resident: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mixture-of-experts FFN.  (B,S,D) -> ((B,S,D), aux-loss scalar).

    ``mesh`` is a ``torch.distributed`` ``DeviceMesh``: one device, or
    none, runs the local path; a larger one the reference's body for
    ``cfg`` (``resident`` picks the decode body under EP), on DTensor
    params and tokens, returning DTensors."""
    if mesh is None or mesh_size(mesh) == 1:
        return _moe_local(params["router"], params["wg"], params["wu"], params["wd"], x,
                          cfg, gmm_impl)
    names = tuple(axis_sizes(mesh))
    b_axes = tuple(a for a in ("pod", "data") if a in names)
    fsdp_axes = b_axes if cfg.fsdp_params else ()
    n_model = axis_sizes(mesh).get("model", 1)
    if cfg.moe_impl == "ep" and n_model > 1 and cfg.n_experts % n_model == 0:
        w_spec = P("model", None, fsdp_axes or None)
        wd_spec = P("model", fsdp_axes or None, None)
        ep_body = _moe_shard_body_ep_resident if resident else _moe_shard_body_ep
        body = partial(ep_body, cfg=cfg, fsdp_axes=fsdp_axes, gmm_impl=gmm_impl,
                       n_model=n_model)
    else:
        w_spec = P(fsdp_axes or None, None, "model")
        wd_spec = P(fsdp_axes or None, "model", None)
        body = partial(_moe_shard_body, cfg=cfg, fsdp_axes=fsdp_axes, gmm_impl=gmm_impl)
    fn = SM.shard_map(
        body, mesh,
        in_specs=(P(None, None), w_spec, w_spec, wd_spec, P(b_axes or None, None, None)),
        out_specs=(P(b_axes or None, None, None), P()),
    )
    return fn(params["router"], params["wg"], params["wu"], params["wd"], x)
