"""Client-side local training under a resource budget.

The port of ``repro.fed.client``.  A client owns a data shard and a
workload spec; ``train_local`` runs E real optimizer steps from the current
global model and returns the delta.  FedProx's proximal term is supported
for Non-IID robustness.  The *time* a client takes is supplied by the
framework runtime (measured or fixed) — never computed here.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.aggregation import tree_sub
from repro_torch.core.budget import WorkloadSpec
from repro_torch.data.pipeline import ClientDataset
from repro_torch.models.small import SmallModelConfig, small_loss
from repro_torch.optim.optimizers import Optimizer, clip_by_global_norm
from repro_torch.tree import tree_leaves

PyTree = Any

#: the reference's clip of every local step's gradient (``client.py:49``)
CLIP_NORM = 10.0


def host_to(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``; float64 becomes float32, as
    JAX (64-bit mode off) converts the same array in the reference."""
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def batch_to(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A numpy batch from ``ClientDataset`` as tensors on ``device``."""
    return {k: host_to(np.asarray(v), device) for k, v in batch.items()}


def build_step_fn(
    mcfg: SmallModelConfig, opt: Optimizer, prox_mu: float = 0.0
) -> Callable:
    """The local-training step: (params, opt_state, batch, anchor) ->
    (params, opt_state, metrics), with ``batch`` a dict of tensors on the
    params' device.  Value and grad of the loss (+ FedProx term), the
    gradient clipped to global norm ``CLIP_NORM``, then the optimizer
    update.  Returns fresh tensors and leaves its inputs untouched.

    The gradient is ``torch.func.grad_and_value``'s, so the step composes
    with ``torch.func.vmap``: ``repro_torch.fed.batch_exec`` maps this same
    step over a wave's client axis, as the reference vmaps its step."""

    def loss_fn(params, batch, anchor):
        loss, metrics = small_loss(params, mcfg, batch)
        if prox_mu > 0.0:
            sq = sum(
                torch.sum(torch.square(p.float() - a.float()))
                for p, a in zip(tree_leaves(params), tree_leaves(anchor))
            )
            loss = loss + 0.5 * prox_mu * sq
        return loss, metrics

    grad_fn = torch.func.grad_and_value(loss_fn, has_aux=True)

    def step(params, opt_state, batch, anchor):
        grads, (loss, metrics) = grad_fn(params, batch, anchor)
        with torch.no_grad():
            grads, _ = clip_by_global_norm(grads, CLIP_NORM)
            params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, dict(metrics, loss=loss)

    return step


#: (mcfg, optimizer cache_key, prox_mu) -> step.  One step function serves
#: every client, every round, and every trainer with the same (model
#: config, update rule, prox term), as in the reference.
_STEP_CACHE: dict = {}
_STEP_CACHE_STATS = {"hits": 0, "misses": 0, "uncacheable": 0}


def make_small_step(
    mcfg: SmallModelConfig, opt: Optimizer, prox_mu: float = 0.0
) -> Callable:
    """(params, opt_state, batch, anchor) -> (params, opt_state, metrics).

    Cached on (model cfg, optimizer identity, prox_mu); optimizers without
    a ``cache_key`` get a private step per call."""
    opt_key = getattr(opt, "cache_key", None)
    if opt_key is None:
        _STEP_CACHE_STATS["uncacheable"] += 1
        return build_step_fn(mcfg, opt, prox_mu)
    key = (mcfg, opt_key, float(prox_mu))
    step = _STEP_CACHE.get(key)
    if step is None:
        _STEP_CACHE_STATS["misses"] += 1
        step = _STEP_CACHE[key] = build_step_fn(mcfg, opt, prox_mu)
    else:
        _STEP_CACHE_STATS["hits"] += 1
    return step


def step_cache_stats() -> Dict[str, int]:
    return dict(_STEP_CACHE_STATS)


def clear_step_cache() -> None:
    _STEP_CACHE.clear()
    _STEP_CACHE_STATS.update(hits=0, misses=0, uncacheable=0)


def params_device(params: PyTree) -> torch.device:
    return tree_leaves(params)[0].device


@dataclass
class FLClient:
    client_id: int
    budget: float
    data: ClientDataset
    workload: WorkloadSpec = field(default_factory=WorkloadSpec)

    def train_local(
        self,
        global_params: PyTree,
        step_fn: Callable,
        opt: Optimizer,
        n_steps: Optional[int] = None,
    ) -> Tuple[PyTree, int, Dict[str, float]]:
        """Returns (delta, n_samples_seen, last metrics); trains on the
        device of ``global_params``."""
        device = params_device(global_params)
        params = global_params
        opt_state = opt.init(params)
        steps = n_steps or self.workload.n_batches
        metrics: Dict[str, Any] = {}
        for batch in self.data.batches(steps):
            params, opt_state, metrics = step_fn(
                params, opt_state, batch_to(batch, device), global_params)
        delta = tree_sub(params, global_params)
        n_seen = steps * self.data.batch_size
        return delta, n_seen, {k: float(v) for k, v in metrics.items()}
