"""Optimizer substrate: init/update pairs over parameter trees.

The port of ``repro.optim.optimizers``: sgd, momentum, adam, adamw and
adafactor (factored second moment), with a learning rate that is a number
or a schedule of the step (``warmup_cosine``).  Updates compute in f32 and
cast back to each parameter's dtype, as the reference does.  The step
counter is an int32 tensor, and a schedule takes it as a tensor.

``adafactor``'s update-RMS clip reduces over a whole leaf, so a rule is not
elementwise in general: a tree whose leaves carry a leading client axis is
updated client by client through ``torch.func.vmap(opt.update)``
(``repro_torch.fed.batch_exec``).  Every rule here is vmap-safe for that:
no ``.item()``, no Python branch on a tensor's value, no in-place write.
``opt_state_axes`` gives the state's logical axes, for the sharding rules.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.dist.sharding import _is_axes_leaf, is_dtensor
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree], Tuple[PyTree, PyTree]]
    # update(grads, state, params) -> (new_params, new_state)
    #: hashable identity of the update rule (name + hyperparams), set by
    #: ``make_optimizer``; lets step caches key on *what the optimizer
    #: computes* instead of closure identity.  ``None`` (e.g. a callable LR
    #: schedule) means "not cacheable across instances".
    cache_key: Optional[tuple] = None


def _as_schedule(lr) -> Schedule:
    if callable(lr):
        return lr
    # the reference's jnp.asarray(lr, f32), on the step's device
    return lambda step: torch.full_like(step, float(lr), dtype=torch.float32)


def global_norm(tree: PyTree) -> torch.Tensor:
    """The L2 norm of every leaf together.  On DTensor leaves it is one
    reduction across the shards: each rank sums the squares of its local
    shards, a leaf replicated over mesh dims counted once (its sum divided
    by their size), and one all-reduce of that scalar gives every rank the
    same norm, a replicated DTensor."""
    leaves = tree_leaves(tree)
    mesh = next((l.device_mesh for l in leaves if is_dtensor(l)), None)
    sq = []
    for leaf in leaves:
        copies = 1
        if mesh is not None:
            if not is_dtensor(leaf) or leaf.device_mesh != mesh:
                raise TypeError("global_norm of DTensors takes one mesh and no plain leaf")
            for i, p in enumerate(leaf.placements):
                if p.is_replicate():
                    copies *= mesh.size(i)
            leaf = leaf.to_local()
        total = torch.sum(torch.square(leaf.float()))
        sq.append(total / copies if copies > 1 else total)
    total = torch.sum(torch.stack(sq))
    if mesh is None:
        return torch.sqrt(total)
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.dist.shard_map import mesh_sum

    return DTensor.from_local(torch.sqrt(mesh_sum(mesh, total)), mesh,
                              [Replicate()] * mesh.ndim, run_check=False)


def clip_by_global_norm(grads: PyTree, max_norm: float) -> Tuple[PyTree, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def _step0(params: PyTree) -> torch.Tensor:
    """The int32 step counter, on the parameters' device: a replicated
    DTensor where the parameters are DTensors."""
    leaves = [l for l in tree_leaves(params) if isinstance(l, torch.Tensor)]
    dev = leaves[0].device if leaves else None
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if leaves and is_dtensor(leaves[0]):
        from torch.distributed.tensor import DTensor, Replicate

        mesh = leaves[0].device_mesh
        step = DTensor.from_local(step, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return step


def _zeros32(params: PyTree) -> PyTree:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def sgd(lr) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return {"step": _step0(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = sched(step)
        new = tree_map(lambda p, g: (p.float() - lr_t * g.float()).to(p.dtype),
                       params, grads)
        return new, {"step": step}

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return {"step": _step0(params), "m": _zeros32(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = sched(step)
        m = tree_map(lambda m, g: beta * m + g.float(), state["m"], grads)
        new = tree_map(lambda p, mm: (p.float() - lr_t * mm).to(p.dtype), params, m)
        return new, {"step": step, "m": m}

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return {"step": _step0(params), "m": _zeros32(params), "v": _zeros32(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = sched(step)
        s32 = step.float()
        bc1 = 1.0 - torch.pow(b1, s32)
        bc2 = 1.0 - torch.pow(b2, s32)
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state["m"], grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                     state["v"], grads)

        def upd(p, mm, vv):
            step_ = (mm / bc1) / (torch.sqrt(vv / bc2) + eps)
            if weight_decay:
                step_ = step_ + weight_decay * p.float()
            return (p.float() - lr_t * step_).to(p.dtype)

        return tree_map(upd, params, m, v), {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def adam(lr, **kw) -> Optimizer:
    return adamw(lr, weight_decay=0.0, **kw)


def adafactor(lr, eps: float = 1e-30, clip_threshold: float = 1.0,
              decay: float = 0.8, min_dim_factored: int = 128) -> Optimizer:
    """Factored second-moment optimizer [Shazeer & Stern 2018].

    Matrices with both trailing dims >= min_dim_factored keep only row/col
    second-moment vectors; everything else keeps a full second moment.  No
    momentum.  The update-RMS clip reduces over the whole leaf."""
    sched = _as_schedule(lr)

    def factored(p) -> bool:
        return (p.dim() >= 2 and p.shape[-1] >= min_dim_factored
                and p.shape[-2] >= min_dim_factored)

    def init(params):
        def leaf(p):
            if factored(p):
                return {"vr": p.new_zeros(p.shape[:-1], dtype=torch.float32),
                        "vc": p.new_zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}

        return {"step": _step0(params), "v": tree_map(leaf, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = sched(step)
        beta = 1.0 - torch.pow(step.float(), -decay)

        def upd(p, g, v):
            g32 = g.float()
            g2 = torch.square(g32) + eps
            if factored(p):
                vr = beta * v["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * v["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                row_mean = torch.clamp(torch.mean(vr, dim=-1, keepdim=True)[..., None], min=eps)
                denom = torch.sqrt(vr[..., None] * vc[..., None, :] / row_mean)
                u = g32 / torch.clamp(denom, min=eps)
                nv = {"vr": vr, "vc": vc}
            else:
                vv = beta * v["v"] + (1 - beta) * g2
                u = g32 / torch.sqrt(vv + eps)
                nv = {"v": vv}
            rms_u = torch.sqrt(torch.mean(torch.square(u)) + eps)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            return (p.float() - lr_t * u).to(p.dtype), nv

        # the state's leaves are dicts: zip them with the params by path
        out = tree_map(upd, params, grads, state["v"])
        new_p = tree_map(lambda _, o: o[0], params, out)
        new_v = tree_map(lambda _, o: o[1], params, out)
        return new_p, {"step": step, "v": new_v}

    return Optimizer(init, update)


def opt_state_axes(name: str, params_axes: PyTree, params_shapes: PyTree) -> PyTree:
    """Logical-axes tree for an optimizer's state (mirrors param sharding
    so FSDP layouts carry over to m/v/factored moments).  ``params_shapes``
    holds each parameter (a ``meta`` tensor will do) or its shape."""
    if name == "sgd":
        return {"step": None}
    if name == "momentum":
        return {"step": None, "m": params_axes}
    if name in ("adam", "adamw"):
        return {"step": None, "m": params_axes, "v": params_axes}
    if name == "adafactor":
        def leaf(ax, shp):
            shape = shp.shape if hasattr(shp, "shape") else shp
            if len(shape) >= 2 and shape[-1] >= 128 and shape[-2] >= 128:
                ax = tuple(ax) if ax else (None,) * len(shape)
                return {"vr": ax[:-1], "vc": ax[:-2] + ax[-1:]}
            return {"v": ax}

        return {"step": None,
                "v": tree_map(leaf, params_axes, params_shapes, is_leaf=_is_axes_leaf)}
    raise ValueError(name)


OPTIMIZERS: Dict[str, Callable[..., Optimizer]] = {
    "sgd": sgd,
    "momentum": momentum,
    "adam": adam,
    "adamw": adamw,
    "adafactor": adafactor,
}


def make_optimizer(name: str, lr, weight_decay: float = 0.0) -> Optimizer:
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name}")
    opt = adamw(lr, weight_decay=weight_decay) if name == "adamw" else OPTIMIZERS[name](lr)
    # plain-number LR: the (name, lr, wd) triple fully determines the
    # update rule, so built steps can be shared across instances
    if not callable(lr):
        opt = opt._replace(cache_key=(name, float(lr), float(weight_decay)))
    return opt


# --------------------------------------------------------------------------
# Schedules
# --------------------------------------------------------------------------


def warmup_cosine(peak_lr: float, warmup: int, total: int, floor: float = 0.1) -> Schedule:
    def sched(step):
        s = step.float()
        warm = peak_lr * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * peak_lr + (1 - floor) * peak_lr * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)

    return sched
