"""Optimizer substrate: init/update pairs over parameter trees.

The port of ``repro.optim.optimizers``.  Only ``sgd`` (the ``FedConfig``
default) is ported so far; momentum, adamw/adam, adafactor and the
warmup-cosine schedule are still to port.  Updates compute in f32 and cast
back to each parameter's dtype, as the reference does.

Every update rule here is elementwise, so applying it to a tree whose
leaves carry a leading client axis updates each client independently —
``repro_torch.fed.batch_exec`` relies on that.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree], Tuple[PyTree, PyTree]]
    # update(grads, state, params) -> (new_params, new_state)
    #: hashable identity of the update rule (name + hyperparams), set by
    #: ``make_optimizer``; lets step caches key on *what the optimizer
    #: computes* instead of closure identity.  ``None`` means "not
    #: cacheable across instances".
    cache_key: Optional[tuple] = None


def global_norm(tree: PyTree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(l.float())) for l in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads: PyTree, max_norm: float) -> Tuple[PyTree, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def sgd(lr: float) -> Optimizer:
    def init(params):
        return {"step": torch.zeros((), dtype=torch.int32)}

    def update(grads, state, params):
        new = tree_map(lambda p, g: (p.float() - lr * g.float()).to(p.dtype),
                       params, grads)
        return new, {"step": state["step"] + 1}

    return Optimizer(init, update)


OPTIMIZERS: Dict[str, Callable[..., Optimizer]] = {"sgd": sgd}


def make_optimizer(name: str, lr: float, weight_decay: float = 0.0) -> Optimizer:
    if name not in OPTIMIZERS:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (ROADMAP: optimizers); "
            f"ported: {sorted(OPTIMIZERS)}")
    if callable(lr):
        raise NotImplementedError("learning-rate schedules are not ported yet")
    opt = OPTIMIZERS[name](float(lr))
    # the (name, lr, wd) triple fully determines the update rule, so built
    # steps can be shared across instances
    return opt._replace(cache_key=(name, float(lr), float(weight_decay)))
