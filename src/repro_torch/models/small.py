"""Small FL client workload models — the paper's own experiment models.

The port of ``repro.models.small``.  Parameters are nested dicts and lists
of tensors shaped as the reference's pytrees (dense weights ``(in, out)``),
so deltas, FedAvg and upload sizes work leaf by leaf on the same tree.

Only the ``mlp`` kind is ported so far; ``cnn``, ``resnet``, ``lstm`` and
the ``extra_local_model`` personalization tower are still to port.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Dict, Tuple, Union

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_map

Params = Dict[str, Any]

_NOT_PORTED = "is not ported yet (ROADMAP: models/small.py, the other kinds)"


@dataclass(frozen=True)
class SmallModelConfig:
    kind: str = "mlp"          # mlp | cnn | resnet | lstm
    n_classes: int = 10
    hidden: int = 128
    n_layers: int = 2
    # image kinds
    image_size: int = 28
    channels: int = 1
    # lstm kind
    vocab_size: int = 2048
    seq_len: int = 64
    embed_dim: int = 64
    # personalization (Fig 8): an extra local model doubles the workload
    extra_local_model: bool = False

    def replace(self, **kw) -> "SmallModelConfig":
        return replace(self, **kw)


def _check_ported(cfg: SmallModelConfig) -> None:
    if cfg.kind != "mlp":
        raise NotImplementedError(f"small model kind {cfg.kind!r} {_NOT_PORTED}")
    if cfg.extra_local_model:
        raise NotImplementedError(f"extra_local_model {_NOT_PORTED}")


def _dense(gen: torch.Generator, fan_in: int, fan_out: int) -> Params:
    # the reference's law: uniform in ±1/√fan_in, zero bias
    std = 1.0 / math.sqrt(fan_in)
    u = torch.rand((fan_in, fan_out), generator=gen, dtype=torch.float32)
    return {"w": u * (2 * std) - std, "b": torch.zeros((fan_out,))}


def init_small(seed: Union[int, torch.Generator], cfg: SmallModelConfig,
               device: DeviceLike = None) -> Params:
    """Fresh parameters drawn from a CPU ``torch.Generator`` (so a seed gives
    the same numbers on every device), then moved to ``device``.  The draws
    differ from ``jax.random``'s; a parity test bridges the reference's
    parameters instead."""
    dev = resolve_device(device)
    _check_ported(cfg)
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(int(seed))
    dims = [cfg.image_size * cfg.image_size * cfg.channels] + [cfg.hidden] * cfg.n_layers
    main = {
        "layers": [_dense(gen, dims[i], dims[i + 1]) for i in range(cfg.n_layers)],
        "head": _dense(gen, dims[-1], cfg.n_classes),
    }
    return tree_map(lambda t: t.to(dev), {"main": main})


def small_apply(params: Params, cfg: SmallModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Logits of the MLP; ``x`` is ``(B, H, W, C)`` (NHWC, as the reference)."""
    _check_ported(cfg)
    p = params["main"]
    h = x.reshape(x.shape[0], -1)
    for lyr in p["layers"]:
        h = torch.relu(h @ lyr["w"] + lyr["b"])
    return h @ p["head"]["w"] + p["head"]["b"]


def cross_entropy_rows(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-row ``logsumexp(logits) - logits[y]`` (the reference's CE)."""
    return torch.logsumexp(logits, -1) - logits.gather(-1, y[:, None].long())[:, 0]


def small_loss(params: Params, cfg: SmallModelConfig, batch) -> Tuple[torch.Tensor, Dict]:
    x, y = batch["x"], batch["y"]
    logits = small_apply(params, cfg, x)
    ce = torch.mean(cross_entropy_rows(logits, y))
    acc = torch.mean((torch.argmax(logits, -1) == y).float())
    return ce, {"ce": ce, "acc": acc}
