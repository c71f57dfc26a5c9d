"""Small FL client workload models — the paper's own experiment models.

The port of ``repro.models.small``: an MLP, a CNN on CIFAR-10 (Fig 8), a
compact residual CNN on FEMNIST (Fig 9/10) and an LSTM sentiment
classifier on SST-2 (Fig 6/7), each with the optional ``extra_local_model``
personalization tower.  Parameters are nested dicts and lists of tensors
shaped as the reference's pytrees: dense weights ``(in, out)``, convolutions
HWIO, the embedding ``(V, E)``, so deltas, FedAvg, upload sizes and
checkpoints work leaf by leaf on the same tree.  Images arrive NHWC, as in
the reference; NCHW exists only inside a forward.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Dict, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_map

Params = Dict[str, Any]


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


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return torch.rand(shape, generator=gen, dtype=torch.float32) * (2 * bound) - bound


def _dense(gen: torch.Generator, fan_in: int, fan_out: int) -> Params:
    # the reference's law: uniform in ±1/√fan_in, zero bias
    return {"w": _uniform(gen, (fan_in, fan_out), 1.0 / math.sqrt(fan_in)),
            "b": torch.zeros((fan_out,))}


def _conv(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int) -> Params:
    # uniform in ±1/√(kh·kw·cin), HWIO, zero bias
    return {"w": _uniform(gen, (kh, kw, cin, cout), 1.0 / math.sqrt(kh * kw * cin)),
            "b": torch.zeros((cout,))}


def _init_single(gen: torch.Generator, cfg: SmallModelConfig) -> Params:
    if cfg.kind == "mlp":
        dims = [cfg.image_size * cfg.image_size * cfg.channels] + [cfg.hidden] * cfg.n_layers
        layers = [_dense(gen, dims[i], dims[i + 1]) for i in range(cfg.n_layers)]
        return {"layers": layers, "head": _dense(gen, dims[-1], cfg.n_classes)}
    if cfg.kind == "cnn":
        c = [cfg.channels, 32, 64] + [64] * max(0, cfg.n_layers - 2)
        convs = [_conv(gen, 3, 3, c[i], c[i + 1]) for i in range(max(2, cfg.n_layers))]
        # 2x2 VALID pooling floors each halving; so does this
        feat = (cfg.image_size // (2 ** len(convs))) or 1
        return {"convs": convs,
                "fc": _dense(gen, feat * feat * c[len(convs)], cfg.hidden),
                "head": _dense(gen, cfg.hidden, cfg.n_classes)}
    if cfg.kind == "resnet":
        stem = _conv(gen, 3, 3, cfg.channels, cfg.hidden)
        blocks = [{"c1": _conv(gen, 3, 3, cfg.hidden, cfg.hidden),
                   "c2": _conv(gen, 3, 3, cfg.hidden, cfg.hidden)}
                  for _ in range(cfg.n_layers)]
        return {"stem": stem, "blocks": blocks, "head": _dense(gen, cfg.hidden, cfg.n_classes)}
    if cfg.kind == "lstm":
        emb = torch.randn((cfg.vocab_size, cfg.embed_dim), generator=gen) * 0.1
        cells, dim_in = [], cfg.embed_dim
        for _ in range(cfg.n_layers):
            cells.append({"wx": _dense(gen, dim_in, 4 * cfg.hidden),
                          "wh": _dense(gen, cfg.hidden, 4 * cfg.hidden)})
            dim_in = cfg.hidden
        return {"embed": emb, "cells": cells, "head": _dense(gen, cfg.hidden, cfg.n_classes)}
    raise ValueError(cfg.kind)


def init_small(seed: Union[int, torch.Generator], cfg: SmallModelConfig,
               device: DeviceLike = None) -> Params:
    """Fresh parameters drawn from a CPU ``torch.Generator`` (so a seed gives
    the same numbers on every device), then moved to ``device``.  The local
    tower is a second draw from the same generator.  The draws differ from
    ``jax.random``'s; a parity test bridges the reference's parameters."""
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(int(seed))
    params = {"main": _init_single(gen, cfg)}
    if cfg.extra_local_model:
        params["local"] = _init_single(gen, cfg)
    return tree_map(lambda t: t.to(dev), params)


def _conv_nchw(p: Params, h: torch.Tensor) -> torch.Tensor:
    """The reference's "SAME" 3x3 convolution, stride 1, of an NCHW map
    with HWIO weights."""
    return F.conv2d(h, p["w"].permute(3, 2, 0, 1), p["b"], padding=1)


def _embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, tokens, axis=0)`` as the reference runs it: a
    negative token wraps once (-1 is the last row) and a token outside
    ``[-V, V)`` reads a row of NaN.  Plain indexing with such a token is a
    device-side assert on CUDA, so the gather is clamped and masked."""
    v = table.shape[0]
    idx = torch.where(tokens < 0, tokens + v, tokens).long()
    valid = (idx >= 0) & (idx < v)
    rows = F.embedding(idx.clamp(0, v - 1), table)
    return torch.where(valid[..., None], rows, torch.full_like(rows, math.nan))


def _lstm_layer(cell: Params, h_seq: torch.Tensor, hidden: int) -> torch.Tensor:
    """One LSTM layer over ``(B, S, E)``; gates ``i, f, g, o`` along the last
    axis, forget gate ``sigmoid(f + 1)``.  Returns every hidden state."""
    xz = h_seq @ cell["wx"]["w"] + cell["wx"]["b"]        # (B, S, 4H), all steps at once
    h = h_seq.new_zeros((h_seq.shape[0], hidden))
    c = torch.zeros_like(h)
    hs = []
    for t in range(h_seq.shape[1]):
        z = xz[:, t] + (h @ cell["wh"]["w"] + cell["wh"]["b"])
        i, f, g, o = torch.split(z, hidden, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def _apply_single(p: Params, cfg: SmallModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.kind == "mlp":
        h = x.reshape(x.shape[0], -1)
        for lyr in p["layers"]:
            h = torch.relu(h @ lyr["w"] + lyr["b"])
        return h @ p["head"]["w"] + p["head"]["b"]
    if cfg.kind == "cnn":
        h = x.permute(0, 3, 1, 2)
        for conv in p["convs"]:
            h = F.max_pool2d(torch.relu(_conv_nchw(conv, h)), 2, 2)
        # the reference flattens NHWC: back to it before fc reads the features
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        h = torch.relu(h @ p["fc"]["w"] + p["fc"]["b"])
        return h @ p["head"]["w"] + p["head"]["b"]
    if cfg.kind == "resnet":
        h = torch.relu(_conv_nchw(p["stem"], x.permute(0, 3, 1, 2)))
        for blk in p["blocks"]:
            y = _conv_nchw(blk["c2"], torch.relu(_conv_nchw(blk["c1"], h)))
            h = torch.relu(h + y)
        return torch.mean(h, dim=(2, 3)) @ p["head"]["w"] + p["head"]["b"]
    if cfg.kind == "lstm":
        h_seq = _embed(p["embed"], x)
        for cell in p["cells"]:
            h_seq = _lstm_layer(cell, h_seq, cfg.hidden)
        return torch.mean(h_seq, dim=1) @ p["head"]["w"] + p["head"]["b"]
    raise ValueError(cfg.kind)


def small_apply(params: Params, cfg: SmallModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Logits; ``x`` is ``(B, H, W, C)`` images (NHWC) or ``(B, S)`` tokens."""
    logits = _apply_single(params["main"], cfg, x)
    if "local" in params:
        # Ditto-style personalization: the extra local model trains alongside
        logits = logits + 0.0 * torch.sum(_apply_single(params["local"], cfg, x))
    return logits


def cross_entropy_rows(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-row ``logsumexp(logits) - logits[y]`` (the reference's CE)."""
    return torch.logsumexp(logits, -1) - logits.gather(-1, y[:, None].long())[:, 0]


def small_loss(params: Params, cfg: SmallModelConfig, batch) -> Tuple[torch.Tensor, Dict]:
    """Mean CE of the main model, plus the local tower's own CE when it is
    there; the metrics are the main model's."""
    x, y = batch["x"], batch["y"]
    logits = _apply_single(params["main"], cfg, x)
    ce = torch.mean(cross_entropy_rows(logits, y))
    acc = torch.mean((torch.argmax(logits, -1) == y).float())
    loss = ce
    if "local" in params:
        loss = loss + torch.mean(cross_entropy_rows(_apply_single(params["local"], cfg, x), y))
    return loss, {"ce": ce, "acc": acc}
