"""Aggregation strategies: weighted FedAvg, delta aggregation, FedBuff-style
asynchronous buffered aggregation with staleness discounting.

The port of ``repro.core.aggregation``.  Tree arithmetic is
dtype-preserving: sums are taken in f32 and cast back to each leaf's dtype,
as the reference does.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Sequence, Tuple

from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


def tree_add(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(lambda x, y: x + y, a, b)


def tree_sub(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(lambda x, y: x - y, a, b)


def tree_scale(a: PyTree, s) -> PyTree:
    return tree_map(lambda x: (x.float() * s).to(x.dtype), a)


def fedavg(updates: Sequence[Tuple[PyTree, float]]) -> PyTree:
    """Weighted average of parameter trees (weights ∝ client sample counts)."""
    total = float(sum(w for _, w in updates))
    if total <= 0:
        raise ValueError(f"FedAvg needs a positive total weight, got {total}")
    acc = tree_scale(updates[0][0], updates[0][1] / total)
    for params, w in updates[1:]:
        acc = tree_add(acc, tree_scale(params, w / total))
    return acc


def apply_deltas(global_params: PyTree, deltas: Sequence[Tuple[PyTree, float]],
                 server_lr: float = 1.0) -> PyTree:
    """FedAvg in delta form: θ ← θ + η·Σ wᵢ·Δᵢ / Σ wᵢ."""
    avg_delta = fedavg(deltas)
    return tree_map(
        lambda p, d: (p.float() + server_lr * d.float()).to(p.dtype),
        global_params,
        avg_delta,
    )


@dataclass
class AsyncAggregator:
    """FedBuff-style buffered async aggregation.

    Clients report (delta, weight, round_started); the buffer flushes every
    ``buffer_size`` arrivals with staleness discount w/(1+s)^alpha — the
    straggler-mitigation path: slow clients never block the round clock.
    """

    buffer_size: int = 8
    staleness_alpha: float = 0.5
    server_lr: float = 1.0
    _buffer: List[Tuple[PyTree, float, int]] = field(default_factory=list)
    server_round: int = 0

    def add(self, delta: PyTree, weight: float, round_started: int) -> bool:
        self._buffer.append((delta, weight, round_started))
        return len(self._buffer) >= self.buffer_size

    def flush(self, global_params: PyTree) -> PyTree:
        if not self._buffer:
            raise RuntimeError("flush of an empty async buffer")
        weighted = []
        for delta, w, r0 in self._buffer:
            stale = max(self.server_round - r0, 0)
            weighted.append((delta, w / (1.0 + stale) ** self.staleness_alpha))
        self._buffer.clear()
        self.server_round += 1
        return apply_deltas(global_params, weighted, self.server_lr)


def tree_nbytes(tree: PyTree) -> int:
    """Bytes of a tree's tensors — the uncompressed upload size of a delta."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

