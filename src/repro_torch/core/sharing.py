"""Hard/soft-margin resource partitioning (paper §4.3, Fig 5/14).

Hard margin (θ ≤ 100): every client computes strictly inside its budget —
rate_i = budget_i, no interaction.

Soft margin (θ > 100): the scheduler may admit more total *budget* than
physical capacity; concurrently running clients then compete for the shared
slack, but no client ever exceeds its own budget cap.  That is exactly
capped max-min fairness (water-filling): saturate everyone at
min(budget, fair-share), redistribute leftover capacity among the
still-unsaturated.

On the GPU this emerges from MPS scheduling; the discrete-event engine
enforces the same semantics.  A pure-Python copy of ``repro.core.sharing``.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

CAPACITY = 100.0


def compute_rates(
    active: Sequence[Tuple[int, float]],
    capacity: float = CAPACITY,
) -> Dict[int, float]:
    """Max-min fair rates with per-client caps.

    active: (client_id, budget) pairs.  Returns client_id -> rate (in budget
    units/sec; a client with rate r finishes w budget-seconds of work in
    w/r seconds).
    """
    if not active:
        return {}
    total = sum(b for _, b in active)
    if total <= capacity:  # no contention — everyone runs at full budget
        return {cid: b for cid, b in active}
    rates: Dict[int, float] = {}
    remaining = list(active)
    cap_left = capacity
    # Water-filling: clients with budget below the fair share are satisfied
    # in full; the rest split what remains equally, capped by their budgets.
    # When capacity is exhausted (pool fully preempted, or numerical dust
    # after saturations consumed it exactly) the unsaturated remainder gets
    # rate 0 — callers must treat 0 as *stalled*, never divide by it.
    while remaining:
        fair = max(cap_left, 0.0) / len(remaining)
        sat = [(cid, b) for cid, b in remaining if b <= fair]
        if not sat:
            for cid, _b in remaining:
                rates[cid] = fair
            return rates
        for cid, b in sat:
            rates[cid] = b
            cap_left -= b
        remaining = [(cid, b) for cid, b in remaining if b > fair]
    return rates


def slowdown(active: Sequence[Tuple[int, float]], capacity: float = CAPACITY) -> Dict[int, float]:
    """Per-client slowdown factor vs. uncontended execution (Fig 14d).

    A stalled client (granted rate 0) reports ``inf`` rather than being
    silently dropped from the result.
    """
    rates = compute_rates(active, capacity)
    return {
        cid: (b / rates[cid] if rates[cid] > 0.0 else float("inf"))
        for cid, b in active
    }
