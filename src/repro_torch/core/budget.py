"""Resource budgets — FedHC's system-heterogeneity primitive.

A budget is a percentage of the resource pool's compute a client may use
(paper: % of GPU SMs via CUDA MPS).  A pure-Python copy of
``repro.core.budget``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np


@dataclass(frozen=True)
class ClientBudget:
    client_id: int
    budget: float  # percent of the pool, in (0, 100]

    def __post_init__(self):
        if not (0.0 < self.budget <= 100.0):
            raise ValueError(f"budget must be in (0, 100], got {self.budget}")


def fedscale_budget_distribution(
    n_clients: int, seed: int = 0, quantum: int = 5
) -> List[ClientBudget]:
    """Transfer of the FedScale device-speed dataset onto budgets (Fig 9a).

    FedScale's compute-speed trace is long-tailed: many slow devices, few
    fast ones.  We map a clipped lognormal onto the (0, 100] budget range,
    quantized to ``quantum`` percent steps like the paper's examples.
    """
    rng = np.random.default_rng(seed)
    raw = rng.lognormal(mean=3.0, sigma=0.6, size=n_clients)
    raw = np.clip(raw, 2.0, 100.0)
    budgets = np.maximum(quantum, np.round(raw / quantum) * quantum)
    budgets = np.minimum(budgets, 100.0)
    return [ClientBudget(i, float(b)) for i, b in enumerate(budgets)]


def uniform_budgets(values: Sequence[float]) -> List[ClientBudget]:
    return [ClientBudget(i, float(v)) for i, v in enumerate(values)]


@dataclass(frozen=True)
class WorkloadSpec:
    """Workload-heterogeneity knobs (the paper's Fig 6 factors)."""

    model: str = "lstm"
    n_layers: int = 2
    seq_len: int = 64
    batch_size: int = 32
    n_batches: int = 10          # data volume (local steps per round)
    extra_local_model: bool = False

    def replace(self, **kw) -> "WorkloadSpec":
        return dataclasses.replace(self, **kw)
