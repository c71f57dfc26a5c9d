"""Discrete-event engine for one FL global round (paper §6 experiments).

A pure-Python copy of ``repro.core.simulator``.  ``RoundSimulator`` is a
thin façade over the multi-round
``repro_torch.core.campaign.CampaignEngine`` — a single-round campaign starting
at clock 0 with sync boundaries and no availability churn is exactly the
old engine: admission at t=0 and at every completion, per-event rates from
the sharing policy (hard margin: own budget; soft margin: capped max-min
share), failure injection relative to client start, and a deadline that
kills every straggler still running.

``work`` is expressed in seconds-at-full-capacity: a client with budget b
and no contention completes in ``work / (b/100)`` seconds — exactly the
paper's semantics where fewer SMs mean proportionally slower kernels.
The timeline/parallelism/utilization traces feed Figs 9–14 benchmarks.

The result dataclasses (``SimClient``/``Span``/``TimelineSeg``/
``RoundResult``) and ``CapacityEvent`` live in
``repro_torch.core.campaign`` and are re-exported here.  Mid-round
capacity changes are campaign heap events — see
``repro_torch.core.elastic`` for the single-round facade and
``repro_torch.core.fabric`` for multi-tenant pools.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Type

from repro_torch.core.campaign import (  # noqa: F401  (re-exports)
    CampaignEngine,
    CapacityEvent,
    RoundResult,
    SimClient,
    Span,
    TimelineSeg,
)
from repro_torch.core.executor import ProcessManager
from repro_torch.core.scheduler import FedHCScheduler, SchedulerBase


class RoundSimulator:
    def __init__(
        self,
        scheduler_cls: Type[SchedulerBase] = FedHCScheduler,
        *,
        theta: float = 100.0,
        capacity: float = 100.0,
        manager_mode: str = "dynamic",
        max_parallel: int = 64,
        deadline: Optional[float] = None,
        failure_times: Optional[Dict[int, float]] = None,
        obs=None,
    ):
        self.scheduler_cls = scheduler_cls
        self.theta = theta
        self.capacity = capacity
        self.manager_mode = manager_mode
        self.max_parallel = max_parallel
        self.deadline = deadline
        # client_id -> relative time after start at which it dies
        self.failure_times = failure_times or {}
        self.obs = obs  # optional repro_torch.obs.ObsPlane, handed to the engine

    def run(self, clients: Sequence[SimClient]) -> Tuple[RoundResult, ProcessManager]:
        engine = CampaignEngine(
            self.scheduler_cls,
            theta=self.theta,
            capacity=self.capacity,
            manager_mode=self.manager_mode,
            max_parallel=self.max_parallel,
            obs=self.obs,
        )
        result = engine.run_round(
            clients, deadline=self.deadline, failure_times=self.failure_times
        )
        return result, engine.mgr
