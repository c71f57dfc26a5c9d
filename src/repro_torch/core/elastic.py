"""Elastic pool scaling: capacity changes as first-class campaign events.

At 1000+ nodes, pods join/leave mid-round (preemptions, repairs).  The
engine treats pool capacity as a *piecewise-constant* function of time:
``CapacityEvent``s live in the campaign heap next to completions/failures/
churn edges, the sharing policy re-waterfills rates against the new
capacity, the scheduler's θ threshold scales with the pool so admission
stays proportional, and executors whose clients no longer fit are shed
back into the pending set through the scheduler's ``requeue`` API
(re-scheduling, not lost work at the FL level — the client re-runs its
local steps on the next admission; deltas are idempotent w.r.t. the global
round).

``ElasticRoundSimulator`` is the single-round facade over that engine.
A pure-Python copy of ``repro.core.elastic``.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Type

from repro_torch.core.campaign import CampaignEngine, CapacityEvent  # noqa: F401
from repro_torch.core.executor import ProcessManager
from repro_torch.core.scheduler import FedHCScheduler, SchedulerBase
from repro_torch.core.simulator import RoundResult, SimClient


class ElasticRoundSimulator:
    """One global round under a capacity schedule (facade over
    ``CampaignEngine`` with the events posted into its heap)."""

    def __init__(
        self,
        scheduler_cls: Type[SchedulerBase] = FedHCScheduler,
        *,
        theta_frac: float = 1.0,   # θ = theta_frac × current capacity
        capacity: float = 100.0,
        events: Sequence[CapacityEvent] = (),
        max_parallel: int = 64,
    ):
        self.scheduler_cls = scheduler_cls
        self.theta_frac = theta_frac
        self.capacity0 = capacity
        self.events = sorted(events, key=lambda e: e.time)
        self.max_parallel = max_parallel

    def run(self, clients: Sequence[SimClient]) -> Tuple[RoundResult, ProcessManager]:
        engine = CampaignEngine(
            self.scheduler_cls,
            theta=self.theta_frac * self.capacity0,
            capacity=self.capacity0,
            max_parallel=self.max_parallel,
            capacity_events=[
                CapacityEvent(e.time, e.capacity,
                              theta=self.theta_frac * e.capacity)
                for e in self.events
            ],
        )
        result = engine.run_round(clients)
        return result, engine.mgr
