"""FedHC core: the paper's contribution as composable modules (the port of
``repro.core``, with the reference's exports but ``ControlPlaneMirror``,
which comes with the multihost slice).

* budgets (system heterogeneity)          -> repro_torch.core.budget
* framework-provided runtime (workload)   -> repro_torch.core.runtime
* double-pointer scheduler (Algorithm 1)  -> repro_torch.core.scheduler
* dynamic process manager                 -> repro_torch.core.executor
* soft/hard-margin resource sharing       -> repro_torch.core.sharing
* discrete-event round engine             -> repro_torch.core.simulator
* multi-round campaign engine             -> repro_torch.core.campaign
* multi-tenant resource fabric            -> repro_torch.core.fabric
* aggregation strategies                  -> repro_torch.core.aggregation
* FedScale-style estimator (the foil)     -> repro_torch.core.estimator
"""
from repro_torch.core.budget import ClientBudget, WorkloadSpec, fedscale_budget_distribution
from repro_torch.core.campaign import (
    AvailabilityTrace,
    CampaignEngine,
    CampaignResult,
    CapacityEvent,
    RoundSpec,
)
from repro_torch.core.fabric import PoolFabric, ResourceArbiter, TenantSlots
from repro_torch.core.scheduler import FedHCScheduler, GreedyScheduler, SCHEDULERS
from repro_torch.core.sharing import compute_rates, slowdown
from repro_torch.core.simulator import RoundResult, RoundSimulator, SimClient
from repro_torch.core.executor import ProcessManager, RecordTable, Event, EventKind
from repro_torch.core.aggregation import AsyncAggregator, apply_deltas, fedavg
from repro_torch.core.runtime import AnalyticalRuntime, MeasuredRuntime, StepCost
from repro_torch.core.estimator import FedScaleEstimator
from repro_torch.core.elastic import ElasticRoundSimulator
