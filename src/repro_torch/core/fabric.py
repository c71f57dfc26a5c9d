"""Multi-tenant resource fabric: one accelerator pool, N concurrent FL
campaigns (FedML-Parrot's job hierarchies × BouquetFL's shifting fleets).

A pure-Python copy of ``repro.core.fabric``: the float code
(``weighted_maxmin``, ``ResourceArbiter.capacity_grants``) keeps the
reference's order of operations, so timelines match it bit for bit.

Three pieces:

* ``ResourceArbiter`` — owns the pool's executor slots and physical
  capacity.  Slots are *leased* to tenants under weighted fair share:
  a tenant within its share gets a firm lease; above it, a work-conserving
  *soft* lease with an expiry.  When a tenant below its share starves, the
  arbiter (a) stops granting new soft leases to over-share tenants, so
  naturally freed slots drain toward the starved tenant, and (b) revokes
  expired soft leases outright — preemption-on-lease-expiry bounds how
  long any tenant can be starved to one lease TTL.  Capacity (budget
  units) is granted work-conservingly by weighted max-min over tenant
  demands, so an idle tenant's share flows to the busy ones.
* ``TenantSlots`` — a deque-compatible adapter (popleft/append/bool/len)
  that lets ``ProcessManager`` and the schedulers draw from the arbiter
  through the exact AvailE surface they already use.
* ``PoolFabric`` — drives N ``CampaignEngine`` tenants under ONE merged
  clock via the engine stepping API (``peek_time``/``step``/
  ``advance_to``), re-arbitrating slots and re-granting capacity after
  every event.  Revoked leases surface to engines as ``preempt_slot`` —
  evict + requeue through the scheduler API, exactly like availability
  churn, so no FL-level work is ever lost.

The payoff: K jobs sharing one pod is a supported scenario, and because
each tenant fills the others' straggler tails, aggregate throughput beats
running the same jobs serially on the same capacity.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Sequence, Type, Union

from repro_torch.core.campaign import (
    CampaignEngine,
    CampaignResult,
    RoundSpec,
    SimClient,
)
from repro_torch.core.scheduler import FedHCScheduler, SchedulerBase


# --------------------------------------------------------------------------
# Weighted max-min (capacity grants)
# --------------------------------------------------------------------------


def weighted_maxmin(
    demands: Dict[str, float], weights: Dict[str, float], total: float
) -> Dict[str, float]:
    """Work-conserving weighted max-min: tenants whose demand fits under
    their weighted share are satisfied in full; the leftover capacity is
    re-split (by weight) among the rest."""
    grants = {k: 0.0 for k in demands}
    todo = {k for k, d in demands.items() if d > 1e-12 and weights.get(k, 0.0) > 0.0}
    cap = float(total)
    while todo and cap > 1e-12:
        wsum = sum(weights[k] for k in todo)
        sat = [k for k in todo if demands[k] <= cap * weights[k] / wsum + 1e-12]
        if not sat:
            for k in todo:
                grants[k] = cap * weights[k] / wsum
            return grants
        for k in sat:
            grants[k] = demands[k]
            cap -= demands[k]
            todo.discard(k)
        cap = max(cap, 0.0)
    return grants


# --------------------------------------------------------------------------
# Slot leasing
# --------------------------------------------------------------------------


@dataclass
class SlotLease:
    slot: int
    tenant: str
    soft: bool                  # granted above fair share (work-conserving)
    expires: Optional[float]    # soft leases expire; firm leases never do
    revoked: bool = False


class _Tenant:
    def __init__(self, tid: str, weight: float):
        self.tid = tid
        self.weight = float(weight)
        self.leases: Dict[int, SlotLease] = {}
        self.starved = False    # denied a slot during the last admission pass
        self.demand = 0.0       # admitted budget (drives capacity grants)

    @property
    def held(self) -> int:
        return len(self.leases)


class TenantSlots:
    """deque-compatible slot source backed by an arbiter lease, so the
    scheduler's ``avail_executors`` checks double as starvation signals."""

    def __init__(self, arbiter: "ResourceArbiter", tid: str):
        self.arbiter = arbiter
        self.tid = tid

    def __bool__(self) -> bool:
        ok = self.arbiter.can_acquire(self.tid)
        if not ok:
            self.arbiter.note_starved(self.tid)
        return ok

    def __len__(self) -> int:
        return self.arbiter.free_count() if self.arbiter.can_acquire(self.tid) else 0

    def popleft(self) -> int:
        slot = self.arbiter.acquire(self.tid)
        if slot is None:
            self.arbiter.note_starved(self.tid)
            raise IndexError("no leasable slot")
        return slot

    def append(self, slot: int) -> None:
        self.arbiter.release(self.tid, slot)


class ResourceArbiter:
    """Partitions one pool's executor slots and capacity across tenants."""

    def __init__(self, total_slots: int = 64, capacity: float = 100.0,
                 lease_ttl: float = 5.0):
        self.total_slots = int(total_slots)
        self.capacity = float(capacity)
        self.lease_ttl = float(lease_ttl)
        self.free: Deque[int] = deque(range(self.total_slots))
        self.tenants: Dict[str, _Tenant] = {}
        self.now = 0.0
        self.revocations = 0

    # -- registration ------------------------------------------------------

    def register(self, tid: str, weight: float = 1.0) -> TenantSlots:
        """Add a tenant with a fair-share ``weight``; returns its
        :class:`TenantSlots` adapter (the deque-compatible slot source a
        ``ProcessManager`` draws from).  Fair share is
        ``total_slots * weight / Σ weights`` and shifts as tenants join."""
        if tid in self.tenants:
            raise ValueError(f"tenant {tid!r} already registered")
        if weight <= 0.0:
            raise ValueError(f"tenant weight must be positive, got {weight}")
        self.tenants[tid] = _Tenant(tid, weight)
        return TenantSlots(self, tid)

    def fair_slots(self, tid: str) -> float:
        wsum = sum(t.weight for t in self.tenants.values())
        return self.total_slots * self.tenants[tid].weight / wsum

    # -- leasing -----------------------------------------------------------

    def _someone_else_starved(self, tid: str) -> bool:
        return any(
            t.starved and t.held < self.fair_slots(t.tid)
            for t in self.tenants.values()
            if t.tid != tid
        )

    def can_acquire(self, tid: str) -> bool:
        """Would ``acquire(tid)`` succeed right now?  True when a slot is
        free and the grant is either within the tenant's fair share (always
        allowed) or a work-conserving borrow while no other tenant under
        its own share is starving (freed slots must drain toward the
        starved tenant, not be re-borrowed)."""
        if not self.free:
            return False
        if self.tenants[tid].held + 1 <= self.fair_slots(tid) + 1e-9:
            return True  # within fair share: always grantable
        # work-conserving borrow — but never while someone under their
        # share is waiting (freed slots must drain toward them)
        return not self._someone_else_starved(tid)

    def acquire(self, tid: str) -> Optional[int]:
        """Lease one slot to ``tid``, or ``None`` (see ``can_acquire``).

        Grants within fair share are *firm* (never expire); grants above
        it are *soft* with expiry ``now + lease_ttl`` — the handle a
        starved tenant can later revoke (``revocable``).  Acquiring also
        clears the tenant's starvation flag."""
        if not self.can_acquire(tid):
            return None
        t = self.tenants[tid]
        slot = self.free.popleft()
        soft = t.held + 1 > self.fair_slots(tid) + 1e-9
        t.leases[slot] = SlotLease(
            slot, tid, soft, self.now + self.lease_ttl if soft else None
        )
        t.starved = False
        return slot

    def release(self, tid: str, slot: int) -> None:
        """Return a leased slot to the pool (executor finished, or a
        revoked lease's executor was preempted).  The only way slots come
        back — revocation itself never frees the slot directly.  Raises
        ``KeyError`` if ``tid`` does not hold ``slot``."""
        lease = self.tenants[tid].leases.pop(slot, None)
        if lease is None:
            raise KeyError(f"tenant {tid!r} does not hold slot {slot}")
        self.free.append(slot)

    def note_starved(self, tid: str) -> None:
        self.tenants[tid].starved = True

    def clear_starvation(self) -> None:
        for t in self.tenants.values():
            t.starved = False

    def free_count(self) -> int:
        return len(self.free)

    # -- preemption on lease expiry ----------------------------------------

    def _slot_deficit(self, t: _Tenant) -> int:
        """Whole slots a starved tenant is owed (same floor as revocable:
        a fractional share never triggers a preemption wake-up, or the
        fabric would spin on an expiry it never revokes)."""
        return max(0, math.floor(self.fair_slots(t.tid)) - t.held)

    def next_expiry(self) -> Optional[float]:
        """Earliest soft-lease expiry that could unblock a starved tenant
        (None when nobody under their share is waiting)."""
        if not any(
            t.starved and self._slot_deficit(t) > 0
            for t in self.tenants.values()
        ):
            return None
        exps = [
            l.expires
            for t in self.tenants.values()
            if t.held > self.fair_slots(t.tid) + 1e-9
            for l in t.leases.values()
            if l.soft and not l.revoked and l.expires is not None
        ]
        return min(exps, default=None)

    def revocable(self) -> List[SlotLease]:
        """Expired soft leases held above fair share while a tenant under
        its share starves.  Marks them revoked (counted once); the caller
        preempts the executors and the slots come back through the normal
        release path."""
        needed = sum(
            self._slot_deficit(t)
            for t in self.tenants.values()
            if t.starved
        )
        if needed <= 0:
            return []
        out: List[SlotLease] = []
        for t in self.tenants.values():
            excess = t.held - self.fair_slots(t.tid)
            if excess <= 1e-9:
                continue
            soft = sorted(
                (l for l in t.leases.values()
                 if l.soft and not l.revoked and l.expires is not None
                 and l.expires <= self.now + 1e-9),
                key=lambda l: l.expires,
            )
            for l in soft:
                if len(out) >= needed or excess <= 1e-9:
                    break
                l.revoked = True
                out.append(l)
                excess -= 1
        self.revocations += len(out)
        return out

    # -- capacity grants ---------------------------------------------------

    def capacity_grants(self) -> Dict[str, float]:
        grants = weighted_maxmin(
            {tid: t.demand for tid, t in self.tenants.items()},
            {tid: t.weight for tid, t in self.tenants.items()},
            self.capacity,
        )
        # distribute the surplus by weight: demand is *admitted* budget,
        # which the tenant's current grant caps — granting only demand
        # ratchets a tenant's capacity down to whatever it last admitted
        # and leaves it no headroom to admit more when executors free up
        # (a lone tenant must see the whole pool, not its own shadow)
        leftover = self.capacity - sum(grants.values())
        if leftover > 1e-9 and self.tenants:
            wsum = sum(t.weight for t in self.tenants.values())
            for tid, t in self.tenants.items():
                grants[tid] = grants.get(tid, 0.0) + leftover * t.weight / wsum
        return grants


# --------------------------------------------------------------------------
# The fabric
# --------------------------------------------------------------------------


class FabricTenant:
    def __init__(self, tid: str, engine: CampaignEngine, weight: float):
        self.tid = tid
        self.engine = engine
        self.weight = weight


class PoolFabric:
    """Drives N campaign engines against one arbitered pool under one
    merged simulated clock."""

    def __init__(self, *, total_slots: int = 64, capacity: float = 100.0,
                 lease_ttl: float = 5.0, obs=None):
        self.arbiter = ResourceArbiter(total_slots, capacity, lease_ttl)
        self.tenants: Dict[str, FabricTenant] = {}
        # one observability plane shared by every tenant engine: spans land
        # on per-tenant tracks (pid = tenant id) under the merged clock
        self.obs = obs

    def add_tenant(
        self,
        tid: str,
        *,
        weight: float = 1.0,
        scheduler_cls: Type[SchedulerBase] = FedHCScheduler,
        theta: float = 100.0,
        **engine_kwargs,
    ) -> CampaignEngine:
        """Register a campaign tenant; returns its engine (use it directly
        for an alternating-rounds trainer, or let ``run`` drive it)."""
        slots = self.arbiter.register(tid, weight)
        engine_kwargs.setdefault("obs", self.obs)
        engine_kwargs.setdefault("tenant", tid)
        engine = CampaignEngine(
            scheduler_cls,
            theta=theta,
            capacity=self.arbiter.capacity,
            max_parallel=self.arbiter.total_slots,
            slot_source=slots,
            **engine_kwargs,
        )
        self.tenants[tid] = FabricTenant(tid, engine, weight)
        return engine

    # -- internals ---------------------------------------------------------

    def _sweep_all(self) -> None:
        # a starvation flag persists while the tenant still wants slots —
        # it must keep blocking others' borrowing across passes, or a
        # preempted tenant would win its slots right back on sweep order —
        # and ages out the moment the engine has no admissible client left
        for tid, ten in self.tenants.items():
            if not ten.engine.wants_slots():
                self.arbiter.tenants[tid].starved = False
        for ten in self.tenants.values():
            if ten.engine.pending():
                ten.engine.sweep()

    def _arbitrate(self) -> bool:
        """Revoke expired over-share leases for starved tenants; preempt
        the executors holding them.  Returns True if anything was freed.
        (Callers run it right after ``_sweep_all``, which has already aged
        out stale starvation flags.)"""
        preempted = False
        for lease in self.arbiter.revocable():
            engine = self.tenants[lease.tenant].engine
            if engine.preempt_slot(lease.slot) is None:
                # no live executor on the slot (freshly leased, not yet
                # spawned): return it straight to the pool
                self.arbiter.release(lease.tenant, lease.slot)
            preempted = True
        return preempted

    def _regrant(self) -> None:
        """Re-split pool capacity over tenant demands (weighted max-min);
        deliver changed grants to the engines at the current instant."""
        for tid, ten in self.tenants.items():
            self.arbiter.tenants[tid].demand = ten.engine.total_budget
        grants = self.arbiter.capacity_grants()
        for tid, ten in self.tenants.items():
            g = grants.get(tid, 0.0)
            if abs(g - ten.engine.capacity) > 1e-9:
                ten.engine._apply_capacity(g, shed=False)
                ten.engine.sweep()  # reconcile rates against the new grant

    def _reconcile_pool(self) -> None:
        """One arbitration pass: admit everywhere, preempt expired
        over-share leases if anyone starves (then let the freed slots be
        taken), and re-split capacity over the updated demands."""
        self._sweep_all()
        if self._arbitrate():
            self._sweep_all()
        self._regrant()

    # -- the merged event loop ---------------------------------------------

    def run(
        self,
        workloads: Dict[str, Sequence[Union[RoundSpec, Sequence[SimClient]]]],
    ) -> Dict[str, CampaignResult]:
        """Run each tenant's campaign (a sequence of global rounds)
        concurrently on the shared pool; returns per-tenant results."""
        unknown = set(workloads) - set(self.tenants)
        if unknown:
            raise KeyError(f"unregistered tenants: {sorted(unknown)}")
        engines = {tid: t.engine for tid, t in self.tenants.items()}

        start = max(e.now for e in engines.values())
        for eng in engines.values():
            eng.advance_to(start)
        self.arbiter.now = start

        enqueued = {
            tid: engines[tid].enqueue_rounds(rounds)
            for tid, rounds in workloads.items()
        }

        self._reconcile_pool()

        n_clients = sum(
            len(r.by_id) for rs in enqueued.values() for r in rs
        )
        guard = 10_000 + 200 * n_clients
        iters = 0
        while any(e.pending() for e in engines.values()):
            iters += 1
            if iters > guard:
                raise RuntimeError("fabric did not converge")

            cands = sorted(
                (t, tid) for tid, e in engines.items()
                if (t := e.peek_time()) is not None
            )
            expiry = self.arbiter.next_expiry()

            if not cands and expiry is None:
                # no timed event anywhere: close rounds that can never
                # progress (all remaining clients parked forever) — a
                # starved tenant never lands here, its unblocking event
                # (another tenant's completion or a lease expiry) exists
                stuck = [
                    e for tid, e in engines.items()
                    if e.pending() and not e.active
                ]
                if not stuck:
                    raise RuntimeError(
                        "fabric stalled: active executors hold zero rate "
                        "and no future event can unblock them"
                    )
                for e in stuck:
                    e.quiesce()
                self._reconcile_pool()
                continue

            t = cands[0][0] if cands else expiry
            if expiry is not None:
                t = min(t, expiry)

            # one merged clock: everyone reaches t together
            self.arbiter.now = t
            for eng in engines.values():
                eng.advance_to(t)
            for _, tid in cands:
                eng = engines[tid]
                while (pt := eng.peek_time()) is not None and pt <= t:
                    eng.step()

            # slots freed by completions flow to starved tenants; expired
            # over-share leases are revoked (preemption) if anyone still
            # starves after the sweep
            self._reconcile_pool()

        results: Dict[str, CampaignResult] = {}
        for tid, rnds in enqueued.items():
            rs = [r.result() for r in rnds]
            end = max((r.end for r in rnds), default=start)
            eng = engines[tid]
            results[tid] = CampaignResult(
                rounds=rs,
                duration=end - start,
                total_completed=sum(r.completed for r in rs),
                total_failed=sum(len(r.failed) for r in rs),
                churn_evictions=eng.churn_evictions,
                events_processed=eng.events_processed,
            )
        return results

    # -- trainer tenants: the fabric owns the clock ------------------------

    def run_trainers(
        self, trainers: Dict[str, object], rounds: Optional[int] = None,
    ) -> Dict[str, List[dict]]:
        """Drive N ``FederatedTrainer`` tenants to completion on the merged
        clock.  Each trainer must have been built with this fabric's tenant
        engine (``add_tenant``); ``rounds`` overrides every trainer's
        ``fed.rounds``.

        This inverts the ownership of the main loop: the trainer no longer
        blocks its thread inside ``run_round`` — it exposes resumable phase
        steps (``repro_torch.fed.trainer.RoundPhase``), subscribes to its
        engine's round-boundary callbacks, and this loop interleaves the
        *wall-clock* phases (local training, aggregation, eval)
        across tenants between *simulated* events.  Tenant A trains a
        client while tenant B aggregates; eager collection trains each
        simulated finisher the moment its COMPLETE fires, so the wall work
        no longer waits behind the round's straggler tail.  Returns each
        tenant's history records.
        """
        unknown = set(trainers) - set(self.tenants)
        if unknown:
            raise KeyError(f"unregistered tenants: {sorted(unknown)}")
        drivers: Dict[str, _TrainerDriver] = {}
        for tid, tr in trainers.items():
            if tr.engine is not self.tenants[tid].engine:
                raise ValueError(
                    f"trainer for tenant {tid!r} does not use this fabric's "
                    f"tenant engine — build it with engine=add_tenant({tid!r})"
                )
            drivers[tid] = _TrainerDriver(
                tid, tr, tr.fed.rounds if rounds is None else rounds
            )
        engines = {tid: self.tenants[tid].engine for tid in trainers}

        start = max(e.now for e in engines.values())
        for eng in engines.values():
            eng.advance_to(start)
        self.arbiter.now = start

        n_work = sum(
            d.rounds_left * (1 + len(d.trainer.clients))
            for d in drivers.values()
        )
        guard = 10_000 + 200 * n_work
        iters = 0
        while not all(d.done for d in drivers.values()):
            iters += 1
            if iters > guard:
                raise RuntimeError("fabric trainer loop did not converge")

            # wall-clock phase: ONE resumable step per tenant (sample +
            # submit, train one eager/collected client, aggregate, report)
            # so no tenant's wall work convoys the others
            submitted = walled = False
            for d in drivers.values():
                did, sub = d.wall_step()
                walled = walled or did
                submitted = submitted or sub
            if submitted:
                # freshly enqueued rounds need an admission pass before
                # their spawn events exist on the heap
                self._reconcile_pool()

            # simulated phase: dispatch the globally next event batch
            cands = sorted(
                (t, tid) for tid, e in engines.items()
                if (t := e.peek_time()) is not None
            )
            expiry = self.arbiter.next_expiry()
            if not cands and expiry is None:
                if walled or submitted:
                    continue  # wall work is progressing; nothing simulated yet
                stuck = [
                    e for e in engines.values() if e.pending() and not e.active
                ]
                if not stuck:
                    raise RuntimeError(
                        "fabric stalled: trainers idle, engines hold no "
                        "dispatchable event"
                    )
                for e in stuck:
                    e.quiesce()
                self._reconcile_pool()
                continue

            t = cands[0][0] if cands else expiry
            if expiry is not None:
                t = min(t, expiry)
            self.arbiter.now = t
            for eng in engines.values():
                eng.advance_to(t)
            for _, tid in cands:
                eng = engines[tid]
                while (pt := eng.peek_time()) is not None and pt <= t:
                    eng.step()
            self._reconcile_pool()

        return {tid: d.records for tid, d in drivers.items()}


class _TrainerDriver:
    """Per-tenant adapter between the fabric loop and one trainer's round
    state machine.  Duck-typed against ``repro_torch.fed.trainer`` (phase
    names as strings) so ``repro_torch.core`` keeps zero imports from the
    fed layer.

    The trainer subscribes itself to its engine's round-boundary callbacks
    on ``submit_round`` (each simulated COMPLETE feeds its eager-collection
    queue; round close delivers the ``RoundResult`` and flips the phase),
    so the driver only sequences wall work: ``wall_step`` makes one unit
    of wall progress per call."""

    def __init__(self, tid: str, trainer, rounds: int):
        self.tid = tid
        self.trainer = trainer
        self.rounds_left = int(rounds)
        self.st = None                       # in-flight RoundState
        self.records: List[dict] = []

    @property
    def done(self) -> bool:
        return self.rounds_left <= 0 and self.st is None

    def wall_step(self) -> tuple:
        """Advance this tenant's round by one wall-clock unit.  Returns
        ``(progressed, submitted)`` — ``submitted`` tells the fabric a new
        round spec entered the engine and needs an admission pass."""
        t = self.trainer
        if self.st is None:
            if self.rounds_left <= 0:
                return (False, False)
            self.st = t.begin_round()
            t.step_round(self.st)            # SAMPLE (probes, RNG draws)
            t.submit_round(self.st)          # queue spec; fabric owns clock
            return (True, True)
        st = self.st
        if st.phase.name == "SIMULATE":
            # round still in flight on the simulated clock: train clients
            # whose COMPLETE already fired, if any — a whole wave in one
            # batched program when the trainer batches, else one client
            return (t.collect_wave_eager(st) > 0, False)
        t.step_round(st)                     # DISPATCH/COLLECT/AGGREGATE/REPORT
        if st.phase.name == "DONE":
            self.records.append(st.rec)
            self.rounds_left -= 1
            self.st = None
        return (True, False)
