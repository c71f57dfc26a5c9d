"""The port's multi-tenant fabric against the live reference: weighted
max-min capacity grants, the arbiter's leases, starvation flags and
preemption on lease expiry, and ``PoolFabric.run`` over two and three
tenants.  Everything here is pure Python on floats, so every output must
be EQUAL to the reference's (grants, lease states, spans, timelines,
utilization, preemptions, event histories), pinned against the live
reference and never against a golden table.  Inputs come from numpy
seeds.  The fairness properties of ``tests/test_fabric.py`` (the 3:1 →
12/4 split, the starvation bound of one lease TTL) are held on the port
itself."""
import numpy as np
import pytest

import repro.core.campaign as ref_campaign
import repro.core.fabric as ref_fabric
import repro.core.scheduler as ref_scheduler
import repro_torch.core.campaign as port_campaign
import repro_torch.core.fabric as port_fabric
import repro_torch.core.scheduler as port_scheduler

from _torch_worlds import campaign_digest, engine_digest

PKGS = {"ref": (ref_campaign, ref_fabric, ref_scheduler),
        "port": (port_campaign, port_fabric, port_scheduler)}


def _both(fn):
    """``fn(campaign, fabric, scheduler)`` on each package: (ref, port)."""
    return fn(*PKGS["ref"]), fn(*PKGS["port"])


# ------------------- weighted max-min ----------------------------------------


def _maxmin_cases(seed, n_cases=200):
    rng = np.random.default_rng(seed)
    for _ in range(n_cases):
        n = int(rng.integers(1, 7))
        names = [f"t{i}" for i in range(n)]
        demands = {k: float(rng.choice([0.0, rng.uniform(0.0, 150.0)], p=[0.2, 0.8]))
                   for k in names}
        weights = {k: float(rng.choice([1.0, 2.0, 3.0, rng.uniform(0.1, 5.0)]))
                   for k in names}
        yield demands, weights, float(rng.choice([100.0, rng.uniform(10.0, 300.0)]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_weighted_maxmin_equals_reference(seed):
    for demands, weights, total in _maxmin_cases(seed):
        ref, port = _both(lambda c, f, s: f.weighted_maxmin(demands, weights, total))
        assert port == ref, (demands, weights, total)


@pytest.mark.parametrize("case", [
    ({"a": 10.0, "b": 200.0}, {"a": 1.0, "b": 1.0}, 100.0, {"a": 10.0, "b": 90.0}),
    ({"a": 500.0, "b": 500.0}, {"a": 3.0, "b": 1.0}, 100.0, {"a": 75.0, "b": 25.0}),
    ({"a": 80.0, "b": 0.0, "c": 80.0}, {"a": 1.0, "b": 1.0, "c": 1.0}, 100.0,
     {"a": 50.0, "b": 0.0, "c": 50.0}),
], ids=["small_first", "weights_under_saturation", "work_conserving"])
def test_weighted_maxmin_reference_cases(case):
    demands, weights, total, want = case
    ref, port = _both(lambda c, f, s: f.weighted_maxmin(demands, weights, total))
    assert port == ref
    assert port == pytest.approx(want)


# ------------------- the arbiter ---------------------------------------------


def _arbiter_script(seed):
    """A seeded random walk over the arbiter's API: registrations, leases,
    releases, starvation flags, clock moves, revocations, capacity grants.
    Returns every observable after every operation."""
    def run(campaign, fabric, scheduler):
        rng = np.random.default_rng(seed)
        arb = fabric.ResourceArbiter(total_slots=int(rng.integers(4, 13)),
                                     capacity=float(rng.choice([60.0, 100.0])),
                                     lease_ttl=float(rng.choice([1.0, 2.5])))
        slots = {}
        for i in range(int(rng.integers(2, 5))):
            slots[f"t{i}"] = arb.register(f"t{i}", float(rng.choice([1.0, 2.0, 3.0])))
        log = []
        for _ in range(120):
            tid = f"t{int(rng.integers(len(slots)))}"
            op = int(rng.integers(10))
            if op <= 3:
                src = slots[tid]
                log.append(("bool", bool(src), len(src)))
                try:
                    log.append(("popleft", src.popleft()))
                except IndexError:
                    log.append(("popleft", None))
            elif op == 4 and arb.tenants[tid].leases:
                slot = sorted(arb.tenants[tid].leases)[int(rng.integers(
                    len(arb.tenants[tid].leases)))]
                slots[tid].append(slot)
                log.append(("release", tid, slot))
            elif op in (5, 6):
                arb.note_starved(tid)
                log.append(("starved", tid, arb.next_expiry()))
            elif op == 7:
                arb.now += float(rng.uniform(0.0, 1.5))
                revoked = arb.revocable()
                log.append(("revoked", [(l.slot, l.tenant, l.soft, l.expires) for l in revoked]))
                for l in revoked:
                    arb.release(l.tenant, l.slot)
            elif op == 8:
                for t in arb.tenants.values():
                    t.demand = float(rng.uniform(0.0, 80.0))
                log.append(("grants", arb.capacity_grants()))
            elif op == 9:
                arb.clear_starvation()
            log.append(({t: sorted((l.slot, l.soft, l.expires, l.revoked)
                                   for l in x.leases.values())
                         for t, x in arb.tenants.items()},
                        list(arb.free), arb.revocations,
                        {t: arb.fair_slots(t) for t in arb.tenants}))
        return log
    return run


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_arbiter_leases_and_preemption_equal_reference(seed):
    ref, port = _both(_arbiter_script(seed))
    assert port == ref
    assert any(e[0] == "revoked" and e[1] for e in port if isinstance(e[0], str)), \
        "the script never revoked a lease"


def test_arbiter_firm_soft_and_denied_borrow():
    arb = port_fabric.ResourceArbiter(total_slots=4, lease_ttl=3.0)
    a = arb.register("a", weight=1.0)
    b = arb.register("b", weight=1.0)
    s0, s1 = a.popleft(), a.popleft()
    assert not arb.tenants["a"].leases[s0].soft
    s2 = a.popleft()
    assert arb.tenants["a"].leases[s2].soft
    assert arb.tenants["a"].leases[s2].expires == pytest.approx(3.0)
    arb.note_starved("b")
    assert not arb.can_acquire("a") and arb.can_acquire("b")
    assert b.popleft() is not None
    with pytest.raises(KeyError):
        arb.release("b", s1)
    with pytest.raises(ValueError):
        arb.register("a")


# ------------------- PoolFabric.run ------------------------------------------


def _flood(sim_client, n, budget=5.0, work=100.0, base=0):
    return [sim_client(base + i, budget, work) for i in range(n)]


def _rounds(sim_client, rng, n_rounds, per_round, base):
    out = []
    for r in range(n_rounds):
        out.append([sim_client(base + r * per_round + i,
                               float(rng.choice([5.0, 10.0, 25.0, 60.0, 80.0])),
                               float(rng.uniform(0.5, 4.0)))
                    for i in range(per_round)])
    return out


def _scenario_3_to_1(campaign, fabric, scheduler):
    fab = fabric.PoolFabric(total_slots=16, capacity=100.0, lease_ttl=2.0)
    fab.add_tenant("A", weight=3.0)
    fab.add_tenant("B", weight=1.0)
    S = campaign.SimClient
    res = fab.run({"A": [_flood(S, 40)], "B": [_flood(S, 40, base=1000)]})
    return fab, res


def _scenario_three_tenants(campaign, fabric, scheduler):
    rng = np.random.default_rng(5)
    S = campaign.SimClient
    fab = fabric.PoolFabric(total_slots=12, capacity=100.0, lease_ttl=1.5)
    fab.add_tenant("A", weight=2.0, theta=140.0)
    fab.add_tenant("B", weight=1.0, scheduler_cls=scheduler.GreedyScheduler)
    fab.add_tenant("C", weight=1.0, async_rounds=True)
    work = {t: _rounds(S, rng, 2, 14, 1000 * i) for i, t in enumerate("ABC")}
    # deadlines and failures on A's second round
    a2 = work["A"][1]
    work["A"][1] = campaign.RoundSpec(
        clients=tuple(a2), deadline=6.0,
        failure_times={a2[0].client_id: 0.3, a2[3].client_id: 1.1})
    return fab, fab.run(work)


def _scenario_churn(campaign, fabric, scheduler):
    S = campaign.SimClient
    clients = [S(i, 20.0, 0.5) for i in range(12)]
    trace = campaign.AvailabilityTrace.periodic(
        [c.client_id for c in clients], period=8.0, duty=0.6, horizon=1000.0, seed=3)
    fab = fabric.PoolFabric(total_slots=16, capacity=100.0, lease_ttl=2.0)
    fab.add_tenant("churny", weight=1.0, availability=trace)
    fab.add_tenant("steady", weight=1.0)
    res = fab.run({"churny": [clients] * 2,
                   "steady": [[S(100 + i, 20.0, 0.5) for i in range(12)]] * 2})
    return fab, res


@pytest.mark.parametrize("scenario", [_scenario_3_to_1, _scenario_three_tenants,
                                      _scenario_churn],
                         ids=["two_tenants_3_to_1", "three_tenants", "churn"])
def test_pool_fabric_run_equals_reference(scenario):
    def digest(campaign, fabric, scheduler):
        fab, res = scenario(campaign, fabric, scheduler)
        return ({t: campaign_digest(r) for t, r in res.items()},
                {t: engine_digest(x.engine) for t, x in fab.tenants.items()},
                fab.arbiter.revocations, fab.arbiter.now)
    ref, port = _both(digest)
    assert port == ref
    assert sum(r[1] for r in port[0].values()) > 0


def _parallelism_at(result, t):
    for seg in result.rounds[0].timeline:
        if seg.t0 <= t < seg.t1:
            return seg.parallelism
    return 0


def test_weighted_fair_share_converges_to_3_to_1():
    """3:1 weights under sustained load settle at 12/4 of 16 slots, reached
    by revoking A's expired over-share leases."""
    fab, res = _scenario_3_to_1(*PKGS["port"])
    assert res["A"].total_completed == 40 and res["B"].total_completed == 40
    assert _parallelism_at(res["A"], 1000.0) == 12
    assert _parallelism_at(res["B"], 1000.0) == 4
    assert fab.tenants["A"].engine.preemptions > 0 and fab.arbiter.revocations > 0
    assert fab.tenants["B"].engine.preemptions == 0
    assert res["A"].churn_evictions == 0


@pytest.mark.parametrize("seed", range(5))
def test_no_starvation_bound_by_lease_ttl(seed):
    """Whatever A floods the pool with, B schedules its first client within
    one lease TTL, and the port's timelines are the reference's."""
    def run(campaign, fabric, scheduler):
        rng = np.random.default_rng(seed)
        ttl = float(rng.choice([1.0, 2.5, 5.0]))
        S = campaign.SimClient
        fab = fabric.PoolFabric(total_slots=8, capacity=100.0, lease_ttl=ttl)
        fab.add_tenant("A", weight=1.0)
        fab.add_tenant("B", weight=1.0)
        wa = [_flood(S, int(rng.integers(16, 41)), budget=float(rng.choice([5.0, 10.0])),
                     work=float(rng.uniform(50.0, 200.0)))]
        res = fab.run({"A": wa, "B": [_flood(S, 6, budget=10.0, work=5.0, base=1000)]})
        return ttl, {t: campaign_digest(r) for t, r in res.items()}, res
    (_, ref, _), (ttl, port, res) = _both(run)
    assert port == ref
    assert res["B"].total_completed == 6
    first = min(s.start for s in res["B"].rounds[0].spans.values())
    assert first <= ttl + 1e-9, (ttl, first)


def test_work_conserving_borrow_when_other_tenant_idle():
    fab = port_fabric.PoolFabric(total_slots=16, capacity=100.0, lease_ttl=2.0)
    fab.add_tenant("A", weight=1.0)
    fab.add_tenant("B", weight=1.0)
    res = fab.run({"A": [_flood(port_campaign.SimClient, 20)]})
    assert res["A"].total_completed == 20
    assert _parallelism_at(res["A"], 50.0) == 16
    seg = [s for s in res["A"].rounds[0].timeline if s.t0 <= 50.0 < s.t1][0]
    assert seg.total_rate == pytest.approx(80.0)


def test_fabric_refuses_unknown_tenants_and_a_mirror():
    """An unregistered tenant is refused; a tenant with the control-plane
    mirror (once refused too, whence the name) runs, its monitor tracking
    the reference's."""
    fab = port_fabric.PoolFabric(total_slots=4)
    fab.add_tenant("A")
    with pytest.raises(KeyError, match="unregistered"):
        fab.run({"B": [[port_campaign.SimClient(0, 10.0, 1.0)]]})

    def run(campaign, fabric, scheduler):
        fab = fabric.PoolFabric(total_slots=4, lease_ttl=2.0)
        eng = fab.add_tenant("M", mirror=True)
        fab.add_tenant("N", weight=2.0)
        res = fab.run({"M": [_flood(campaign.SimClient, 6, work=3.0)] * 2,
                       "N": [_flood(campaign.SimClient, 6, work=5.0, base=100)]})
        mon = eng.server.monitor
        return (campaign_digest(res["M"]), dict(mon.state),
                [(c, k.value, st) for c, k, st in mon.log], sorted(eng.server.uploads))
    ref, port = _both(run)
    assert port == ref
    assert set(port[1].values()) == {"done"} and len(port[3]) == 6
