"""Fabric-driven rounds of the port's trainer: ``submit_round``, the
engine's round-boundary callbacks, eager collection while a round is still
SIMULATE, and ``PoolFabric.run_trainers`` interleaving N trainers' wall
phases between their engines' simulated events.

Held against the port's own synchronous ``run_round`` (a single tenant:
bit for bit when clients train one at a time) and against the live
reference driven the same way (two tenants: the history field for field,
the parameters within 2e-5).  The tenants of both packages carry their
control-plane mirror (as the reference's tests do): the mirror does not
feed the timeline.  Small worlds from numpy seeds: six clients,
hidden 16, deterministic runtimes."""
import jax
import pytest
import torch

from repro_torch.bridge import flatten
from repro_torch.core.fabric import PoolFabric
from repro_torch.core.runtime import FixedRuntime
from repro_torch.fed.trainer import FedConfig, FederatedTrainer, RoundPhase
from repro_torch.obs import ObsPlane
from repro_torch.tree import tree_leaves

from _torch_worlds import (
    BATCH_SIZES, BUDGETS, MCFG, assert_histories_match, eval_batch, max_tree_diff,
    twin_clients, twin_fabric_trainers)

PORT_TENANT_KW = dict(record_campaign_timeline=False, record_events=False)
FED_KW = dict(rounds=3, participants_per_round=4, local_steps=2, learning_rate=0.2)


def _port_trainer(engine=None, obs=None, seed=4, ckpt_dir=None, **fed_kw):
    _, clients = twin_clients(BATCH_SIZES, seed=seed, budgets=BUDGETS)
    kw = dict(FED_KW, client_batching="off")
    kw.update(fed_kw)
    return FederatedTrainer(MCFG, clients, FedConfig(ckpt_dir=ckpt_dir, ckpt_every=2, **kw),
                            test_batch=eval_batch(), engine=engine, obs=obs,
                            runtime=FixedRuntime(2.0, 1.0), device="cpu")


def _rel_params_gap(a, b):
    return max(float((x - y).norm() / y.norm()) for x, y in
               zip(tree_leaves(a.params), tree_leaves(b.params)))


def _identical(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)))


@pytest.mark.parametrize("batching", ["off", "wave"])
def test_single_tenant_fabric_equals_run_round(batching):
    """One tenant on a fabric trains what ``run_round`` trains.  Clients one
    at a time: bit for bit (eager collection takes the finishers in the
    order DISPATCH would).  Waves: the fabric drains each batch of fired
    COMPLETEs as its own wave, so a round is several ragged waves, down to
    single clients, where ``run_round`` runs one; the simulated fields are
    equal and the parameters within 2e-5."""
    solo = _port_trainer(client_batching=batching)
    hist = [dict(r) for r in solo.run()]
    fab = PoolFabric(total_slots=32, capacity=100.0, lease_ttl=5.0)
    tr = _port_trainer(engine=fab.add_tenant("solo", **PORT_TENANT_KW),
                       client_batching=batching)
    fab_hist = fab.run_trainers({"solo": tr})["solo"]
    assert tr.history == fab_hist and len(fab_hist) == 3
    assert tr.comm_bytes == solo.comm_bytes
    if batching == "off":
        assert fab_hist == hist
        assert _identical(tr, solo)
    else:
        assert_histories_match(hist, fab_hist)
        assert _rel_params_gap(tr, solo) < 2e-5
        waves = tr.batch_exec.stats.waves
        assert waves > solo.batch_exec.stats.waves == 3, waves


@pytest.mark.parametrize("fed_kw", [
    {},
    {"failure_rate": 0.4, "deadline_frac": 0.8, "over_select_frac": 0.5},
], ids=["plain", "failures_deadline"])
def test_two_tenants_match_reference(fed_kw):
    pairs, ref_hist, port_hist, _, _ = twin_fabric_trainers(**fed_kw)
    from repro.ckpt.checkpoint import _flatten as ref_flatten
    for tid, (ref, port) in pairs.items():
        assert len(port_hist[tid]) == 3
        assert_histories_match(ref_hist[tid], port_hist[tid])
        assert port.comm_bytes == ref.comm_bytes
        assert max_tree_diff(flatten(port.params),
                             ref_flatten(jax.device_get(ref.params))) < 2e-5
    if fed_kw:
        assert sum(h["failed"] for t in port_hist for h in port_hist[t]) > 0
        assert all(h["completed"] > 0 for t in port_hist for h in port_hist[t])


def test_two_tenant_counters_match_reference():
    """The obs plane's counters after the two-tenant run: the engine's,
    the trainer's (``fed.comm_bytes``) and the waves' (``client.batch_*``)
    in each tenant's scope."""
    _, _, _, ref_obs, port_obs = twin_fabric_trainers(obs=True)
    ref_c = ref_obs.registry.counters_snapshot()
    port_c = port_obs.registry.counters_snapshot()
    assert port_c == ref_c
    assert port_c["client.batch_waves"]["A"] > 3
    assert port_c["exec.spawns"]["B"] > 0


def test_eager_collection_trains_during_simulate():
    """Finishers train the moment their simulated COMPLETE fires: all but
    the last (its COMPLETE and the round close arrive in one engine step)
    while the round is still SIMULATE, and the count carries into COLLECT."""
    fab = PoolFabric(total_slots=32, capacity=100.0, lease_ttl=5.0)
    eng = fab.add_tenant("solo", **PORT_TENANT_KW)
    tr = _port_trainer(engine=eng, rounds=1)
    st = tr.begin_round()
    tr.step_round(st)
    tr.submit_round(st)
    fab._reconcile_pool()
    eager = 0
    while st.phase is RoundPhase.SIMULATE:
        if tr.collect_eager(st):
            eager += 1
        elif eng.peek_time() is not None:
            eng.step()
        else:
            break
    assert eager == FED_KW["participants_per_round"] - 1
    assert st.phase is RoundPhase.DISPATCH
    tr.step_round(st)
    assert st.collect_idx == eager
    while tr.step_round(st) is not RoundPhase.DONE:
        pass
    assert st.rec["completed"] == FED_KW["participants_per_round"]
    with pytest.raises(RuntimeError, match="submit_round"):
        tr.submit_round(st)


def test_eager_waves_drain_fired_completions():
    """``collect_wave_eager`` trains every client whose COMPLETE has fired
    as one wave; a wave of one client runs the sequential step."""
    fab = PoolFabric(total_slots=32, capacity=100.0, lease_ttl=5.0)
    eng = fab.add_tenant("solo", **PORT_TENANT_KW)
    tr = _port_trainer(engine=eng, rounds=1, client_batching="wave")
    st = tr.begin_round()
    tr.step_round(st)
    tr.submit_round(st)
    fab._reconcile_pool()
    sizes = []
    while st.phase is RoundPhase.SIMULATE:
        n = tr.collect_wave_eager(st)
        if n:
            sizes.append(n)
        elif eng.peek_time() is not None:
            eng.step()
        else:
            break
    assert sum(sizes) == st.collect_idx == len(st.trainable) - 1
    assert tr.collect_wave_eager(st) == 0      # no longer SIMULATE
    stats = tr.batch_exec.stats
    assert stats.waves == len(sizes) and stats.seq_clients == sizes.count(1)


def test_counters_continuous_across_resume(tmp_path):
    """Checkpoint meta carries the registry's counters and restore re-seeds
    them, so a resumed run's accounting continues instead of restarting."""
    obs = ObsPlane(trace=False)
    tr = _port_trainer(obs=obs, ckpt_dir=str(tmp_path), rounds=4)
    tr.run(2)
    comm_at_2 = tr.comm_bytes
    assert comm_at_2 > 0
    assert obs.registry.counter("fed.comm_bytes", "trainer").value == comm_at_2
    spawns_at_2 = obs.registry.counter("exec.spawns", "campaign").value

    obs2 = ObsPlane(trace=False)
    tr2 = _port_trainer(obs=obs2, ckpt_dir=str(tmp_path), rounds=4)
    assert obs2.registry.counter("fed.comm_bytes", "trainer").value == 0
    hist = tr2.run(2)
    assert tr2.round == 4
    assert obs2.registry.counter("fed.comm_bytes", "trainer").value == tr2.comm_bytes > comm_at_2
    assert obs2.registry.counter("exec.spawns", "campaign").value > spawns_at_2
    comms = [h["comm_bytes"] for h in hist]
    assert comms == sorted(comms) and comms[1] == comm_at_2


def test_two_tenants_interleave_wall_work():
    """Tenant A's ``client.train`` wall spans begin before tenant B's
    same-round ``round.aggregate`` ends, and the other way round."""
    obs = ObsPlane(trace=True)
    fab = PoolFabric(total_slots=32, capacity=100.0, lease_ttl=5.0, obs=obs)
    ta = _port_trainer(engine=fab.add_tenant("A", **PORT_TENANT_KW), obs=obs)
    tb = _port_trainer(engine=fab.add_tenant("B", **PORT_TENANT_KW), obs=obs, seed=7)
    hists = fab.run_trainers({"A": ta, "B": tb})
    assert len(hists["A"]) == 3 and len(hists["B"]) == 3

    def wall_spans(pid, name):
        return [(ev[7], ev[7] + ev[8], ev[9]) for ev in obs.tracer.events
                if ev[1] == name and ev[3] == pid and ev[7] is not None]

    for first, second in (("A", "B"), ("B", "A")):
        trains, aggs = wall_spans(first, "client.train"), wall_spans(second, "round.aggregate")
        assert trains and aggs
        assert any(t0 < a1 and targs["round"] == aargs["round"]
                   for t0, _, targs in trains for _, a1, aargs in aggs), (first, second)


def test_run_trainers_refuses_a_foreign_engine():
    fab = PoolFabric(total_slots=8)
    fab.add_tenant("A", **PORT_TENANT_KW)
    with pytest.raises(ValueError, match="tenant engine"):
        fab.run_trainers({"A": _port_trainer()})
    with pytest.raises(KeyError, match="unregistered"):
        fab.run_trainers({"Z": _port_trainer()})

