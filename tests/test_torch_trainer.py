"""The port's FederatedTrainer against the reference's: 3 rounds of ragged
waves (mixed batch sizes) with a deterministic runtime, starting from the
reference trainer's own initial params.  Engine-derived history fields must
be EQUAL (the engine is a pure-Python copy fed identical works); losses and
params agree within 1e-5.  The reference runs with its control-plane mirror
on (its default), the port without one: the mirror replays transitions and
does not feed the timeline."""
import jax
import numpy as np
import pytest

from repro.ckpt.checkpoint import _flatten as ref_flatten
from repro.core.campaign import CampaignEngine as RefCampaignEngine
from repro.core.runtime import FixedRuntime as RefFixedRuntime
from repro.core.scheduler import SCHEDULERS as REF_SCHEDULERS
from repro.core.simulator import SimClient as RefSimClient
from repro.fed.trainer import FedConfig as RefFedConfig
from repro.fed.trainer import FederatedTrainer as RefFederatedTrainer
from repro_torch.bridge import flatten, params_from_numpy
from repro_torch.core.campaign import CampaignEngine
from repro_torch.core.runtime import FixedRuntime
from repro_torch.core.scheduler import SCHEDULERS
from repro_torch.core.simulator import SimClient
from repro_torch.fed.trainer import FedConfig, FederatedTrainer

from _torch_worlds import MCFG, REF_MCFG, max_tree_diff, twin_clients

BATCH_SIZES = [2, 4, 6, 8, 3, 5]
BUDGETS = [10.0, 25.0, 40.0, 55.0, 70.0, 30.0]
EQUAL_FIELDS = ("round", "duration", "sim_clock", "completed", "mode", "failed",
                "avg_parallelism", "utilization", "comm_bytes", "test_acc")


def _test_batch(seed=99, n=64):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(n, 8, 8, 1)).astype(np.float32),
            "y": rng.integers(0, 10, size=n).astype(np.int32)}


def _twin_trainers(**fed_kw):
    ref_cl, port_cl = twin_clients(BATCH_SIZES, seed=4, budgets=BUDGETS)
    kw = dict(rounds=3, participants_per_round=4, local_steps=2,
              learning_rate=0.2, client_batching="wave")
    kw.update(fed_kw)
    ref = RefFederatedTrainer(REF_MCFG, ref_cl, RefFedConfig(**kw),
                              test_batch=_test_batch(),
                              runtime=RefFixedRuntime(2.0, 1.0))
    port = FederatedTrainer(MCFG, port_cl, FedConfig(**kw), test_batch=_test_batch(),
                            runtime=FixedRuntime(2.0, 1.0), device="cpu")
    port.params = params_from_numpy(jax.device_get(ref.params), "cpu")
    return ref, port


@pytest.mark.parametrize("fed_kw", [
    {"aggregation": "fedavg"},
    {"aggregation": "fedavg", "client_batching": "off"},
    {"aggregation": "async", "async_buffer": 3},
    # over-selection, failures and a deadline: the fault-tolerance path
    {"aggregation": "fedavg", "over_select_frac": 0.5, "failure_rate": 0.3,
     "deadline_frac": 0.9},
], ids=["fedavg", "per_client", "async", "faults"])
def test_three_rounds_match_reference(fed_kw):
    ref, port = _twin_trainers(**fed_kw)
    ref_hist, port_hist = ref.run(), port.run()
    assert len(ref_hist) == len(port_hist) == 3
    for r, p in zip(ref_hist, port_hist):
        assert r.keys() == p.keys()
        for k in EQUAL_FIELDS:
            assert p[k] == r[k], (k, p[k], r[k])
        for k in r:
            if k.startswith("train_") or k == "test_loss":
                assert p[k] == pytest.approx(r[k], abs=1e-5), k
    if port.batch_exec is not None:
        assert port.batch_exec.stats.ragged_clients > 0
    assert port.comm_bytes == ref.comm_bytes
    assert max_tree_diff(flatten(port.params),
                         ref_flatten(jax.device_get(ref.params))) < 1e-5


def _round_digest(r):
    return (r.duration, r.start, r.completed, sorted(r.failed),
            {c: (s.start, s.end, s.budget) for c, s in r.spans.items()},
            r.utilization(), r.avg_parallelism(), r.avg_admitted_budget())


def _engine_world(seed=0, n=40):
    rng = np.random.default_rng(seed)
    works = rng.uniform(1.0, 5.0, size=n)
    budgets = rng.choice([5.0, 10.0, 25.0, 40.0, 60.0], size=n)
    fail = {int(i): float(rng.uniform(0.5, 3.0)) for i in rng.choice(n, 6, replace=False)}
    return [(i, float(b), float(w)) for i, (b, w) in enumerate(zip(budgets, works))], fail


def _scenario_soft_margin_faults(pkg):
    Engine, Sim, scheds = pkg[:3]
    clients, fail = _engine_world(0)
    eng = Engine(scheds["fedhc"], theta=140.0, max_parallel=12)
    cl = [Sim(*c) for c in clients]
    rounds = [eng.run_round(cl, deadline=60.0, failure_times=fail), eng.run_round(cl[:20])]
    return eng, rounds


def _scenario_churn_async_capacity(pkg):
    Engine, Sim, scheds, Trace, Capacity = pkg
    clients, _ = _engine_world(1)
    trace = Trace.periodic([c[0] for c in clients[::2]], period=6.0, duty=0.6,
                           horizon=500.0, seed=3)
    eng = Engine(scheds["fedhc"], theta=100.0, max_parallel=10, availability=trace,
                 async_rounds=True,
                 capacity_events=[Capacity(4.0, 60.0, theta=60.0),
                                  Capacity(15.0, 100.0, theta=100.0)])
    res = eng.run_campaign([[Sim(*c) for c in clients[k::3]] for k in range(3)])
    return eng, res.rounds


def _scenario_greedy(pkg):
    Engine, Sim, scheds = pkg[:3]
    clients, fail = _engine_world(2)
    eng = Engine(scheds["greedy"], theta=100.0, max_parallel=8, manager_mode="fixed")
    return eng, [eng.run_round([Sim(*c) for c in clients], failure_times=fail)]


@pytest.mark.parametrize("scenario", [_scenario_soft_margin_faults,
                                      _scenario_churn_async_capacity, _scenario_greedy],
                         ids=["soft_margin_faults", "churn_async_capacity", "greedy"])
def test_engine_copy_reproduces_reference_timelines(scenario):
    """The port's engine copy gives the reference's timelines exactly:
    soft-margin sharing, failures and deadlines; availability churn, async
    round boundaries and capacity events; the greedy baseline."""
    from repro.core.campaign import AvailabilityTrace as RefTrace
    from repro.core.campaign import CapacityEvent as RefCapacity
    from repro_torch.core.campaign import AvailabilityTrace, CapacityEvent

    out = []
    for pkg in ((RefCampaignEngine, RefSimClient, REF_SCHEDULERS, RefTrace, RefCapacity),
                (CampaignEngine, SimClient, SCHEDULERS, AvailabilityTrace, CapacityEvent)):
        eng, rounds = scenario(pkg)
        out.append(([_round_digest(r) for r in rounds], eng.now, eng.events_processed,
                    eng.churn_evictions, eng.capacity_evictions,
                    [(e.time, e.executor_id, e.kind.value, e.client_id)
                     for e in eng.mgr.table.history]))
    assert out[0] == out[1]
    assert out[1][2] > 0


@pytest.mark.parametrize("fed_kw", [{"compression": "int8"}, {"ckpt_dir": "ckpt"}])
def test_unported_trainer_options_raise(fed_kw):
    _, port_cl = twin_clients([2], seed=0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FederatedTrainer(MCFG, port_cl, FedConfig(**fed_kw), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FederatedTrainer(MCFG, port_cl, FedConfig(), device="cpu", obs=object())
