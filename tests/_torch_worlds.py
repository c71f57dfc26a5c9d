"""Twin worlds for the port's parity tests: the same numpy data and seeds
built once as reference (``repro``) objects and once as port
(``repro_torch``) objects, so both packages see identical batches."""
import jax
import numpy as np
import pytest

from repro.core.budget import WorkloadSpec as RefWorkloadSpec
from repro.core.runtime import FixedRuntime as RefFixedRuntime
from repro.data.pipeline import ClientDataset as RefClientDataset
from repro.fed.client import FLClient as RefFLClient
from repro.fed.trainer import FedConfig as RefFedConfig
from repro.fed.trainer import FederatedTrainer as RefFederatedTrainer
from repro.models.small import SmallModelConfig as RefSmallModelConfig
from repro_torch.bridge import params_from_numpy
from repro_torch.core.budget import WorkloadSpec
from repro_torch.core.runtime import FixedRuntime
from repro_torch.data.pipeline import ClientDataset
from repro_torch.fed.client import FLClient
from repro_torch.fed.trainer import FedConfig, FederatedTrainer
from repro_torch.models.small import SmallModelConfig

#: the test-size FEMNIST-style MLP: 8x8 images, hidden 16, two layers
MCFG_KW = dict(kind="mlp", hidden=16, n_layers=2, image_size=8, channels=1,
               n_classes=10)
REF_MCFG = RefSmallModelConfig(**MCFG_KW)
MCFG = SmallModelConfig(**MCFG_KW)

#: each client model at test size: 8x8 images, hidden 8-16, vocab 32, seq 6
KIND_KW = {
    "mlp": MCFG_KW,
    "cnn": dict(kind="cnn", hidden=16, n_layers=2, image_size=8, channels=3, n_classes=10),
    "resnet": dict(kind="resnet", hidden=8, n_layers=2, image_size=8, channels=1,
                   n_classes=10),
    "lstm": dict(kind="lstm", hidden=8, n_layers=2, vocab_size=32, seq_len=6,
                 embed_dim=8, n_classes=2),
}


def kind_cfgs(kind, **kw):
    """(reference config, port config) of ``kind`` at test size, with ``kw``
    replacing fields."""
    fields = dict(KIND_KW[kind], **kw)
    return RefSmallModelConfig(**fields), SmallModelConfig(**fields)


def client_arrays(batch_sizes, seed=0, samples_per_client=16, mcfg=MCFG):
    """Per-client (x, y) numpy shards, made from ``seed``: NHWC images, or
    int32 tokens for the lstm."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in batch_sizes:
        if mcfg.kind == "lstm":
            x = rng.integers(0, mcfg.vocab_size,
                             size=(samples_per_client, mcfg.seq_len)).astype(np.int32)
        else:
            x = rng.normal(size=(samples_per_client, mcfg.image_size, mcfg.image_size,
                                 mcfg.channels)).astype(np.float32)
        y = rng.integers(0, mcfg.n_classes, size=samples_per_client).astype(np.int32)
        out.append((x, y))
    return out


def twin_clients(batch_sizes, seed=0, budgets=None, samples_per_client=16,
                 n_batches=10, mcfg=MCFG, scales=None):
    """(reference clients, port clients) over identical shards and seeds;
    ``scales`` multiplies each client's inputs (image kinds)."""
    arrays = client_arrays(batch_sizes, seed, samples_per_client, mcfg)
    budgets = budgets or [100.0] * len(batch_sizes)
    scales = scales or [1.0] * len(batch_sizes)
    ref, port = [], []
    for i, ((x, y), bs, b, sc) in enumerate(zip(arrays, batch_sizes, budgets, scales)):
        if sc != 1.0:
            x = (x * np.float32(sc)).astype(x.dtype)
        wl = dict(model=mcfg.kind, n_layers=mcfg.n_layers, batch_size=bs,
                  n_batches=n_batches, extra_local_model=mcfg.extra_local_model)
        ref.append(RefFLClient(i, b, RefClientDataset(x, y, bs, seed=seed + i),
                               RefWorkloadSpec(**wl)))
        port.append(FLClient(i, b, ClientDataset(x, y, bs, seed=seed + i),
                             WorkloadSpec(**wl)))
    return ref, port


def max_tree_diff(a, b):
    """Largest |a - b| over the leaves of two trees given as path dicts."""
    assert a.keys() == b.keys(), (sorted(a), sorted(b))
    return max(float(np.max(np.abs(np.asarray(a[k], np.float32)
                                    - np.asarray(b[k], np.float32)))) for k in a)


def ref_noise(seed, index, shape):
    """The reference's int8 rounding noise, ``uniform(fold_in(PRNGKey(seed),
    index))``, for the port's noise seam."""
    return np.asarray(jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(seed), index),
                                         shape))


#: the trainer worlds: six clients, mixed per-step batch sizes and budgets
BATCH_SIZES = [2, 4, 6, 8, 3, 5]
BUDGETS = [10.0, 25.0, 40.0, 55.0, 70.0, 30.0]
EQUAL_FIELDS = ("round", "duration", "sim_clock", "completed", "mode", "failed",
                "avg_parallelism", "utilization", "comm_bytes", "test_acc")


def eval_batch(seed=99, n=64, mcfg=MCFG):
    x, y = client_arrays([n], seed, samples_per_client=n, mcfg=mcfg)[0]
    return {"x": x, "y": y}


def twin_trainers(ref_mcfg=REF_MCFG, mcfg=MCFG, batch_sizes=BATCH_SIZES, ref_kw=(),
                   port_kw=(), clients=None, ref_ctor=(), port_ctor=(), **fed_kw):
    """(reference trainer, port trainer) on twin worlds from the same initial
    params; ``ref_kw`` / ``port_kw`` are one package's own FedConfig fields,
    ``clients`` a (reference, port) pair of client lists to reuse, and
    ``ref_ctor`` / ``port_ctor`` more constructor arguments (``engine``,
    ``obs``)."""
    ref_cl, port_cl = clients or twin_clients(batch_sizes, seed=4, budgets=BUDGETS, mcfg=mcfg)
    kw = dict(rounds=3, participants_per_round=4, local_steps=2,
              learning_rate=0.2, client_batching="wave")
    kw.update(fed_kw)
    test = eval_batch(mcfg=mcfg)
    ref = RefFederatedTrainer(ref_mcfg, ref_cl, RefFedConfig(**kw, **dict(ref_kw)),
                              test_batch=test, runtime=RefFixedRuntime(2.0, 1.0),
                              **dict(ref_ctor))
    port = FederatedTrainer(mcfg, port_cl, FedConfig(**kw, **dict(port_kw)), test_batch=test,
                            runtime=FixedRuntime(2.0, 1.0), device="cpu", noise=ref_noise,
                            **dict(port_ctor))
    port.params = params_from_numpy(jax.device_get(ref.params), "cpu")
    return ref, port


def assert_histories_match(ref_hist, port_hist, tol=1e-5):
    assert len(ref_hist) == len(port_hist)
    for r, p in zip(ref_hist, port_hist):
        assert r.keys() == p.keys()
        for k in EQUAL_FIELDS:
            assert p[k] == r[k], (k, p[k], r[k])
        for k in r:
            if k.startswith("train_") or k == "test_loss":
                assert p[k] == pytest.approx(r[k], abs=tol), k


def round_digest(r):
    """Everything a ``RoundResult`` holds, and its derived statistics."""
    return (r.duration, r.start, r.completed, list(r.failed), r.mode,
            {c: (s.start, s.end, s.budget) for c, s in r.spans.items()},
            [(g.t0, g.t1, g.total_budget, g.total_rate, g.parallelism) for g in r.timeline],
            r.utilization(), r.avg_parallelism(), r.avg_admitted_budget())


def campaign_digest(res):
    """Everything a ``CampaignResult`` holds, round by round."""
    return (res.duration, res.total_completed, res.total_failed, res.churn_evictions,
            res.events_processed, res.utilization(), [round_digest(r) for r in res.rounds])


def engine_digest(eng):
    """The engine's clock, counters and executor event history."""
    return (eng.now, eng.capacity, eng.events_processed, eng.churn_evictions,
            eng.capacity_evictions, eng.preemptions,
            [(e.time, e.executor_id, e.kind.value, e.client_id)
             for e in eng.mgr.table.history])


def twin_fabric_trainers(obs=False, **fed_kw):
    """The same two-tenant fabric in each package, run by ``run_trainers``:
    A (weight 3) batches its waves, B (weight 1) trains clients one at a
    time with another seed and world.  The tenants of both packages carry
    their control-plane mirror, as the reference's tests do; it does not
    feed the timeline.
    Returns ({tenant: (ref trainer, port trainer)}, ref histories, port
    histories, ref obs plane, port obs plane)."""
    from repro.core.fabric import PoolFabric as RefPoolFabric
    from repro.obs import ObsPlane as RefObsPlane
    from repro_torch.core.fabric import PoolFabric
    from repro_torch.obs import ObsPlane

    lean = dict(record_campaign_timeline=False, record_events=False)
    ref_obs, port_obs = (RefObsPlane(trace=True), ObsPlane(trace=True)) if obs else (None, None)
    ref_fab = RefPoolFabric(total_slots=8, capacity=100.0, lease_ttl=2.0, obs=ref_obs)
    port_fab = PoolFabric(total_slots=8, capacity=100.0, lease_ttl=2.0, obs=port_obs)
    pairs = {}
    for tid, weight, kw in (("A", 3.0, dict(client_batching="wave")),
                            ("B", 1.0, dict(client_batching="off", seed=7))):
        clients = twin_clients(BATCH_SIZES, seed=4 + int(weight), budgets=BUDGETS[::-1])
        pairs[tid] = twin_trainers(
            clients=clients,
            ref_ctor=dict(engine=ref_fab.add_tenant(tid, weight=weight, mirror=True, **lean),
                          obs=ref_obs),
            port_ctor=dict(engine=port_fab.add_tenant(tid, weight=weight, mirror=True, **lean),
                           obs=port_obs),
            **dict(kw, **fed_kw))
    ref_hist = ref_fab.run_trainers({t: p[0] for t, p in pairs.items()})
    port_hist = port_fab.run_trainers({t: p[1] for t, p in pairs.items()})
    return pairs, ref_hist, port_hist, ref_obs, port_obs
