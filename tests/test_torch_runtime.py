"""The port's engine facades and runtime backends against the live
reference: ``RoundSimulator`` and ``ElasticRoundSimulator`` (pure Python:
spans, timelines, utilization and executor histories EQUAL),
``FedScaleEstimator`` (equal), and ``AnalyticalRuntime`` /
``compiled_cost``, whose counts come from another framework and are held
to stated gaps.

The FLOP gaps against the reference's XLA cost analysis, measured at the
paper's client widths (batch 16 and 64) and held here:

* mlp: the port counts 7.0 % (batch 16) to 2.1 % (batch 64) fewer FLOPs:
  ``FlopCounterMode`` counts matrix products only, XLA also the
  elementwise work (bias, ReLU, softmax, the update);
* cnn: 4.8-5.3 % more, resnet 4.6 % more: a 3x3 "SAME" convolution counts
  every tap here, the taps that fall on the zero padding too, and only the
  taps inside the image in XLA;
* lstm at seq_len 1: 18.5 % (batch 16) to 7.9 % (batch 64) fewer (the
  gates' elementwise work).  At longer sequences the two differ in kind:
  XLA's cost analysis counts the body of the ``lax.scan`` over time once,
  so the reference's count barely moves with seq_len, while the port
  counts every step.

Every workload is bytes-bound on the reference's v5e roofline (bf16 rate
for every FLOP).  On the port's H100 roofline, where these f32 steps run at
the FFMA rate (67 TFLOP/s), the mlp, cnn and lstm steps are bytes-bound and
the resnet step is FLOP-bound (about 5x its bytes time).  The reference's
byte count is XLA's after fusion, the port's the unfused eager work, so
seconds differ; their ORDER over the client workloads (mlp, cnn, resnet
and the LSTM at seq_len 1, at batch 16/32/48/64) is held exactly."""
import functools

import jax
import numpy as np
import pytest
import torch

import repro.core.elastic as ref_elastic
import repro.core.estimator as ref_estimator
import repro.core.scheduler as ref_scheduler
import repro.core.simulator as ref_simulator
import repro_torch.core.elastic as port_elastic
import repro_torch.core.estimator as port_estimator
import repro_torch.core.scheduler as port_scheduler
import repro_torch.core.simulator as port_simulator
from repro.core.budget import WorkloadSpec as RefWorkloadSpec
from repro.core.runtime import compiled_cost as ref_compiled_cost
from repro.fed.client import make_small_step as ref_make_small_step
from repro.models.small import SmallModelConfig as RefSmallModelConfig
from repro.models.small import init_small as ref_init_small
from repro.optim.optimizers import sgd as ref_sgd
from repro_torch.core import runtime
from repro_torch.core.budget import WorkloadSpec
from repro_torch.fed.client import batch_to, make_small_step
from repro_torch.models.small import SmallModelConfig, init_small
from repro_torch.optim.optimizers import sgd

from _torch_worlds import round_digest

PKGS = {"ref": (ref_simulator, ref_elastic, ref_scheduler),
        "port": (port_simulator, port_elastic, port_scheduler)}


def _both(fn):
    return fn(*PKGS["ref"]), fn(*PKGS["port"])


def _mgr_digest(mgr):
    return [(e.time, e.executor_id, e.kind.value, e.client_id) for e in mgr.table.history]


def _clients(sim_client, seed, n=30):
    rng = np.random.default_rng(seed)
    return [sim_client(i, float(rng.choice([5.0, 10.0, 25.0, 40.0, 60.0])),
                       float(rng.uniform(0.5, 5.0))) for i in range(n)]


# ------------------- the facades ---------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(sched="fedhc", theta=100.0),
    dict(sched="greedy", manager_mode="fixed", max_parallel=4),
    dict(sched="fedhc", theta=150.0, max_parallel=12),
    dict(sched="fedhc", theta=100.0, deadline=6.0, failures=True),
], ids=["hard_margin", "greedy_fixed", "soft_margin", "deadline_failures"])
def test_round_simulator_equals_reference(kw):
    def run(simulator, elastic, scheduler):
        kw2 = dict(kw)
        sched = scheduler.SCHEDULERS[kw2.pop("sched")]
        clients = _clients(simulator.SimClient, seed=3)
        if kw2.pop("failures", False):
            rng = np.random.default_rng(7)
            kw2["failure_times"] = {int(c): float(rng.uniform(0.2, 3.0))
                                    for c in rng.choice(len(clients), 5, replace=False)}
        res, mgr = simulator.RoundSimulator(sched, **kw2).run(clients)
        return round_digest(res), _mgr_digest(mgr)
    ref, port = _both(run)
    assert port == ref
    assert port[0][2] > 0


@pytest.mark.parametrize("theta_frac", [1.0, 1.5])
def test_elastic_round_simulator_equals_reference(theta_frac):
    def run(simulator, elastic, scheduler):
        events = [elastic.CapacityEvent(1.0, 50.0), elastic.CapacityEvent(2.5, 120.0),
                  elastic.CapacityEvent(4.0, 70.0)]
        sim = elastic.ElasticRoundSimulator(scheduler.FedHCScheduler, theta_frac=theta_frac,
                                            events=events, max_parallel=10)
        res, mgr = sim.run(_clients(simulator.SimClient, seed=4))
        return round_digest(res), _mgr_digest(mgr)
    ref, port = _both(run)
    assert port == ref


def test_fedscale_estimator_equals_reference():
    rng = np.random.default_rng(0)
    ref_est, port_est = ref_estimator.FedScaleEstimator(), port_estimator.FedScaleEstimator()
    for _ in range(50):
        wl = dict(model=str(rng.choice(["lstm", "cnn", "resnet", "mlp", "vit"])),
                  n_layers=int(rng.integers(1, 5)), seq_len=int(rng.integers(8, 128)),
                  batch_size=int(rng.choice([16, 32, 48, 64])), n_batches=int(rng.integers(1, 20)))
        speed = float(rng.uniform(0.05, 1.0))
        assert port_est.seconds(WorkloadSpec(**wl), speed) == \
            ref_est.seconds(RefWorkloadSpec(**wl), speed)


# ------------------- the analytical runtime ----------------------------------

#: the paper's client widths (phase 23's and phase 3's worlds)
PAPER_KW = {
    "mlp": dict(kind="mlp", n_classes=62, hidden=128, n_layers=2, image_size=28, channels=1),
    "cnn": dict(kind="cnn", n_classes=10, hidden=64, n_layers=2, image_size=32, channels=3),
    "resnet": dict(kind="resnet", n_classes=62, hidden=128, n_layers=2, image_size=28,
                   channels=1),
    "lstm": dict(kind="lstm", n_classes=2, hidden=64, n_layers=2, vocab_size=2048, seq_len=1,
                 embed_dim=64),
}
#: measured port/reference FLOP ratios at batch 16 and 64, each band the
#: measured range rounded out to the next 0.5 %
FLOP_RATIO = {"mlp": (0.925, 0.980), "cnn": (1.045, 1.055), "resnet": (1.045, 1.050),
              "lstm": (0.815, 0.925)}


def _batch(kw, bs, seed=0):
    rng = np.random.default_rng(seed)
    if kw["kind"] == "lstm":
        x = rng.integers(0, kw["vocab_size"], size=(bs, kw["seq_len"])).astype(np.int32)
    else:
        x = rng.normal(size=(bs, kw["image_size"], kw["image_size"], kw["channels"]))
        x = x.astype(np.float32)
    return {"x": x, "y": rng.integers(0, kw["n_classes"], size=bs).astype(np.int32)}


def _port_cost(kw, bs):
    """The port's StepCost of one sgd step, probed as the trainer probes it
    (a numpy batch, moved to the device inside the step)."""
    cfg, opt = SmallModelConfig(**kw), sgd(0.1)
    step, params = make_small_step(cfg, opt), init_small(0, cfg, device="cpu")
    cpu = torch.device("cpu")
    return runtime.compiled_cost(lambda p, o, b: step(p, o, batch_to(b, cpu), p)[0],
                                 params, opt.init(params), _batch(kw, bs))


@functools.lru_cache(maxsize=None)
def _cost_pair(kind, bs):
    """(reference StepCost, port StepCost) of one sgd step of ``kind`` at
    the paper's width and batch ``bs``."""
    kw = PAPER_KW[kind]
    cfg, opt = RefSmallModelConfig(**kw), ref_sgd(0.1)
    step, params = ref_make_small_step(cfg, opt), ref_init_small(jax.random.PRNGKey(0), cfg)
    return (ref_compiled_cost(lambda p, o, b: step(p, o, b, p)[0],
                              params, opt.init(params), _batch(kw, bs)),
            _port_cost(kw, bs))


def _costs(kind, batch_sizes):
    return {bs: _cost_pair(kind, bs) for bs in batch_sizes}


@pytest.mark.parametrize("kind", ["mlp", "cnn", "resnet", "lstm"])
def test_compiled_cost_flops_within_the_stated_gap(kind):
    lo, hi = FLOP_RATIO[kind]
    for bs, (ref, port) in _costs(kind, (16, 64)).items():
        assert lo <= port.flops / ref.flops <= hi, (kind, bs, port.flops, ref.flops)
        assert port.bytes_accessed > 0


def test_analytical_runtime_ranks_workloads_as_reference():
    """Seconds at full capacity of one step for every client kind (the
    LSTM at seq_len 1, where XLA's count covers its whole recurrence) at
    batch 16/32/48/64, each package on its own card's roofline: the same
    order."""
    ref_rt = {"peak": 197e12, "bw": 819e9}     # the reference's v5e defaults
    rows = []
    for kind in ("mlp", "cnn", "resnet", "lstm"):
        for bs, (ref, port) in _costs(kind, (16, 32, 48, 64)).items():
            rows.append(((kind, bs),
                         ref.seconds_at_full(1, ref_rt["peak"], ref_rt["bw"]),
                         port.seconds_at_full()))
    ref_order = [k for k, _, _ in sorted(rows, key=lambda r: r[1])]
    port_order = [k for k, _, _ in sorted(rows, key=lambda r: r[2])]
    assert port_order == ref_order
    assert len(set(r[2] for r in rows)) == len(rows)


def test_lstm_count_grows_with_every_timestep():
    """The port counts every step of the recurrence: past the first step
    (whose recurrent product has no gradient), the count is affine in
    seq_len, where the reference's XLA count covers one iteration of its
    scan."""
    f = {s: _port_cost(dict(PAPER_KW["lstm"], seq_len=s), 32).flops for s in (2, 4, 8)}
    assert f[8] - f[4] == 2 * (f[4] - f[2]) > 0, f


def test_compiled_cost_runs_nothing_and_ignores_the_device():
    x = torch.ones((128, 96))
    w = torch.ones((96, 64))
    cost = runtime.compiled_cost(lambda a, b: a @ b, x, w)
    assert cost.flops == 2 * 128 * 96 * 64
    assert cost.bytes_accessed == 4 * (128 * 96 + 96 * 64 + 128 * 64)
    meta = runtime.compiled_cost(lambda a, b: a @ b, x.to("meta"), w.to("meta"))
    host = runtime.compiled_cost(lambda a, b: a @ b, x.numpy().astype(np.float64), w.numpy())
    assert meta == cost == host

    def moves_then_runs(a):
        return (a.to("cpu") * 2.0).sum()     # a device move is not the step's work
    assert runtime.compiled_cost(moves_then_runs, x).bytes_accessed == \
        runtime.compiled_cost(lambda a: (a * 2.0).sum(), x).bytes_accessed


def test_analytical_runtime_uses_h100_constants_and_memoizes():
    assert (runtime.PEAK_FLOPS_BF16, runtime.PEAK_FLOPS_F32, runtime.HBM_BW) == \
        (989e12, 67e12, 3.35e12)
    rt = runtime.AnalyticalRuntime()
    calls = []

    def f(a):
        calls.append(1)
        return a @ a
    x = torch.ones((256, 256))
    t = rt.seconds_at_full("k", f, (x,), n_steps=3)
    cost = runtime.StepCost(flops=2 * 256 ** 3, bytes_accessed=3 * 4 * 256 * 256)
    assert t == 3 * max(cost.flops / 67e12, cost.bytes_accessed / 3.35e12)
    assert rt.seconds_at_full("k", f, (x,)) == t / 3 and len(calls) == 1
    t_big = rt.seconds_at_full("b", lambda a: (a @ a) @ (a @ a), (x,))
    assert t_big > t / 3


@pytest.mark.parametrize("dtype, half", [(torch.float32, False), (torch.bfloat16, True),
                                         (torch.float16, True)])
def test_compiled_cost_times_each_product_at_its_dtypes_rate(dtype, half):
    """A bf16/fp16 product counts at the tensor cores' rate, an f32 one at
    the FFMA rate; a step that does both adds the two times."""
    n = 1024
    x = torch.ones((n, n), dtype=dtype)
    cost = runtime.compiled_cost(lambda a: a @ a, x)
    assert cost.flops == 2 * n ** 3
    assert cost.half_flops == (cost.flops if half else 0.0)
    peak = runtime.PEAK_FLOPS_BF16 if half else runtime.PEAK_FLOPS_F32
    assert cost.seconds_at_full() == max(cost.flops / peak, cost.bytes_accessed / 3.35e12)
    mixed = runtime.compiled_cost(lambda a, b: (a @ a, b @ b), x, x.float())
    assert mixed.flops == 2 * cost.flops
    assert mixed.half_flops == (cost.flops if half else 0.0)
    assert mixed.seconds_at_full() == pytest.approx(
        cost.flops / peak + cost.flops / runtime.PEAK_FLOPS_F32, rel=1e-12)
