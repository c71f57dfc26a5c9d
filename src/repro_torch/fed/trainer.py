"""End-to-end federated trainer: server loop + FedHC resource simulation.

The port of ``repro.fed.trainer``.  Each global round is an explicit phased
state machine (:class:`RoundPhase`):

  ``SAMPLE``    sample participants (with optional over-selection), obtain
                each one's *framework-provided* runtime (measured wall
                clock of its real train step on the device, or a fixed
                backend), draw failure times and the deadline;
  ``SIMULATE``  drive the FedHC campaign engine (scheduler + process
                manager + sharing under one continuous clock) to get the
                round's simulated timeline;
  ``DISPATCH``  pick the round's finishers;
  ``COLLECT``   run the *actual* local training — one finisher per step,
                or with ``client_batching="wave"`` every finisher in one
                :class:`~repro_torch.fed.batch_exec.BatchedExecutor` wave,
                so a fabric can interleave this wall-clock work with other
                tenants' phases;
  ``AGGREGATE`` sync weighted FedAvg, or FedBuff-style async ordered by
                simulated completion times, with optional uplink
                compression (int8 / topk);
  ``REPORT``    evaluate, record history, checkpoint (atomic, keep-k,
                resumable: ``maybe_restore``).

``run_round()`` loops :meth:`FederatedTrainer.step_round` until the round
is ``DONE``.  A ``repro_torch.core.fabric.PoolFabric`` can instead drive
the phases itself (``PoolFabric.run_trainers``): the trainer enqueues its
round spec (:meth:`submit_round`), subscribes to the engine's
round-boundary callbacks, trains each finisher as soon as its simulated
COMPLETE fires (:meth:`collect_eager`, :meth:`collect_wave_eager`), and the
fabric's merged event loop invokes the wall-clock phase steps between
simulated events so N trainer tenants interleave.  The simulated clock is
the x-axis of the convergence figures (Fig 8/9d); failure injection +
deadline + over-selection exercise the fault-tolerance path (clients that
die are simply absent from aggregation).

With ``obs=`` (``repro_torch.obs.ObsPlane``) the trainer counts
``fed.comm_bytes``, ``client.train_seconds`` and ``round.degraded`` in its
tenant's scope, and traces ``client.train``, ``client.batch_wave`` and
``round.aggregate`` on the wall clock.  A wall span closes after the card
has finished its work: every collect path ends by bringing the metrics to
the host (``float`` / ``.cpu()``), which waits for the work queued before
it, and the aggregate, which reads nothing back, synchronizes the card
when it is traced.

Still to port: remote dispatch (a control-plane dispatcher); asking for it
raises.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.core.aggregation import AsyncAggregator, apply_deltas, tree_nbytes
from repro_torch.core.budget import ClientBudget, WorkloadSpec
from repro_torch.core.campaign import CampaignEngine, RoundSpec
from repro_torch.core.runtime import MeasuredRuntime
from repro_torch.core.scheduler import SCHEDULERS
from repro_torch.core.simulator import RoundResult, SimClient
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.pipeline import ClientDataset
from repro_torch.data.synthetic import make_dataset
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fed.batch_exec import BatchedExecutor
from repro_torch.fed.client import FLClient, batch_to, make_small_step
from repro_torch.fed.compression import Noise, compress_tree, decompress_tree, tree_wire_bytes
from repro_torch.models.small import SmallModelConfig, init_small, small_loss
from repro_torch.obs.metrics import Counter
from repro_torch.optim.optimizers import make_optimizer

PyTree = Any


@dataclass
class FedConfig:
    rounds: int = 20
    participants_per_round: int = 10
    local_steps: int = 10
    scheduler: str = "fedhc"            # fedhc | greedy
    theta: float = 100.0                # >100 enables soft-margin sharing
    manager_mode: str = "dynamic"       # dynamic | fixed
    max_parallel: int = 32
    aggregation: str = "fedavg"         # fedavg | async
    async_buffer: int = 4
    server_lr: float = 1.0
    prox_mu: float = 0.0
    optimizer: str = "sgd"
    learning_rate: float = 0.05
    compression: str = "none"           # none | int8 | topk
    client_batching: str = "off"        # off | wave (batched COLLECT)
    over_select_frac: float = 0.0       # fault tolerance: sample extra clients
    deadline_frac: Optional[float] = None  # deadline = frac × slowest expected
    failure_rate: float = 0.0           # P(client dies mid-round)
    seed: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 5


class RoundPhase(Enum):
    """States of the per-round trainer state machine.  Transitions are
    strictly forward (SAMPLE → … → DONE); every phase step is resumable,
    so an external driver (the fabric) can interleave steps of N trainers.
    """

    SAMPLE = "sample"          # wall clock: runtime probes, RNG draws
    SIMULATE = "simulate"      # simulated clock: the engine's event loop
    DISPATCH = "dispatch"      # wall clock: finisher pick
    COLLECT = "collect"        # wall clock: real local training
    AGGREGATE = "aggregate"    # wall clock: FedAvg / async apply
    REPORT = "report"          # wall clock: eval, history, checkpoint
    DONE = "done"


@dataclass
class RoundState:
    """Mutable per-round state threaded through the phase steps.  One
    round in flight per trainer; ``run_round`` owns it, or the fabric's
    trainer driver when the fabric owns the clock."""

    phase: RoundPhase = RoundPhase.SAMPLE
    participants: List[FLClient] = field(default_factory=list)
    by_id: Dict[int, FLClient] = field(default_factory=dict)
    works: Dict[int, float] = field(default_factory=dict)
    failure_times: Dict[int, float] = field(default_factory=dict)
    deadline: Optional[float] = None
    result: Optional[RoundResult] = None
    engine_round_idx: Optional[int] = None   # set by submit_round (fabric)
    finishers: List[Tuple[int, Any]] = field(default_factory=list)
    trainable: List[int] = field(default_factory=list)  # eager-collect queue
    mode: str = "FULL"
    deltas: List[Tuple[PyTree, float]] = field(default_factory=list)
    train_metrics: Dict[str, float] = field(default_factory=dict)
    collect_idx: int = 0                     # finishers collected so far
    rec: Optional[dict] = None               # the round's history record


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, queue 1 row 6: multihost)")


class FederatedTrainer:
    def __init__(
        self,
        mcfg: SmallModelConfig,
        clients: Sequence[FLClient],
        fed: FedConfig,
        test_batch: Optional[Dict[str, np.ndarray]] = None,
        engine: Optional[CampaignEngine] = None,
        runtime=None,
        dispatcher=None,
        obs=None,
        *,
        device: DeviceLike = None,
        noise: Optional[Noise] = None,
    ):
        """``engine`` (optional) is a tenant handle: a fabric tenant's
        engine (``PoolFabric.add_tenant``) shares its slot pool with other
        jobs, and fed.scheduler/theta/manager_mode/max_parallel are then
        the engine's, not this config's.  ``runtime`` (optional) overrides
        the framework-provided runtime backend (default:
        ``MeasuredRuntime`` on ``device``; inject ``FixedRuntime`` to make
        the simulated timeline reproducible across hosts, or
        ``AnalyticalRuntime`` for the card's roofline).  ``obs`` is an
        observability plane.  ``device`` defaults to the CUDA card.
        ``noise`` is int8 compression's rounding noise
        (``repro_torch.fed.compression``; default: a ``torch.Generator`` on
        the device)."""
        if dispatcher is not None:
            raise _not_ported("remote dispatch")
        if fed.client_batching not in ("off", "wave"):
            raise ValueError(f"unknown client_batching {fed.client_batching!r}")
        self.device = resolve_device(device)
        self.mcfg = mcfg
        self.clients = list(clients)
        self.fed = fed
        self.test_batch = (batch_to(test_batch, self.device)
                           if test_batch is not None else None)
        self.rng = np.random.default_rng(fed.seed)
        self.runtime = runtime if runtime is not None else MeasuredRuntime(self.device)
        self.noise = noise
        self.opt = make_optimizer(fed.optimizer, fed.learning_rate)
        self.step_fn = make_small_step(mcfg, self.opt, fed.prox_mu)
        self.params = init_small(fed.seed, mcfg, device=self.device)
        self.sim_clock = 0.0
        self.round = 0
        self.obs = obs
        self._subscribed = False         # engine round-boundary callbacks
        self._active_st: Optional[RoundState] = None  # submitted round
        # identity on the shared obs plane: spans land on a per-tenant
        # track and metrics in a per-tenant scope.  An injected fabric
        # engine names the tenant; the engine default ("campaign") and the
        # no-engine case keep the "trainer" identity.
        tenant = getattr(engine, "tenant", None) if engine is not None else None
        self.tenant = "trainer" if tenant in (None, "campaign") else tenant
        self._trace = (obs.tracer if obs is not None and obs.tracer.enabled
                       else None)
        # aggregation-payload bytes (the deltas as uploaded)
        self._comm = (obs.registry.counter("fed.comm_bytes", self.tenant)
                      if obs is not None else Counter())
        self._h_train = (obs.registry.histogram("client.train_seconds",
                                                self.tenant)
                         if obs is not None else None)
        # rounds closed DEGRADED: only a quorum-closing dispatcher (row 6)
        # degrades a round, so it stays at zero here
        self._m_degraded = (obs.registry.counter("round.degraded",
                                                 self.tenant)
                            if obs is not None else Counter())
        self.history: List[dict] = []
        self.async_agg = AsyncAggregator(
            buffer_size=fed.async_buffer, server_lr=fed.server_lr
        )
        # one campaign engine for the whole run: continuous simulated clock
        # across rounds, executor pool persists.  An injected engine is a
        # fabric tenant's: this trainer then draws executors through the
        # arbiter's lease.
        self.engine = engine if engine is not None else CampaignEngine(
            SCHEDULERS[fed.scheduler],
            theta=fed.theta,
            manager_mode=fed.manager_mode,
            max_parallel=fed.max_parallel,
            obs=obs,
            # lifelong engine: per-round timelines feed the history records,
            # but the campaign-global timeline and executor event history
            # would grow without bound over a long training run
            record_campaign_timeline=False,
            record_events=False,
        )
        self.batch_exec = (
            BatchedExecutor(mcfg, self.opt, fed.prox_mu, device=self.device,
                            obs=obs, tenant=self.tenant)
            if fed.client_batching == "wave" else None
        )
        self.ckpt = (
            CheckpointManager(fed.ckpt_dir, keep=3) if fed.ckpt_dir else None
        )

    @property
    def comm_bytes(self) -> int:
        return int(self._comm.value)

    @comm_bytes.setter
    def comm_bytes(self, v: int) -> None:
        self._comm.reset(int(v))

    # ------------------------------------------------------------------
    def _client_work_seconds(self, client: FLClient, opt_state) -> float:
        """Framework-provided runtime: time one real step (host→device copy
        of the batch included), scale by the client's data volume (steps).
        The key holds plain ints and tuples, as the reference's does."""
        wl = client.workload
        batch = client.data.next_batch()
        key = (self.mcfg.kind, wl.n_layers, wl.seq_len, wl.batch_size,
               self.mcfg.extra_local_model, tuple(batch["x"].shape))
        dev = self.device
        return self.runtime.seconds_at_full(
            key,
            lambda p, o, b: self.step_fn(p, o, batch_to(b, dev), p)[0],
            (self.params, opt_state, batch),
            n_steps=wl.n_batches,
        )

    def _sample(self) -> List[FLClient]:
        n = self.fed.participants_per_round
        n_sel = min(len(self.clients), int(np.ceil(n * (1 + self.fed.over_select_frac))))
        idx = self.rng.choice(len(self.clients), size=n_sel, replace=False)
        return [self.clients[i] for i in idx]

    # ------------------------------------------------------------------
    # The phased round state machine: each _step_* method performs one
    # resumable unit of work and advances st.phase.
    # ------------------------------------------------------------------

    def begin_round(self) -> RoundState:
        return RoundState()

    def step_round(self, st: RoundState) -> RoundPhase:
        """Execute the next phase step of the round; returns the phase the
        round is in afterwards.  Per-client COLLECT consumes one step per
        finisher, so a driver calling ``step_round`` repeatedly makes
        incremental wall-clock progress it can interleave with other work."""
        if st.phase is not RoundPhase.DONE:
            self._PHASE_STEPS[st.phase](self, st)
        return st.phase

    def _step_sample(self, st: RoundState) -> None:
        fed = self.fed
        st.participants = self._sample()
        # one probe opt-state for the whole round
        probe_opt_state = self.opt.init(self.params)
        st.works = {c.client_id: self._client_work_seconds(c, probe_opt_state)
                    for c in st.participants}
        st.by_id = {c.client_id: c for c in st.participants}

        # failure injection: each selected client may die partway through
        st.failure_times = {}
        for c in st.participants:
            if self.rng.random() < fed.failure_rate:
                frac = self.rng.uniform(0.1, 0.9)
                st.failure_times[c.client_id] = (
                    frac * st.works[c.client_id] / (c.budget / 100.0)
                )

        st.deadline = None
        if fed.deadline_frac is not None:
            worst = max(st.works[c.client_id] / (c.budget / 100.0)
                        for c in st.participants)
            st.deadline = fed.deadline_frac * worst
        st.phase = RoundPhase.SIMULATE

    def _sim_clients(self, st: RoundState) -> List[SimClient]:
        return [SimClient(c.client_id, c.budget, st.works[c.client_id])
                for c in st.participants]

    def _step_simulate(self, st: RoundState) -> None:
        """Synchronous path: drive our own engine to round close.  A
        fabric-driven trainer never enters here — ``submit_round`` enqueues
        the spec and the fabric steps the engine instead."""
        st.result = self.engine.run_round(
            self._sim_clients(st), deadline=st.deadline,
            failure_times=st.failure_times,
        )
        st.phase = RoundPhase.DISPATCH

    def submit_round(self, st: RoundState) -> int:
        """Fabric path for SIMULATE: queue the round's spec into the engine
        WITHOUT driving the clock (the fabric owns the merged event loop).
        Subscribes (once) to the engine's round-boundary callbacks: each
        simulated COMPLETE feeds the eager-collection queue, and round
        close delivers the result (``complete_simulate``) — the phase
        stays SIMULATE until then."""
        if st.phase is not RoundPhase.SIMULATE or st.engine_round_idx is not None:
            raise RuntimeError(f"submit_round needs a sampled, unsubmitted round "
                               f"(phase {st.phase.name})")
        if not self._subscribed:
            self.engine.on_client_done(self._engine_client_done)
            self.engine.on_round_complete(self._engine_round_complete)
            self._subscribed = True
        self._active_st = st
        spec = RoundSpec(
            clients=tuple(self._sim_clients(st)),
            deadline=st.deadline,
            failure_times=dict(st.failure_times),
        )
        st.engine_round_idx = self.engine.enqueue_rounds([spec])[0].idx
        return st.engine_round_idx

    def _engine_client_done(self, cid: int, round_idx: int) -> None:
        st = self._active_st
        if st is not None and st.engine_round_idx == round_idx:
            st.trainable.append(cid)

    def _engine_round_complete(self, round_idx: int, result) -> None:
        st = self._active_st
        if st is not None and st.engine_round_idx == round_idx:
            self._active_st = None
            self.complete_simulate(st, result)

    def complete_simulate(self, st: RoundState, result: RoundResult) -> None:
        """Deliver the simulated round result (from the engine's
        ``on_round_complete`` callback); unblocks the wall-clock phases."""
        st.result = result
        st.phase = RoundPhase.DISPATCH

    def collect_eager(self, st: RoundState) -> bool:
        """Train one client whose *simulated* completion already fired
        (``on_client_done``) while the round is still SIMULATE — the wall
        work no longer waits for the round's straggler tail.  Completions
        arrive in span-end order, exactly the finisher order DISPATCH
        would pick, so eager collection is identical to collecting after
        the fact.  Returns True if a client was trained."""
        if st.phase is not RoundPhase.SIMULATE:
            return False
        # over-selection: only the first participants_per_round completions
        # become finishers — never train past that cap
        cap = min(len(st.trainable), self.fed.participants_per_round)
        if st.collect_idx >= cap:
            return False
        self._collect_client(st, st.trainable[st.collect_idx])
        return True

    def collect_wave_eager(self, st: RoundState) -> int:
        """Batched variant of :meth:`collect_eager`: drain *all* clients
        whose simulated COMPLETE has fired (up to the finisher cap) in one
        wave.  Falls back to the per-client eager step when batching is
        off.  Returns the number of clients trained."""
        if self.batch_exec is None:
            return int(self.collect_eager(st))
        if st.phase is not RoundPhase.SIMULATE:
            return 0
        cap = min(len(st.trainable), self.fed.participants_per_round)
        if st.collect_idx >= cap:
            return 0
        cids = st.trainable[st.collect_idx:cap]
        self._collect_wave(st, cids)
        return len(cids)

    def _step_dispatch(self, st: RoundState) -> None:
        st.finishers = sorted(
            st.result.spans.items(), key=lambda kv: kv[1].end
        )[:self.fed.participants_per_round]
        st.phase = RoundPhase.COLLECT

    def _collect_client(self, st: RoundState, cid: int) -> None:
        """Train and ingest ONE finisher (st.collect_idx'th); shared by the
        COLLECT phase step and the eager path."""
        t0 = time.time()
        delta, n_seen, m = st.by_id[cid].train_local(
            self.params, self.step_fn, self.opt, n_steps=self.fed.local_steps)
        t1 = time.time()
        if self._h_train is not None:
            self._h_train.observe(t1 - t0)
        if self._trace is not None:
            self._trace.wall_span(
                "client.train", t0, t1, self.tenant, "train",
                args={"cid": cid, "round": self.round})
        self._ingest_delta(st, cid, delta, n_seen, m)

    def _ingest_delta(self, st: RoundState, cid: int, delta, n_seen, m) -> None:
        """Compression + comm accounting + delta bookkeeping for one
        collected client — shared by the per-client and batched-wave paths,
        with the reference's per-client compression seeds."""
        fed = self.fed
        if fed.compression != "none":
            wire = compress_tree(delta, fed.compression,
                                 seed=self.round * 1000 + cid, noise=self.noise)
            self._comm.inc(tree_wire_bytes(wire))
            delta = params_from_numpy(decompress_tree(wire), self.device)
        else:
            self._comm.inc(tree_nbytes(delta))
        st.deltas.append((delta, float(n_seen)))
        st.train_metrics = m
        st.collect_idx += 1

    def _collect_wave(self, st: RoundState, cids: List[int]) -> None:
        """Train a whole wave of finishers as ONE program, then ingest the
        per-client results in the same order — aggregation order is
        identical to collecting the clients one at a time."""
        t0 = time.time()
        results = self.batch_exec.run_wave(
            self.params, [st.by_id[c] for c in cids],
            self.fed.local_steps, self.round,
        )
        t1 = time.time()
        if self._h_train is not None:
            self._h_train.observe((t1 - t0) / max(len(cids), 1))
        if self._trace is not None:
            lw = self.batch_exec.last_wave
            self._trace.wall_span(
                "client.batch_wave", t0, t1, self.tenant, "train",
                args={"round": self.round, "clients": len(cids),
                      "mode": lw.get("mode"), "cache_hit": lw.get("cache_hit")})
        for cid, (delta, n_seen, m) in zip(cids, results):
            self._ingest_delta(st, cid, delta, n_seen, m)

    def _step_collect(self, st: RoundState) -> None:
        if st.collect_idx < len(st.finishers):
            if self.batch_exec is not None:
                # batched path: drain every remaining finisher in one wave
                self._collect_wave(
                    st, [cid for cid, _ in st.finishers[st.collect_idx:]])
            else:
                self._collect_client(st, st.finishers[st.collect_idx][0])
        if st.collect_idx >= len(st.finishers):
            st.phase = RoundPhase.AGGREGATE

    def _step_aggregate(self, st: RoundState) -> None:
        fed = self.fed
        if st.deltas:
            t0 = time.time()
            if fed.aggregation == "async":
                for delta, w in st.deltas:
                    if self.async_agg.add(delta, w, self.round):
                        self.params = self.async_agg.flush(self.params)
            else:
                self.params = apply_deltas(self.params, st.deltas, fed.server_lr)
            if self._trace is not None:
                if self.device.type == "cuda":
                    # nothing here reads the sum back: wait for the card so
                    # the span closes on the work, not on its launch
                    torch.cuda.synchronize(self.device)
                self._trace.wall_span(
                    "round.aggregate", t0, time.time(), self.tenant, "rounds",
                    args={"round": self.round, "deltas": len(st.deltas)})
        st.phase = RoundPhase.REPORT

    def _step_report(self, st: RoundState) -> None:
        result = st.result
        self.sim_clock = self.engine.now
        self.round += 1

        rec = {
            "round": self.round,
            "duration": result.duration,
            "sim_clock": self.sim_clock,
            "completed": len(st.deltas),
            "mode": st.mode,
            "failed": len(result.failed),
            "avg_parallelism": result.avg_parallelism(),
            "utilization": result.utilization(),
            "comm_bytes": self.comm_bytes,
            **{f"train_{k}": v for k, v in st.train_metrics.items()},
        }
        if self.test_batch is not None:
            with torch.no_grad():
                loss, m = small_loss(self.params, self.mcfg, self.test_batch)
            rec["test_loss"] = float(loss)
            rec["test_acc"] = float(m["acc"])
        self.history.append(rec)
        if self.ckpt and self.round % self.fed.ckpt_every == 0:
            meta = {
                "sim_clock": self.sim_clock,
                "comm_bytes": self.comm_bytes,
                "history": list(self.history),
            }
            if self.obs is not None:
                # counter continuity across resume: the registry's counter
                # values ride the checkpoint meta
                meta["counters"] = self.obs.registry.counters_snapshot()
            self.ckpt.save(self.round, self.params, meta)
        st.rec = rec
        st.phase = RoundPhase.DONE

    _PHASE_STEPS: Dict[RoundPhase, Callable] = {
        RoundPhase.SAMPLE: _step_sample,
        RoundPhase.SIMULATE: _step_simulate,
        RoundPhase.DISPATCH: _step_dispatch,
        RoundPhase.COLLECT: _step_collect,
        RoundPhase.AGGREGATE: _step_aggregate,
        RoundPhase.REPORT: _step_report,
    }

    # ------------------------------------------------------------------
    def run_round(self) -> dict:
        """Loop the state machine to DONE on this thread (the trainer owns
        the clock)."""
        st = self.begin_round()
        while st.phase is not RoundPhase.DONE:
            self.step_round(st)
        return st.rec

    def maybe_restore(self) -> bool:
        """Resume from the latest checkpoint if one exists: params, round,
        the simulated clock, history and comm counter, and the obs plane's
        checkpointed counters, so the
        convergence x-axis (Fig 8/9d) continues instead of restarting at
        t=0.  As in the reference, the sampling RNG, the clients' data
        streams and the engine's pool are not in the checkpoint.  Returns
        True when a checkpoint was restored."""
        if not self.ckpt:
            return False
        step, params, meta = self.ckpt.restore_latest_with_meta(self.params)
        if step is None:
            return False
        self.params = params
        self.round = step
        self.sim_clock = float(meta.get("sim_clock", 0.0))
        self.comm_bytes = int(meta.get("comm_bytes", 0))
        self.history = list(meta.get("history", []))
        # continue the campaign clock (never rewind a shared fabric clock)
        self.engine.now = max(self.engine.now, self.sim_clock)
        if self.obs is not None and meta.get("counters"):
            # re-seed every checkpointed counter (engine + trainer scopes)
            # so the accounting stays monotone across the resume
            self.obs.registry.restore_counters(meta["counters"])
        return True

    def run(self, rounds: Optional[int] = None) -> List[dict]:
        self.maybe_restore()
        n = self.fed.rounds if rounds is None else rounds
        for _ in range(n):
            self.run_round()
        return self.history


# --------------------------------------------------------------------------
# Convenience builder for the paper-style experiments
# --------------------------------------------------------------------------


def build_fl_clients(
    mcfg: SmallModelConfig,
    budgets: Sequence[ClientBudget],
    dataset: str = "femnist",
    n_samples: int = 4000,
    alpha: float = 0.5,
    batch_size: int = 32,
    n_batches: int = 10,
    seed: int = 0,
) -> Tuple[List[FLClient], Dict[str, np.ndarray]]:
    """Clients over a Dirichlet split of a synthetic dataset, and a
    512-example test batch — the reference's world for the same seed."""
    n_test = 512
    x_all, y_all = make_dataset(dataset, n_samples + n_test, seed=seed)
    x, y = x_all[:n_samples], y_all[:n_samples]
    xt, yt = x_all[n_samples:], y_all[n_samples:]
    parts = dirichlet_partition(y, len(budgets), alpha=alpha, seed=seed)
    clients = []
    for cb, part in zip(budgets, parts):
        if len(part) < 2:
            part = np.arange(2)
        ds = ClientDataset(x[part], y[part], batch_size, seed=seed + cb.client_id)
        clients.append(
            FLClient(
                cb.client_id,
                cb.budget,
                ds,
                WorkloadSpec(
                    model=mcfg.kind,
                    n_layers=mcfg.n_layers,
                    batch_size=batch_size,
                    n_batches=n_batches,
                    extra_local_model=mcfg.extra_local_model,
                ),
            )
        )
    return clients, {"x": xt, "y": yt}
