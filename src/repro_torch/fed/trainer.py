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
                :class:`~repro_torch.fed.batch_exec.BatchedExecutor` wave;
  ``AGGREGATE`` sync weighted FedAvg, or FedBuff-style async ordered by
                simulated completion times, with optional uplink
                compression (int8 / topk);
  ``REPORT``    evaluate, record history, checkpoint (atomic, keep-k,
                resumable: ``maybe_restore``).

``run_round()`` loops :meth:`FederatedTrainer.step_round` until the round
is ``DONE``.  The simulated clock is the x-axis of the convergence figures
(Fig 8/9d); failure injection + deadline + over-selection exercise the
fault-tolerance path (clients that die are simply absent from aggregation).

Still to port: remote dispatch, the observability plane and fabric-driven
rounds (``submit_round`` and the eager-collect steps).  Asking for any of
them raises.
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
from repro_torch.core.campaign import CampaignEngine
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
    """States of the per-round trainer state machine; transitions are
    strictly forward (SAMPLE → … → DONE)."""

    SAMPLE = "sample"          # wall clock: runtime probes, RNG draws
    SIMULATE = "simulate"      # simulated clock: the engine's event loop
    DISPATCH = "dispatch"      # wall clock: finisher pick
    COLLECT = "collect"        # wall clock: real local training
    AGGREGATE = "aggregate"    # wall clock: FedAvg / async apply
    REPORT = "report"          # wall clock: eval, history, checkpoint
    DONE = "done"


@dataclass
class RoundState:
    """Mutable per-round state threaded through the phase steps."""

    phase: RoundPhase = RoundPhase.SAMPLE
    participants: List[FLClient] = field(default_factory=list)
    by_id: Dict[int, FLClient] = field(default_factory=dict)
    works: Dict[int, float] = field(default_factory=dict)
    failure_times: Dict[int, float] = field(default_factory=dict)
    deadline: Optional[float] = None
    result: Optional[RoundResult] = None
    finishers: List[Tuple[int, Any]] = field(default_factory=list)
    mode: str = "FULL"
    deltas: List[Tuple[PyTree, float]] = field(default_factory=list)
    train_metrics: Dict[str, float] = field(default_factory=dict)
    collect_idx: int = 0                     # finishers collected so far
    rec: Optional[dict] = None               # the round's history record


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, queue 1: the rest of the trainer)")


class FederatedTrainer:
    def __init__(
        self,
        mcfg: SmallModelConfig,
        clients: Sequence[FLClient],
        fed: FedConfig,
        test_batch: Optional[Dict[str, np.ndarray]] = None,
        runtime=None,
        *,
        device: DeviceLike = None,
        noise: Optional[Noise] = None,
        dispatcher=None,
        obs=None,
    ):
        """``runtime`` (optional) overrides the framework-provided runtime
        backend (default: ``MeasuredRuntime`` on ``device``; inject
        ``FixedRuntime`` to make the simulated timeline reproducible across
        hosts).  ``device`` defaults to the CUDA card.  ``noise`` is int8
        compression's rounding noise (``repro_torch.fed.compression``;
        default: a ``torch.Generator`` on the device)."""
        if dispatcher is not None:
            raise _not_ported("remote dispatch")
        if obs is not None:
            raise _not_ported("the observability plane (obs)")
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
        # aggregation-payload bytes (the deltas as uploaded)
        self._comm = Counter()
        self.history: List[dict] = []
        self.async_agg = AsyncAggregator(
            buffer_size=fed.async_buffer, server_lr=fed.server_lr
        )
        # one campaign engine for the whole run: continuous simulated clock
        # across rounds, executor pool persists
        self.engine = CampaignEngine(
            SCHEDULERS[fed.scheduler],
            theta=fed.theta,
            manager_mode=fed.manager_mode,
            max_parallel=fed.max_parallel,
            # lifelong engine: per-round timelines feed the history records,
            # but the campaign-global timeline and executor event history
            # would grow without bound over a long training run
            record_campaign_timeline=False,
            record_events=False,
        )
        self.batch_exec = (
            BatchedExecutor(mcfg, self.opt, fed.prox_mu, device=self.device)
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
        round is in afterwards."""
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

    def _step_simulate(self, st: RoundState) -> None:
        st.result = self.engine.run_round(
            [SimClient(c.client_id, c.budget, st.works[c.client_id])
             for c in st.participants],
            deadline=st.deadline, failure_times=st.failure_times,
        )
        st.phase = RoundPhase.DISPATCH

    def _step_dispatch(self, st: RoundState) -> None:
        st.finishers = sorted(
            st.result.spans.items(), key=lambda kv: kv[1].end
        )[:self.fed.participants_per_round]
        st.phase = RoundPhase.COLLECT

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
        results = self.batch_exec.run_wave(
            self.params, [st.by_id[c] for c in cids],
            self.fed.local_steps, self.round,
        )
        for cid, (delta, n_seen, m) in zip(cids, results):
            self._ingest_delta(st, cid, delta, n_seen, m)

    def _step_collect(self, st: RoundState) -> None:
        if st.collect_idx < len(st.finishers):
            if self.batch_exec is not None:
                # batched path: drain every remaining finisher in one wave
                self._collect_wave(
                    st, [cid for cid, _ in st.finishers[st.collect_idx:]])
            else:
                cid = st.finishers[st.collect_idx][0]
                self._ingest_delta(st, cid, *st.by_id[cid].train_local(
                    self.params, self.step_fn, self.opt,
                    n_steps=self.fed.local_steps))
        if st.collect_idx >= len(st.finishers):
            st.phase = RoundPhase.AGGREGATE

    def _step_aggregate(self, st: RoundState) -> None:
        fed = self.fed
        if st.deltas:
            if fed.aggregation == "async":
                for delta, w in st.deltas:
                    if self.async_agg.add(delta, w, self.round):
                        self.params = self.async_agg.flush(self.params)
            else:
                self.params = apply_deltas(self.params, st.deltas, fed.server_lr)
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
            self.ckpt.save(self.round, self.params, meta)
        st.rec = rec
        st.phase = RoundPhase.DONE

    def _fabric_not_ported(self, *args, **kwargs):
        raise _not_ported("fabric-driven rounds")

    submit_round = complete_simulate = _fabric_not_ported
    collect_eager = collect_wave_eager = _fabric_not_ported

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
        """Loop the state machine to DONE on this thread."""
        st = self.begin_round()
        while st.phase is not RoundPhase.DONE:
            self.step_round(st)
        return st.rec

    def maybe_restore(self) -> bool:
        """Resume from the latest checkpoint if one exists: params, round,
        and the simulated clock, history and comm counter, so the
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
        # continue the campaign clock
        self.engine.now = max(self.engine.now, self.sim_clock)
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
