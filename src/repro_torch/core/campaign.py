"""Event-driven multi-round campaign engine (paper §4 + §6, scaled out).

A pure-Python copy of ``repro.core.campaign.CampaignEngine``: N global FL
rounds under ONE continuous simulated clock, with availability traces
(clients join/leave between and during rounds), async round boundaries,
and pool capacity changes as first-class heap events.  The engine keeps
the admitted-budget total and granted-rate total incrementally and stores
completions in a lazy-deletion heap keyed by absolute completion time, so
a campaign is O(events·log).

Fabric tenancy, as in the reference: an engine can draw its executor slots
from a shared ``repro_torch.core.fabric.ResourceArbiter`` lease
(``slot_source``), be stepped one event at a time (``peek_time``/``step``/
``advance_to``) so N concurrent campaigns interleave under one merged
clock, lose a slot to a lease revocation (``preempt_slot``), and notify
subscribers of client completions and round closes (``on_client_done``,
``on_round_complete``).  With ``obs=`` it counts on the metrics registry
and traces on the simulated clock, scoped by ``tenant``.

Control-plane coupling, as in the reference: with ``mirror=True`` (or a
``server`` or ``mirror_delta_provider``) every simulated SPAWN/COMPLETE/FAIL
is replayed as the paper's message sequence through the ``FLServer``'s
``StatusMonitor`` (:class:`ControlPlaneMirror`); the mirror does not feed
the timeline.  ``mirror_noise`` (port only) is int8's rounding-noise seam
for a compressing mirror, as ``FederatedTrainer``'s ``noise``.
"""
from __future__ import annotations

import bisect
import heapq
import itertools
import random
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Type, Union

from repro_torch.core.budget import ClientBudget
from repro_torch.core.executor import ProcessManager
from repro_torch.core.scheduler import FedHCScheduler, SchedulerBase
from repro_torch.core.sharing import compute_rates
from repro_torch.obs.metrics import Counter

# --------------------------------------------------------------------------
# Result dataclasses (``repro_torch.core.simulator`` re-exports them)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class SimClient:
    client_id: int
    budget: float          # percent of the pool
    work: float            # seconds at 100% capacity


@dataclass
class Span:
    start: float
    end: float
    budget: float


@dataclass
class TimelineSeg:
    t0: float
    t1: float
    total_budget: float    # admitted budget (can exceed 100 under soft margin)
    total_rate: float      # physically granted rate (≤ capacity)
    parallelism: int


@dataclass
class RoundResult:
    duration: float
    spans: Dict[int, Span]
    timeline: List[TimelineSeg]
    completed: int
    failed: List[int] = field(default_factory=list)
    start: float = 0.0     # campaign clock at round open (0 for single rounds)
    #: "FULL" or "DEGRADED" — set by the trainer when a quorum policy
    #: closed the round at deadline with a straggler subset dropped
    mode: str = "FULL"

    @property
    def throughput(self) -> float:
        return self.completed / self.duration if self.duration > 0 else 0.0

    def avg_admitted_budget(self) -> float:
        tot = sum(seg.total_budget * (seg.t1 - seg.t0) for seg in self.timeline)
        return tot / self.duration if self.duration > 0 else 0.0

    def avg_parallelism(self) -> float:
        tot = sum(seg.parallelism * (seg.t1 - seg.t0) for seg in self.timeline)
        return tot / self.duration if self.duration > 0 else 0.0

    def utilization(self, capacity: float = 100.0) -> float:
        tot = sum(min(seg.total_rate, capacity) * (seg.t1 - seg.t0) for seg in self.timeline)
        return tot / (capacity * self.duration) if self.duration > 0 else 0.0


@dataclass
class CampaignResult:
    rounds: List[RoundResult]
    duration: float            # campaign clock elapsed over all rounds
    total_completed: int
    total_failed: int
    churn_evictions: int       # availability-driven executor evictions
    events_processed: int

    @property
    def throughput(self) -> float:
        return self.total_completed / self.duration if self.duration > 0 else 0.0

    def utilization(self, capacity: float = 100.0) -> float:
        """Duration-weighted mean of per-round utilization (over time the
        campaign was actually inside a round)."""
        tot = sum(r.utilization(capacity) * r.duration for r in self.rounds)
        dur = sum(r.duration for r in self.rounds)
        return tot / dur if dur > 0 else 0.0


# --------------------------------------------------------------------------
# Capacity events
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class CapacityEvent:
    """Pool capacity becomes ``capacity`` (budget units) at ``time``.

    ``theta`` optionally rescales the admission threshold with the pool
    (the elastic facade passes ``theta_frac × capacity``); ``None`` leaves
    θ untouched (a fabric grant changes physical share, not admission).
    """

    time: float
    capacity: float  # new pool capacity in budget units (100 = one full pod)
    theta: Optional[float] = None


# --------------------------------------------------------------------------
# Availability traces
# --------------------------------------------------------------------------


class AvailabilityTrace:
    """Per-client availability windows over the continuous campaign clock.

    ``windows[cid]`` is a list of ``(up, down)`` half-open intervals;
    a client is *up* at t iff some window has ``up <= t < down``.  Clients
    without an entry are always available.  Internally each client's
    windows are merged and flattened to a sorted edge array, so ``is_up``
    and ``next_edge`` are O(log windows) bisections.
    """

    def __init__(self, windows: Dict[int, Sequence[Tuple[float, float]]]):
        self.edges: Dict[int, List[float]] = {}
        for cid, ws in windows.items():
            merged: List[List[float]] = []
            for a, b in sorted((float(a), float(b)) for a, b in ws if b > a):
                if merged and a <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], b)
                else:
                    merged.append([a, b])
            flat: List[float] = []
            for a, b in merged:
                flat.append(a)
                flat.append(b)
            self.edges[cid] = flat

    def tracks(self, cid: int) -> bool:
        return cid in self.edges

    def is_up(self, cid: int, t: float) -> bool:
        flat = self.edges.get(cid)
        if flat is None:
            return True
        # inside a window iff an odd number of edges are <= t
        return bisect.bisect_right(flat, t) % 2 == 1

    def next_edge(self, cid: int, t: float) -> Optional[float]:
        """Earliest window boundary strictly after t (None when exhausted)."""
        flat = self.edges.get(cid, ())
        i = bisect.bisect_right(flat, t)
        return flat[i] if i < len(flat) else None

    @classmethod
    def periodic(
        cls,
        client_ids: Sequence[int],
        *,
        period: float,
        duty: float,
        horizon: float,
        seed: int = 0,
    ) -> "AvailabilityTrace":
        """Diurnal-style trace: each client cycles up for ``duty·period``
        then away, with a random per-client phase, out to ``horizon``."""
        assert 0.0 < duty <= 1.0, duty
        rng = random.Random(seed)
        windows: Dict[int, List[Tuple[float, float]]] = {}
        for cid in client_ids:
            phase = rng.uniform(0.0, period)
            ws: List[Tuple[float, float]] = []
            t = phase - period
            while t < horizon:
                a, b = max(t, 0.0), min(t + duty * period, horizon)
                if b > a:
                    ws.append((a, b))
                t += period
            windows[cid] = ws
        return cls(windows)


# --------------------------------------------------------------------------
# Control-plane mirror
# --------------------------------------------------------------------------


class ControlPlaneMirror:
    """Mirrors simulated executor lifecycle transitions into the FLServer's
    message protocol, so the StatusMonitor's per-client state machine and
    the record table track exactly what the timing engine simulated.

    With a ``delta_provider`` the UPLOAD payloads carry *real* parameter
    deltas — ``provider(cid)`` returns a delta tree of numpy arrays (wire
    payloads are numpy at the seams) or a ``(delta, n)`` pair — optionally
    squeezed through ``repro_torch.fed.compression``: the payload then
    carries the *compressed* wire-native tree (int8 + scale / topk pairs,
    which wire codec v2 transmits without re-inflation) and ``comm_bytes``
    accumulates the compressed wire size; receivers dequantize with
    ``repro_torch.fed.compression.decompress_tree``.  ``noise`` is int8's
    rounding-noise seam (``repro_torch.fed.compression.Noise``).  Without a
    provider the payloads stay empty (pure control-plane coupling).

    The StatusMonitor keys its state machine by client id, so when async
    round boundaries give the same client two concurrently running
    executors (a round-r straggler plus its round-r+1 re-admission), the
    mirror *serializes* them on the wire: one session is open whenever the
    client has any live executor, each simulated outcome is delivered on
    that open session (COMPLETE -> TRAIN_DONE/UPLOAD, FAIL -> ABORT), and
    a fresh session is registered immediately if executors remain.  The
    session-to-executor binding is nominal under overlap, but the counts
    and final per-client state always match the timing authority.
    """

    def __init__(self, server=None, *, delta_provider=None,
                 compression: str = "none", comm_counter: Optional[Counter] = None,
                 noise=None):
        from repro_torch.fed.server import FLServer  # lazy: keep core light

        self.server = server if server is not None else FLServer()
        self.delta_provider = delta_provider
        self.compression = compression
        self.noise = noise
        # byte accounting on the shared counter primitive; an injected
        # counter lets the engine alias it into a metrics registry
        self._comm = comm_counter if comm_counter is not None else Counter()
        self._live: Dict[int, int] = {}   # cid -> live simulated executors
        self._uploads: Dict[int, int] = {}  # cid -> upload count (comp. seed)

    @property
    def comm_bytes(self) -> int:
        return int(self._comm.value)

    @comm_bytes.setter
    def comm_bytes(self, v: int) -> None:
        self._comm.reset(int(v))

    def _roundtrip(self, kind, cid, payload=None):
        from repro_torch.fed.server import Message

        t = self.server.transport
        t.send_to_server(Message(kind, cid, payload or {}))
        self.server.step()
        return t.poll_client(cid)

    def _register(self, cid: int) -> None:
        from repro_torch.fed.server import MsgType

        self._roundtrip(MsgType.REGISTER, cid)          # -> WAIT
        self._roundtrip(MsgType.READY, cid)             # -> TRAIN

    def on_spawn(self, cid: int) -> None:
        n = self._live.get(cid, 0)
        self._live[cid] = n + 1
        if n == 0:
            self._register(cid)  # overlapped spawns wait for the session

    def _closed(self, cid: int) -> None:
        n = self._live.get(cid, 1) - 1
        if n:
            self._live[cid] = n
            self._register(cid)  # next overlapped executor takes the wire
        else:
            self._live.pop(cid, None)

    def _upload_payload(self, cid: int) -> dict:
        if self.delta_provider is None:
            return {}
        from repro_torch.fed.compression import compress_tree, tree_wire_bytes
        from repro_torch.fed.transport import check_numpy_tree

        out = self.delta_provider(cid)
        delta, n = out if isinstance(out, tuple) else (out, 1.0)
        check_numpy_tree(delta, "the mirror's delta provider")
        if self.compression != "none":
            seq = self._uploads.get(cid, 0)
            self._uploads[cid] = seq + 1
            # the payload carries the *compressed* delta (int8 + scale /
            # topk pairs are native wire dtypes — codec v2 transmits them
            # without re-inflation); consumers dequantize via
            # decompress_tree, which is an identity on uncompressed payloads
            delta = compress_tree(delta, self.compression,
                                  seed=cid + 100_003 * seq, noise=self.noise)
        self._comm.inc(tree_wire_bytes(delta))
        return {"delta": delta, "n": n}

    def on_complete(self, cid: int) -> None:
        from repro_torch.fed.server import MsgType

        self._roundtrip(MsgType.TRAIN_DONE, cid)        # -> SEND_UPDATE
        self._roundtrip(MsgType.UPLOAD, cid, self._upload_payload(cid))
        self._closed(cid)

    def on_fail(self, cid: int) -> None:
        from repro_torch.fed.server import MsgType

        self._roundtrip(MsgType.ABORT, cid)             # -> TERMINATE
        self._closed(cid)


# --------------------------------------------------------------------------
# Engine internals
# --------------------------------------------------------------------------


class _Active:
    __slots__ = ("eid", "cid", "round_idx", "budget", "remaining", "rate",
                 "synced", "started", "token", "ex")

    def __init__(self, eid, cid, round_idx, budget, remaining, started, ex):
        self.eid = eid
        self.cid = cid
        self.round_idx = round_idx
        self.budget = budget
        self.remaining = remaining
        self.rate = 0.0
        self.synced = started
        self.started = started
        self.token = 0
        self.ex = ex


@dataclass(frozen=True)
class RoundSpec:
    clients: Tuple[SimClient, ...]
    deadline: Optional[float] = None               # relative to round start
    failure_times: Dict[int, float] = field(default_factory=dict)  # rel. to client start

    @classmethod
    def coerce(cls, spec) -> "RoundSpec":
        if isinstance(spec, RoundSpec):
            return spec
        return cls(clients=tuple(spec))


class _Round:
    def __init__(self, idx: int, spec: RoundSpec, scheduler_cls, theta: float):
        self.idx = idx
        self.spec = spec
        self.by_id = {c.client_id: c for c in spec.clients}
        self.sched: SchedulerBase = scheduler_cls(
            [ClientBudget(c.client_id, c.budget) for c in spec.clients],
            theta=theta,
        )
        self.spans: Dict[int, Span] = {}
        self.failed: List[int] = []
        self.timeline: List[TimelineSeg] = []
        self.start = 0.0
        self.end = 0.0
        self.opened = False
        self.closed = False
        self.deadline_hit = False
        self.n_active = 0
        self.active_eid: Dict[int, int] = {}   # cid -> eid while running

    @property
    def launched(self) -> bool:
        """All clients spawned (stragglers may still be running)."""
        return self.sched.done

    def result(self) -> RoundResult:
        return RoundResult(
            duration=self.end - self.start,
            spans=self.spans,
            timeline=self.timeline,
            completed=len(self.spans),
            failed=self.failed,
            start=self.start,
        )


# executor-lifecycle outcomes, encoded as doubles in the deferred
# client.exec trace buffer (see CampaignEngine._exec_span)
_EXEC_STATUS = ("ok", "fail", "evict", "shed", "preempt")
_EXEC_STATUS_CODE = {s: float(i) for i, s in enumerate(_EXEC_STATUS)}
# one packed record per client.exec span:
# (t0, end, slot, cid, round, budget, status_code)
_EXEC_REC = struct.Struct("=7d")


class _EngineMetrics:
    """The engine's slice of the metrics registry, resolved once at
    construction so hot-path emission is attribute access, not dict
    lookups.  Scoped by tenant name (one engine = one tenant)."""

    __slots__ = ("completed", "failed", "evicted", "rounds", "round_latency",
                 "preemptions", "capacity_events")

    def __init__(self, registry, scope: str):
        self.completed = registry.counter("campaign.clients_completed", scope)
        self.failed = registry.counter("campaign.clients_failed", scope)
        self.evicted = registry.counter("campaign.clients_evicted", scope)
        self.rounds = registry.counter("campaign.rounds_completed", scope)
        self.round_latency = registry.histogram("campaign.round_latency", scope)
        self.preemptions = registry.counter("fabric.preemptions", scope)
        self.capacity_events = registry.counter("fabric.capacity_events", scope)


# event heap priorities: completion before failure (a client finishing at
# the same instant it would die counts as finished, like RoundSimulator's
# strict `rel < dt`), capacity changes next (a completion landing exactly
# on the event precedes the shed, like the legacy elastic loop's strict
# `t + dt > ev.time` truncation), churn edges after that, deadline last
# (a completion landing exactly on the deadline still counts).
_P_COMPLETE, _P_FAIL, _P_CAPACITY, _P_EDGE, _P_DEADLINE = 0, 1, 2, 3, 4


class CampaignEngine:
    """Multi-round, trace-driven, event-driven FedHC campaign engine."""

    def __init__(
        self,
        scheduler_cls: Type[SchedulerBase] = FedHCScheduler,
        *,
        theta: float = 100.0,
        capacity: float = 100.0,
        manager_mode: str = "dynamic",
        max_parallel: int = 64,
        availability: Optional[AvailabilityTrace] = None,
        async_rounds: bool = False,
        mirror: bool = False,
        server=None,
        record_timeline: bool = True,
        record_campaign_timeline: Optional[bool] = None,
        record_events: bool = True,
        start_clock: float = 0.0,
        slot_source=None,
        capacity_events: Sequence[CapacityEvent] = (),
        mirror_delta_provider=None,
        mirror_compression: str = "none",
        obs=None,
        tenant: str = "campaign",
        mirror_noise=None,
    ):
        self.scheduler_cls = scheduler_cls
        self.theta = theta
        self.capacity = capacity
        self.max_parallel = max_parallel
        self.trace = availability
        self.async_rounds = async_rounds
        self.record_timeline = record_timeline
        # lifelong engines (the trainer's) can drop the campaign-global
        # timeline while keeping per-round segments for RoundResult stats
        self.record_campaign_timeline = (
            record_timeline
            if record_campaign_timeline is None
            else record_campaign_timeline
        )
        # observability plane: the tracer reference is cached as None when
        # tracing is off, so the disabled-mode hot-path cost is one load
        # and a branch
        self.obs = obs
        self.tenant = str(tenant)
        self._trace = obs.tracer if obs is not None and obs.tracer.enabled \
            else None
        self._slot_tids: List[str] = []   # interned "slot N" track names
        # deferred client.exec records, packed as raw _EXEC_REC doubles —
        # see _exec_span for why this is a bytearray and not a list
        self._exec_pending = bytearray()
        if self._trace is not None:
            self._trace.add_flush(self._flush_exec_spans)
        self._mx = _EngineMetrics(obs.registry, self.tenant) \
            if obs is not None else None
        if obs is not None:
            # pull-mode gauges: evaluated when read (snapshot/report), so
            # the admission sweep never pays to keep them current
            obs.registry.gauge("campaign.queue_depth", self.tenant).bind(
                lambda: sum(r.sched.queue_depth() for r in self._open))
            obs.registry.gauge("campaign.slot_utilization", self.tenant).bind(
                lambda: (min(self.total_rate, self.capacity) / self.capacity
                         if self.capacity > 0 else 0.0))
        self.mgr = ProcessManager(mode=manager_mode, max_parallel=max_parallel,
                                  record_events=record_events,
                                  avail=slot_source,
                                  spawn_counter=(
                                      obs.registry.counter("exec.spawns",
                                                           self.tenant)
                                      if obs is not None else None))
        self.mirror = (
            ControlPlaneMirror(server, delta_provider=mirror_delta_provider,
                               compression=mirror_compression,
                               comm_counter=(
                                   obs.registry.counter("fed.comm_bytes",
                                                        self.tenant)
                                   if obs is not None else None),
                               noise=mirror_noise)
            if (mirror or server is not None or mirror_delta_provider is not None)
            else None
        )
        self.server = self.mirror.server if self.mirror else None

        self.now = float(start_clock)
        self.active: Dict[int, _Active] = {}     # eid -> record
        self.total_budget = 0.0                  # admitted budget, incremental
        self.total_rate = 0.0                    # granted rate, incremental
        self.contended = False
        self.timeline: List[TimelineSeg] = []    # campaign-global
        self.churn_evictions = 0
        self.capacity_evictions = 0              # capacity-shed evictions
        self.preemptions = 0                     # arbiter lease revocations
        self.events_processed = 0

        self._rounds: List[Optional[_Round]] = []  # closed slots become None
        self._n_clients_total = 0
        self._next_to_open = 0
        self._open: List[_Round] = []
        # round-boundary callbacks, fired from the stepping API so a
        # subscriber (a fabric-driven trainer) reacts to simulated progress
        # instead of polling run_round() synchronously
        self._on_round_complete: List = []
        self._on_client_done: List = []
        self._fresh: List[_Active] = []          # spawned since last reconcile
        self._heap: List[tuple] = []
        self._seq = itertools.count()
        self._edge_pending: set = set()          # cids with an edge event queued
        for ev in sorted(capacity_events, key=lambda e: e.time):
            self.post_capacity_event(ev)

    # -- public API --------------------------------------------------------

    def run_round(
        self,
        clients: Sequence[SimClient],
        *,
        deadline: Optional[float] = None,
        failure_times: Optional[Dict[int, float]] = None,
    ) -> RoundResult:
        """Run one global round from the current campaign clock."""
        spec = RoundSpec(tuple(clients), deadline, dict(failure_times or {}))
        rnd = self._enqueue(spec)
        self._drive()
        return rnd.result()

    def run_campaign(
        self, rounds: Sequence[Union[RoundSpec, Sequence[SimClient]]]
    ) -> CampaignResult:
        """Run a sequence of global rounds under the continuous clock."""
        t0 = self.now
        enqueued = [self._enqueue(RoundSpec.coerce(spec)) for spec in rounds]
        self._drive()
        results = [r.result() for r in enqueued]
        return CampaignResult(
            rounds=results,
            duration=self.now - t0,
            total_completed=sum(r.completed for r in results),
            total_failed=sum(len(r.failed) for r in results),
            churn_evictions=self.churn_evictions,
            events_processed=self.events_processed,
        )

    def enqueue_rounds(
        self, rounds: Sequence[Union[RoundSpec, Sequence[SimClient]]]
    ) -> List[_Round]:
        """Queue global rounds without driving the clock (the fabric drives
        the merged event loop itself via ``peek_time``/``step``)."""
        return [self._enqueue(RoundSpec.coerce(spec)) for spec in rounds]

    def post_capacity_event(self, ev: CapacityEvent) -> None:
        """Schedule a pool-capacity change as a first-class heap event."""
        heapq.heappush(self._heap, (
            float(ev.time), _P_CAPACITY, next(self._seq), "capacity",
            float(ev.capacity), ev.theta,
        ))

    # -- round-boundary subscriptions --------------------------------------

    def on_round_complete(self, cb) -> None:
        """Subscribe ``cb(round_idx, RoundResult)``, fired (from ``step``)
        the instant a round closes — all clients completed/failed or the
        deadline hit.  This is how a fabric-driven trainer learns its
        simulated round finished without owning the event loop."""
        self._on_round_complete.append(cb)

    def on_client_done(self, cb) -> None:
        """Subscribe ``cb(client_id, round_idx)``, fired on each simulated
        client COMPLETE.  Completions arrive in nondecreasing span-end
        order (the event heap), so a subscriber that trains eagerly on
        each callback processes clients in exactly the order the trainer's
        post-hoc ``sorted(spans, key=end)`` finisher selection would."""
        self._on_client_done.append(cb)

    # -- round lifecycle ---------------------------------------------------

    def _enqueue(self, spec: RoundSpec) -> _Round:
        rnd = _Round(len(self._rounds), spec, self.scheduler_cls, self.theta)
        self._rounds.append(rnd)
        self._n_clients_total += len(rnd.by_id)
        return rnd

    def _open_due_rounds(self) -> bool:
        opened = False
        while self._next_to_open < len(self._rounds):
            prev = self._rounds[self._next_to_open - 1] if self._next_to_open else None
            # a None slot is a closed (and released) round
            if prev is not None and not (
                prev.closed or (self.async_rounds and prev.launched)
            ):
                break
            rnd = self._rounds[self._next_to_open]
            self._next_to_open += 1
            rnd.opened = True
            rnd.start = self.now
            self._open.append(rnd)
            if rnd.spec.deadline is not None:
                heapq.heappush(self._heap, (
                    rnd.start + rnd.spec.deadline, _P_DEADLINE, next(self._seq),
                    "deadline", rnd.idx, 0,
                ))
            if self.trace is not None:
                for cid in rnd.by_id:
                    if self.trace.tracks(cid):
                        if not self.trace.is_up(cid, self.now):
                            rnd.sched.park(cid)
                        self._schedule_edge(cid, rnd.idx)
            opened = True
        return opened

    def _close(self, rnd: _Round) -> None:
        rnd.closed = True
        rnd.end = self.now
        if self._mx is not None:
            self._mx.rounds.inc()
            self._mx.round_latency.observe(rnd.end - rnd.start)
        if self._trace is not None:
            self._trace.span("round", rnd.start, rnd.end, self.tenant,
                             "rounds",
                             args={"round": rnd.idx,
                                   "completed": len(rnd.spans),
                                   "failed": len(rnd.failed)})
        self._open.remove(rnd)
        # release the engine's reference — results belong to the caller, and
        # a lifelong engine (the trainer's) must not grow per round
        self._rounds[rnd.idx] = None
        for cb in self._on_round_complete:
            cb(rnd.idx, rnd.result())

    # -- availability ------------------------------------------------------

    def _is_up(self, cid: int) -> bool:
        return self.trace is None or self.trace.is_up(cid, self.now)

    def _schedule_edge(self, cid: int, round_idx: int) -> None:
        if self.trace is None or not self.trace.tracks(cid):
            return
        key = (cid, round_idx)
        if key in self._edge_pending:
            return
        nxt = self.trace.next_edge(cid, self.now)
        if nxt is not None:
            self._edge_pending.add(key)
            heapq.heappush(self._heap, (
                nxt, _P_EDGE, next(self._seq), "edge", cid, round_idx,
            ))

    # -- accounting --------------------------------------------------------

    def _settle_all(self) -> None:
        now = self.now
        for rec in self.active.values():
            if rec.synced < now:
                rec.remaining -= (rec.rate / 100.0) * (now - rec.synced)
                rec.synced = now

    def _push_completion(self, rec: _Active) -> None:
        if rec.rate <= 0.0:
            return  # stalled — no completion until capacity returns
        t_c = rec.synced + rec.remaining / (rec.rate / 100.0)
        heapq.heappush(self._heap, (
            t_c, _P_COMPLETE, next(self._seq), "complete", rec.eid, rec.token,
        ))

    def _reconcile(self) -> None:
        contended_now = self.total_budget > self.capacity + 1e-12
        if contended_now or self.contended:
            # rates changed (or stop changing): settle everyone against the
            # old rates, re-waterfill, re-key every completion entry
            self._settle_all()
            rates = compute_rates(
                [(rec.eid, rec.budget) for rec in self.active.values()],
                self.capacity,
            )
            self.total_rate = 0.0
            for rec in self.active.values():
                rec.rate = rates[rec.eid]
                rec.token += 1
                self.total_rate += rec.rate
                self._push_completion(rec)
            self.contended = contended_now
        else:
            # uncontended fast path: existing entries stay valid, only the
            # fresh spawns need rates (their own budgets) and heap entries
            for rec in self._fresh:
                rec.rate = rec.budget
                self._push_completion(rec)
            self.total_rate = self.total_budget
        self._fresh.clear()

    # -- executor lifecycle ------------------------------------------------

    def _spawn(self, rnd: _Round, entry) -> None:
        ex = self.mgr.spawn(entry.executor_id, entry.client_id, entry.budget, self.now)
        rec = _Active(ex.eid, entry.client_id, rnd.idx, entry.budget,
                      rnd.by_id[entry.client_id].work, self.now, ex)
        self.active[ex.eid] = rec
        self._fresh.append(rec)
        rnd.n_active += 1
        rnd.active_eid[entry.client_id] = ex.eid
        self.total_budget += entry.budget
        ft = rnd.spec.failure_times.get(entry.client_id)
        if ft is not None:
            heapq.heappush(self._heap, (
                self.now + ft, _P_FAIL, next(self._seq), "fail", ex.eid, 0,
            ))
        if self.mirror:
            self.mirror.on_spawn(entry.client_id)

    def _remove(self, rec: _Active) -> _Round:
        rnd = self._rounds[rec.round_idx]
        del self.active[rec.eid]
        rnd.n_active -= 1
        rnd.active_eid.pop(rec.cid, None)
        self.total_budget -= rec.budget
        self.total_rate -= rec.rate
        if not self.active:  # flush incremental float drift at quiescence
            self.total_budget = 0.0
            self.total_rate = 0.0
        return rnd

    def _exec_span(self, rec: _Active, status: str) -> None:
        # THE trace hot path (one record per executor lifecycle, ~500k on
        # the scalability bench): append one struct-packed raw record and
        # defer event materialization to _flush_exec_spans (run via
        # tracer.flush() at read/export time, outside the timed campaign)
        # — the reference's <=5% tracing-overhead budget rides on this.
        # The buffer is a bytearray of packed doubles because the cycle GC
        # cannot see it: buffering 500k Python records raises the
        # net allocation count enough to force extra gen2 collections
        # (each a full-heap scan), which measurably slowed *unrelated*
        # engine code; and it beats array('d').extend by ~2x (one C pack
        # call vs per-element conversion).  The slot is snapshotted here
        # because executors are recycled after _remove.
        self._exec_pending += _EXEC_REC.pack(
            rec.started, self.now, rec.ex.slot, rec.cid, rec.round_idx,
            rec.budget, _EXEC_STATUS_CODE[status])

    def _flush_exec_spans(self) -> None:
        # idempotent: drains the pending buffer; called by Tracer.flush()
        pending, self._exec_pending = self._exec_pending, bytearray()
        if not pending:
            return
        tr = self._trace
        ev, tids, tenant = tr.events, self._slot_tids, self.tenant
        left = len(pending) // _EXEC_REC.size
        for t0, end, slot, cid, rnd, budget, code in \
                _EXEC_REC.iter_unpack(pending):
            if len(ev) >= tr.max_events:
                tr.drops += left
                return
            left -= 1
            slot = int(slot)
            while slot >= len(tids):
                tids.append(f"slot {len(tids)}")
            ev.append(
                ("X", "client.exec", "sim", tenant, tids[slot],
                 t0, end - t0, None, None,
                 (int(cid), int(rnd), budget, _EXEC_STATUS[int(code)])))

    def _complete(self, rec: _Active) -> None:
        rnd = self._remove(rec)
        rnd.spans[rec.cid] = Span(rec.started, self.now, rec.budget)
        self.mgr.complete(rec.ex, self.now)
        if self._mx is not None:
            self._mx.completed.value += 1
        if self._trace is not None:
            self._exec_span(rec, "ok")
        if self.mirror:
            self.mirror.on_complete(rec.cid)
        if self._on_client_done:  # hot path: one load + branch when unused
            for cb in self._on_client_done:
                cb(rec.cid, rec.round_idx)

    def _fail(self, rec: _Active) -> None:
        rnd = self._remove(rec)
        rnd.failed.append(rec.cid)
        self.mgr.fail(rec.ex, self.now)
        if self._mx is not None:
            self._mx.failed.value += 1
        if self._trace is not None:
            self._exec_span(rec, "fail")
        if self.mirror:
            self.mirror.on_fail(rec.cid)

    def _evict(self, rec: _Active) -> None:
        """Availability churn: the client left mid-execution — fail the
        executor and return the client to its round's pending set (it
        re-runs its local work when re-admitted)."""
        rnd = self._remove(rec)
        self.mgr.fail(rec.ex, self.now)
        rnd.sched.requeue(rec.cid)
        self.churn_evictions += 1
        if self._mx is not None:
            self._mx.evicted.value += 1
        if self._trace is not None:
            self._exec_span(rec, "evict")
        if self.mirror:
            self.mirror.on_fail(rec.cid)

    # -- capacity ----------------------------------------------------------

    def _apply_capacity(self, capacity: float, theta: Optional[float] = None,
                        *, shed: bool = False) -> None:
        """The pool's physical capacity changed (elastic event or fabric
        re-grant).  Rates re-waterfill at the next reconcile; with ``shed``
        (elastic semantics) the largest-budget executors are evicted until
        the admitted budget fits, each client requeued into its round's
        pending set — with a degraded slice when its budget no longer fits
        under the (rescaled) θ, so a shrunken pool downsizes a tenant
        instead of starving it.  Callers must follow with an admission
        sweep (``step``/``sweep`` do)."""
        self.capacity = float(capacity)
        if self._mx is not None:
            self._mx.capacity_events.inc()
        if self._trace is not None:
            self._trace.instant("capacity.change", self.now, self.tenant,
                                "rounds",
                                args={"capacity": float(capacity),
                                      "theta": theta})
        if theta is not None:
            self.theta = float(theta)
            for rnd in self._rounds:
                if rnd is not None and not rnd.closed:
                    rnd.sched.theta = float(theta)
                    rnd.sched.renegotiate_pending(float(theta))
        if shed:
            # total_budget is maintained incrementally (and _remove updates
            # it per eviction) — no O(active) re-sum per shed iteration
            while self.active and self.total_budget > self.capacity:
                victim = max(self.active.values(), key=lambda r: r.budget)
                rnd = self._remove(victim)
                self.mgr.fail(victim.ex, self.now)
                cap_theta = rnd.sched.theta
                rnd.sched.requeue(
                    victim.cid,
                    new_budget=(
                        max(cap_theta, 1.0) if victim.budget > cap_theta else None
                    ),
                )
                self.capacity_evictions += 1
                if self._mx is not None:
                    self._mx.evicted.value += 1
                if self._trace is not None:
                    self._exec_span(victim, "shed")
                if self.mirror:
                    self.mirror.on_fail(victim.cid)
        # force the next reconcile through the slow path: it settles against
        # the old rates, re-waterfills against the new capacity, and re-keys
        # every completion entry
        self.contended = True

    def preempt_slot(self, slot: int) -> Optional[int]:
        """A fabric lease on ``slot`` was revoked: evict the executor that
        occupies it and requeue its client (it re-runs its local work when
        re-admitted, like availability churn).  Returns the client id, or
        None when no live executor holds the slot."""
        for rec in self.active.values():
            if rec.ex.slot == slot:
                if self.contended:
                    self._settle_all()
                rnd = self._remove(rec)
                self.mgr.fail(rec.ex, self.now)
                rnd.sched.requeue(rec.cid)
                self.preemptions += 1
                if self._mx is not None:
                    self._mx.preemptions.inc()
                    self._mx.evicted.value += 1
                if self._trace is not None:
                    self._exec_span(rec, "preempt")
                    self._trace.instant("lease.preempt", self.now,
                                        self.tenant, f"slot {slot}",
                                        args={"cid": rec.cid, "slot": slot})
                if self.mirror:
                    self.mirror.on_fail(rec.cid)
                return rec.cid
        return None

    # -- admission ---------------------------------------------------------

    def _admit_sweep(self) -> None:
        while True:
            opened = self._open_due_rounds()
            progressed = False
            for rnd in self._open:
                if rnd.deadline_hit or rnd.sched.done:
                    continue
                entries = rnd.sched.select(
                    (), self.mgr.avail,
                    running_total=self.total_budget,
                )
                for e in entries:
                    self._spawn(rnd, e)
                progressed = progressed or bool(entries)
            if not opened and not progressed:
                break
        self._reconcile()

    def _close_drained(self) -> None:
        for rnd in list(self._open):
            if rnd.n_active == 0 and (rnd.sched.done or rnd.deadline_hit):
                self._close(rnd)

    # -- timeline ----------------------------------------------------------

    def _segment(self, t1: float) -> None:
        if t1 <= self.now or not self.record_timeline:
            return
        seg = TimelineSeg(self.now, t1, self.total_budget, self.total_rate,
                          len(self.active))
        if self.record_campaign_timeline:
            self.timeline.append(seg)
        for rnd in self._open:
            rnd.timeline.append(seg)

    # -- stepping API (the fabric drives N engines under one clock) --------

    def pending(self) -> bool:
        """Rounds still open or queued (heap leftovers alone don't count:
        trailing capacity events after the last round must not fire)."""
        return bool(self._open) or self._next_to_open < len(self._rounds)

    def wants_slots(self) -> bool:
        """Does any open round hold admissible candidates right now?  The
        arbiter uses this to age out stale starvation flags — a tenant
        only blocks others' work-conserving borrowing while it genuinely
        has clients waiting for an executor."""
        return any(
            not rnd.deadline_hit and not rnd.sched.done
            and rnd.sched.pending_live()
            for rnd in self._open
        )

    def _stale(self, entry: tuple) -> bool:
        _t, _prio, _seq, kind, a, b = entry
        if kind == "complete":
            rec = self.active.get(a)
            return rec is None or rec.token != b
        if kind == "fail":
            return a not in self.active
        if kind == "edge":
            rnd = self._rounds[b]
            if rnd is None or a in rnd.spans or a in rnd.failed:
                self._edge_pending.discard((a, b))
                return True  # round closed / client finished — stop tracking
            return False
        if kind == "deadline":
            rnd = self._rounds[a]
            return rnd is None or rnd.deadline_hit
        return False  # capacity events never go stale

    def peek_time(self) -> Optional[float]:
        """Time of this engine's next live event, or ``None``.

        Lazily discards stale heap entries (completions of evicted
        executors, edges of closed rounds, …) while peeking, so the
        returned time is always actionable.  The fabric compares each
        tenant's ``peek_time`` to pick the globally next event; ``None``
        with ``pending()`` True means this engine is waiting on someone
        else's event (e.g. a slot another tenant must free)."""
        while self._heap:
            if self._stale(self._heap[0]):
                heapq.heappop(self._heap)
                continue
            return self._heap[0][0]
        return None

    def advance_to(self, t: float) -> None:
        """Move the clock to ``t`` without dispatching an event of our own
        (another fabric tenant acted at ``t``): closes the running timeline
        segment so utilization accounting stays exact, then sets ``now``.
        Monotonic — a ``t`` at or before the current clock is a no-op."""
        if t > self.now:
            self._segment(t)
            self.now = t

    def sweep(self) -> None:
        """Admit every admissible client at the current instant (opening
        due rounds first), reconcile rates, and close drained rounds.
        Idempotent; the fabric calls it after every arbitration pass so
        freshly freed/granted slots are taken immediately."""
        self._admit_sweep()
        self._close_drained()

    def quiesce(self) -> None:
        """Force-close the open rounds when no event can ever progress
        them (every remaining client parked forever — e.g. its availability
        trace never comes back): the rounds end at the current clock and
        the next queued rounds open.  The fabric's stall-breaker; never
        called while live executors exist."""
        for rnd in list(self._open):
            self._close(rnd)
        self.sweep()

    def step(self) -> bool:
        """Dispatch the single next live event — completion, failure,
        capacity change, availability edge, or deadline — advancing the
        clock to it, then run the admission sweep that event enables.
        Returns False (and does nothing) when the heap holds no live
        event.  ``run_round``/``run_campaign`` are loops over ``step``;
        the fabric interleaves steps of N engines on one merged clock."""
        if self.peek_time() is None:
            return False
        t, _prio, _seq, kind, a, b = heapq.heappop(self._heap)
        self.events_processed += 1
        self._segment(t)
        self.now = t

        if kind == "complete":
            rec = self.active[a]
            if self.contended:
                self._settle_all()
            else:
                rec.remaining = 0.0
                rec.synced = t
            self._complete(rec)
        elif kind == "fail":
            if self.contended:
                self._settle_all()
            self._fail(self.active[a])
        elif kind == "capacity":
            self._apply_capacity(a, theta=b, shed=True)
        elif kind == "edge":
            cid, ridx = a, b
            self._edge_pending.discard((cid, ridx))
            rnd = self._rounds[ridx]
            up = self._is_up(cid)
            eid = rnd.active_eid.get(cid)
            if eid is not None:
                if not up:  # left mid-execution: evict + park until back
                    if self.contended:
                        self._settle_all()
                    self._evict(self.active[eid])
                    rnd.sched.park(cid)
            elif up:
                rnd.sched.unpark(cid)
            else:
                rnd.sched.park(cid)
            self._schedule_edge(cid, ridx)
        else:  # deadline
            rnd = self._rounds[a]
            if self.contended:
                self._settle_all()
            rnd.deadline_hit = True
            for eid in list(rnd.active_eid.values()):
                self._fail(self.active[eid])

        self._admit_sweep()
        self._close_drained()
        return True

    # -- main loop ---------------------------------------------------------

    def _drive(self) -> None:
        self.sweep()
        guard = 10_000 + 100 * self._n_clients_total
        iters = 0
        while self.pending():
            iters += 1
            if iters > guard:
                raise RuntimeError("campaign engine did not converge")
            if self.step():
                continue
            if self.active:
                raise RuntimeError(
                    "campaign stalled: active clients hold zero rate and "
                    "no future event (deadline/churn) can unblock them"
                )
            self.quiesce()
