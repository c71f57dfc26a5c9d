"""FL server: the paper's Fig 4 message protocol as an explicit state machine.

The port of ``repro.fed.server``, pure Python: the same state machine,
session tracking, upload dedup and instruction log, so a scripted message
sequence drives either package's server to the same state.

The paper's server is a long-lived process speaking gRPC to per-client
processes: clients poll with requests; a *status monitor* turns each request
into the next instruction (TRAIN → UPLOAD → TERMINATE), persisting pending
instructions in the per-executor FIFO *record table*; the *determination
module* decides terminate-vs-continue; the *launching module* spawns the
next processes the scheduler picked.

This module ports that protocol 1:1 onto the ``Transport`` seam defined in
``repro_torch.fed.transport``: ``LocalTransport`` (in-process deques) is the
default, ``SerializingTransport`` JSON round-trips every message to prove
the seam is RPC-ready, and a multi-host deployment swaps in a socket
transport with the same ``send/poll`` surface — messages are plain dicts.
The federated trainer and tests drive it; the discrete-event simulator
remains the *timing* authority, this is the *control-plane* authority.
"""
from __future__ import annotations

import itertools
import math
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Optional, Set, Tuple

from repro_torch.fed.transport import (  # noqa: F401  (re-exports: historic home)
    CachedSegments,
    LocalTransport,
    Message,
    MsgType,
    SerializingTransport,
    Transport,
    hydrate_cached,
)
from repro_torch.obs.metrics import Counter


@dataclass(frozen=True)
class RoundPolicy:
    """Quorum-round closing policy shared by every collecting tier.

    A round normally closes when *all* selected clients reported.  With a
    policy installed it may also close **gracefully degraded**: once
    ``deadline_s`` has elapsed since the round opened AND at least
    ``quorum(n)`` of the ``n`` selected clients uploaded, the tier stops
    waiting, aggregates the quorum subset (weights renormalize over the
    survivors exactly as the simulator's straggler-drop path does — the
    mean is taken over folded weight, so dropping a client IS the
    renormalization), and answers the stragglers' next request with
    ``TERMINATE`` reason ``"round_closed"``.  If the deadline passes with
    the quorum still unmet the tier keeps waiting to its hard timeout —
    a quorum policy never *loosens* the existing failure behaviour.
    """

    #: Seconds after round open at which a quorum-satisfying subset wins.
    deadline_s: float
    #: Fraction of selected clients that must have reported (ceil'd).
    quorum_frac: float = 1.0
    #: Absolute floor on reported clients, whatever the fraction says.
    min_clients: int = 1

    def quorum(self, n_selected: int) -> int:
        """Uploads required before the deadline may close the round."""
        return max(int(self.min_clients),
                   int(math.ceil(self.quorum_frac * n_selected)))

    def may_close(self, n_reported: int, n_selected: int,
                  elapsed_s: float) -> bool:
        if n_reported >= n_selected:
            return True           # everyone reported: normal close
        return (elapsed_s >= self.deadline_s
                and n_reported >= self.quorum(n_selected))


class SessionTracker:
    """Per-client session tracking + idempotent-upload bookkeeping.

    A *session* is one logical client lifetime: the token the client put in
    its ``REGISTER`` payload (the socket transport's session nonce, or any
    caller-chosen string).  A ``REGISTER`` with a *new* token means the
    client process restarted — the old session's in-flight state is moot.

    ``note_upload`` is the duplicate-aggregation guard: an ``UPLOAD``
    tagged with a ``round`` the client already uploaded for is reported as
    a duplicate, so a resend that slipped past transport-level dedup (or a
    replay from a restarted client) is dropped *before* the aggregation
    hook runs.  Untagged uploads (no ``round`` key — e.g. the simulation
    mirror's) are never deduplicated here: the transport owns that case.

    Session state is bounded two ways (a long-lived server must not keep
    dead-session state forever — ROADMAP "multihost hardening"):

    * a client restart (``REGISTER`` with a *new* token) frees the old
      lifetime's per-round upload set — transport-level sequence dedup
      owns replays *within* a session, and the round-scoped collection
      protocol (``FLServer._ready_parked`` + the per-round ``uploads``
      dict) keeps aggregation exactly-once across lifetimes;
    * with a ``ttl``, :meth:`sweep` (run by ``FLServer.step`` and on
      every handshake-analog ``REGISTER``) evicts all state for clients
      not heard from within ``ttl`` seconds of the monotonic ``clock``;
    * :meth:`prune_rounds` drops upload tags for rounds below the one
      being collected (the dispatcher calls it at each round start).
    """

    def __init__(self, ttl: Optional[float] = None, clock=time.monotonic,
                 obs=None, *, heartbeat_interval: Optional[float] = None,
                 missed_beats: int = 3):
        self.ttl = ttl
        self.clock = clock
        self.heartbeat_interval = heartbeat_interval
        self.missed_beats = max(1, int(missed_beats))
        self.session_of: Dict[int, str] = {}
        self.uploaded_rounds: Dict[int, Set[Any]] = {}
        self.last_seen: Dict[int, float] = {}
        self._trace = (obs.tracer if obs is not None and obs.tracer.enabled
                       else None)
        if obs is not None:
            # scope "control": the control-plane tracker's lifecycle counts,
            # distinct from the socket transport's same-named counters
            # (scope "server") — the legacy integer surfaces on each object
            # must keep reporting only their own events
            reg = obs.registry
            self._restarts = reg.counter("server.restarts", "control")
            self._dups = reg.counter("server.duplicate_uploads_dropped",
                                     "control")
            self._evicted = reg.counter("server.sessions_evicted", "control")
            self._dead = reg.counter("wire.sessions_dead", "control")
        else:
            self._restarts = Counter()
            self._dups = Counter()
            self._evicted = Counter()
            self._dead = Counter()

    # legacy integer surface, now backed by the registry primitive — the
    # setters keep ``tracker.restarts += 1``-style call sites working
    @property
    def restarts(self) -> int:
        return int(self._restarts.value)

    @restarts.setter
    def restarts(self, v: int) -> None:
        self._restarts.reset(int(v))

    @property
    def duplicate_uploads_dropped(self) -> int:
        return int(self._dups.value)

    @duplicate_uploads_dropped.setter
    def duplicate_uploads_dropped(self, v: int) -> None:
        self._dups.reset(int(v))

    @property
    def sessions_evicted(self) -> int:
        return int(self._evicted.value)

    @sessions_evicted.setter
    def sessions_evicted(self, v: int) -> None:
        self._evicted.reset(int(v))

    @property
    def sessions_dead(self) -> int:
        return int(self._dead.value)

    def touch(self, cid: int) -> None:
        """Record liveness for the TTL sweep and the heartbeat reaper."""
        self.last_seen[cid] = self.clock()

    def _evict(self, cid: int, *, reason: str, dead: bool) -> None:
        """THE single eviction path — TTL idle reclamation and the
        liveness reaper both land here so the ``session.evict`` /
        ``session.dead`` events and their counters cannot drift apart."""
        self.session_of.pop(cid, None)
        self.uploaded_rounds.pop(cid, None)
        self.last_seen.pop(cid, None)
        (self._dead if dead else self._evicted).inc()
        if self._trace is not None:
            self._trace.wall_instant(
                "session.dead" if dead else "session.evict", "control",
                f"session {cid}", args={"client_id": cid, "reason": reason})

    def sweep(self) -> List[int]:
        """Run both reclamation passes; returns the evicted ids.

        * **TTL idle eviction** (``ttl``): state for clients not heard
          from in ``ttl`` seconds is reclaimed — bookkeeping hygiene.
        * **Liveness reaping** (``heartbeat_interval``): a client silent
          past ``heartbeat_interval * missed_beats`` is declared *dead*
          — counted ``wire.sessions_dead`` and traced ``session.dead``,
          distinct from idle eviction, because a dead client may be
          mid-round and the quorum policy wants to know.
        """
        now = self.clock()
        gone: List[int] = []
        if self.heartbeat_interval is not None:
            cutoff = self.heartbeat_interval * self.missed_beats
            for cid in [c for c, t in self.last_seen.items()
                        if now - t > cutoff]:
                self._evict(cid, reason="missed_heartbeats", dead=True)
                gone.append(cid)
        if self.ttl is not None:
            for cid in [c for c, t in self.last_seen.items()
                        if now - t > self.ttl]:
                self._evict(cid, reason="ttl_idle", dead=False)
                gone.append(cid)
        return gone

    def live_clients(self, within: Optional[float] = None) -> Set[int]:
        """Clients heard from within ``within`` seconds (default: the
        liveness cutoff, or TTL, or everything known)."""
        if within is None:
            if self.heartbeat_interval is not None:
                within = self.heartbeat_interval * self.missed_beats
            elif self.ttl is not None:
                within = self.ttl
            else:
                return set(self.last_seen)
        now = self.clock()
        return {c for c, t in self.last_seen.items() if now - t <= within}

    def prune_rounds(self, active_round: Any) -> None:
        """Drop upload-dedup tags for rounds before ``active_round``
        (int-tagged only): closed rounds can never be uploaded for again,
        so their tags are pure growth."""
        if not isinstance(active_round, int):
            return
        for cid, rounds in self.uploaded_rounds.items():
            stale = {r for r in rounds if isinstance(r, int) and r < active_round}
            if stale:
                rounds -= stale

    def note_register(self, cid: int, token: Optional[str]) -> bool:
        """Record the session a REGISTER arrived on.  Returns True when it
        replaces a *different* live session (client restart) — the old
        lifetime's state is freed.  Also runs the TTL sweep: REGISTER is
        the control-plane analog of a transport handshake."""
        self.touch(cid)
        self.sweep()
        if token is None:
            return False
        prev = self.session_of.get(cid)
        self.session_of[cid] = token
        if prev is not None and prev != token:
            self._restarts.inc()
            self.uploaded_rounds.pop(cid, None)  # old lifetime freed
            return True
        return False

    def is_duplicate_upload(self, cid: int, rnd: Any) -> bool:
        """Pure check: was (cid, round) already *accepted*?  Untagged
        uploads (rnd None) are never duplicates here."""
        return rnd is not None and rnd in self.uploaded_rounds.get(cid, ())

    def record_upload(self, cid: int, rnd: Any) -> None:
        """Record an ACCEPTED upload for (cid, round).  Called from the
        aggregation path only — an upload the state machine rejects must
        not poison the dedup set, or the later legitimate upload for the
        round would be dropped."""
        if rnd is not None:
            self.uploaded_rounds.setdefault(cid, set()).add(rnd)


class StatusMonitor:
    """Request → instruction state machine (paper Fig 4).

    States per client: registered → training → uploading → done.

    ``train_payload_provider`` (optional) supplies extra fields for every
    ``TRAIN`` instruction — the distributed trainer uses it to ship the
    current global parameters and the server-decided ``local_steps`` to
    remote workers (see ``repro_torch.launch.multihost``).
    """

    def __init__(
        self,
        aggregation_hook: Callable[[int, Dict[str, Any]], None],
        train_payload_provider: Optional[Callable[[int], Dict[str, Any]]] = None,
    ):
        self.state: Dict[int, str] = {}
        self.aggregation_hook = aggregation_hook
        self.train_payload_provider = train_payload_provider
        self.log: List[Tuple[int, MsgType, str]] = []

    def handle(self, msg: Message) -> Message:
        cid = msg.client_id
        st = self.state.get(cid, "new")
        if msg.kind is MsgType.REGISTER:
            self.state[cid] = "registered"
            out = Message(MsgType.WAIT, cid)
        elif msg.kind is MsgType.READY and st in ("registered", "new"):
            self.state[cid] = "training"
            payload = {"local_steps": msg.payload.get("local_steps", 1)}
            if self.train_payload_provider is not None:
                payload.update(self.train_payload_provider(cid))
            out = Message(MsgType.TRAIN, cid, payload)
        elif msg.kind is MsgType.TRAIN_DONE and st == "training":
            self.state[cid] = "uploading"
            out = Message(MsgType.SEND_UPDATE, cid)
        elif msg.kind is MsgType.UPLOAD and st == "uploading":
            self.aggregation_hook(cid, msg.payload)
            self.state[cid] = "done"
            # determination module: client finished -> terminate its process
            out = Message(MsgType.TERMINATE, cid)
        elif msg.kind is MsgType.PARTIAL_SUM and st in ("training", "uploading"):
            # hierarchy tier protocol: a leaf aggregator ships its folded
            # partial straight after TRAIN — no TRAIN_DONE/SEND_UPDATE
            # round-trip, the partial IS the round's terminal request
            self.aggregation_hook(cid, msg.payload)
            self.state[cid] = "done"
            out = Message(MsgType.TERMINATE, cid)
        elif msg.kind is MsgType.HEARTBEAT:
            out = Message(MsgType.WAIT, cid)
        elif msg.kind is MsgType.ABORT:
            # determination module: failed/evicted client -> terminate its
            # process; it may REGISTER again later (re-admission).
            self.state[cid] = "failed"
            out = Message(MsgType.TERMINATE, cid, {"reason": "abort"})
        else:  # protocol violation -> terminate defensively
            out = Message(MsgType.TERMINATE, cid, {"reason": f"bad {msg.kind} in {st}"})
        self.log.append((cid, msg.kind, self.state.get(cid, "?")))
        return out


class FLServer:
    """Long-lived control plane: record table + status monitor + launcher.

    Round-scoped extensions used by the distributed trainer
    (``repro_torch.launch.multihost``):

    * ``participants`` — when set, a ``READY`` from a client outside the
      set is answered ``WAIT`` *without* advancing its state machine, so
      non-selected workers idle through the round and are eligible again
      the moment the next round's set is installed.
    * ``train_payload`` — merged into every ``TRAIN`` instruction (global
      params, server-decided ``local_steps``, round tag).
    * ``sessions`` — :class:`SessionTracker`: per-client session tokens
      (from ``REGISTER`` payloads) plus the (client, round) upload-dedup
      guard, so a duplicated/replayed ``UPLOAD`` is never aggregated
      twice.  ``session_ttl`` bounds dead-session state: clients not
      heard from within the TTL are swept on ``step``/``REGISTER``.
    """

    def __init__(self, transport: Optional[Transport] = None, *,
                 session_ttl: Optional[float] = None, clock=time.monotonic,
                 obs=None, heartbeat_interval: Optional[float] = None,
                 missed_beats: int = 3, wal=None):
        self.transport = transport or LocalTransport()
        self.sessions = SessionTracker(ttl=session_ttl, clock=clock, obs=obs,
                                       heartbeat_interval=heartbeat_interval,
                                       missed_beats=missed_beats)
        #: Optional :class:`repro_torch.fed.wal.RoundJournal` — when set, every
        #: ACCEPTED upload is journaled *before* it mutates round state,
        #: so a killed-and-restarted server resumes via ``restore_from_wal``
        #: with no client re-upload (the dedup floor is restored too).
        self.wal = wal
        self.uploads: Dict[int, Dict[str, Any]] = {}
        self.train_payload: Dict[str, Any] = {}
        self.participants: Optional[Set[int]] = None
        self.monitor = StatusMonitor(
            self._on_upload, train_payload_provider=lambda cid: self.train_payload
        )
        # record table: pending instructions per executor row (paper Fig 4)
        self.record_table: Dict[int, Deque[Message]] = {}
        self._row_of: Dict[int, int] = {}
        self._rows = itertools.count()
        # hierarchy extensions (repro_torch.fed.hier sets them: its leaf
        # and root aggregators): ``cached_payloads`` maps
        # an instruction kind to pre-extracted v2 segments — the
        # instruction's own payload rides as the per-send extra, the
        # heavy tensors are framed once.  ``on_instruction`` lets a node
        # expand one instruction into several (the root prepends a
        # content-addressed PARAMS_CHUNK to each TRAIN).
        self.cached_payloads: Dict[MsgType, CachedSegments] = {}
        self.on_instruction: Optional[Callable[[Message], List[Message]]] = None

    def _on_upload(self, cid: int, payload: Dict[str, Any]) -> None:
        # runs only for uploads the state machine ACCEPTED — this is the
        # one place the (cid, round) dedup set may grow.  Write-ahead:
        # journal first, then mutate, so a crash between the two replays
        # the upload instead of losing it.
        if self.wal is not None:
            self.wal.upload(cid, payload)
        self.sessions.record_upload(cid, payload.get("round"))
        self.uploads[cid] = payload

    def restore_from_wal(self, recovery) -> int:
        """Adopt a :class:`repro_torch.fed.wal.WalRecovery`: re-apply the open
        round's accepted uploads and the whole-journal ``(cid, round)``
        dedup floor.  Returns the number of uploads restored.  The caller
        re-installs ``train_payload``/``participants`` for the resumed
        round before serving."""
        for cid, rounds in recovery.uploaded_rounds.items():
            self.sessions.uploaded_rounds.setdefault(cid, set()).update(rounds)
        live = recovery.open_round
        if live is None:
            return 0
        for cid, payload in live.uploads:
            self.uploads[cid] = payload
            self.monitor.state[cid] = "done"
        return len(live.uploads)

    def launch(self, client_id: int) -> int:
        """Launching module: bind a fresh executor row to a client."""
        row = next(self._rows)
        self.record_table[row] = deque()
        self._row_of[client_id] = row
        return row

    def step(self) -> int:
        """Drain pending requests; returns number processed."""
        self.sessions.sweep()   # no-op without a session_ttl
        n = 0
        while True:
            msg = self.transport.poll_server()
            if msg is None:
                return n
            n += 1
            cid = msg.client_id
            self.sessions.touch(cid)
            if msg.kind is MsgType.REGISTER:
                self.sessions.note_register(cid, msg.payload.get("session"))
            if (msg.kind in (MsgType.UPLOAD, MsgType.PARTIAL_SUM)
                    and self.sessions.is_duplicate_upload(cid, msg.payload.get("round"))):
                # duplicate upload for a round already aggregated: never
                # reaches the aggregation hook, but the client still gets
                # its terminal instruction (its round is over either way)
                self.sessions.duplicate_uploads_dropped += 1
                out = Message(MsgType.TERMINATE, cid, {"reason": "duplicate_upload"})
            elif msg.kind is MsgType.READY and self._ready_parked(cid):
                # not selected this round (or already uploaded for it):
                # park the worker without touching its state machine, so
                # it stays eligible the moment the next round opens
                out = Message(MsgType.WAIT, cid, {"reason": "not_selected"})
            else:
                out = self.monitor.handle(msg)
            row = self._row_of.get(cid)
            if row is None:
                row = self.launch(cid)
            outs = ([out] if self.on_instruction is None
                    else list(self.on_instruction(out)))
            for o in outs:
                self.record_table[row].append(o)   # persist instruction
                self._send_instruction(o)          # issue instruction

    def _send_instruction(self, o: Message) -> None:
        """Issue one instruction, through the cached-segment fast path
        when its kind has a precomputed payload: a transport exposing
        ``send_to_client_cached`` stamps only the small header per send;
        any other destination gets an equivalent plain message with the
        cached tensors hydrated back in (bit-identical payload either
        way)."""
        cached = self.cached_payloads.get(o.kind)
        if cached is not None:
            send_cached = getattr(self.transport, "send_to_client_cached", None)
            if send_cached is not None:
                send_cached(o.client_id, o.kind, cached,
                            extra_payload=o.payload)
                return
            o = Message(o.kind, o.client_id,
                        {**hydrate_cached(cached), **o.payload})
        self.transport.send_to_client(o)

    def _ready_parked(self, cid: int) -> bool:
        """Should this READY be parked (WAIT) instead of starting training?
        True when a participant set is installed and the client is outside
        it, or when the client already uploaded for the round currently
        being collected (a fast finisher re-registering mid-round must not
        be handed the same round's TRAIN twice)."""
        if self.participants is None:
            return False
        if cid not in self.participants:
            return True
        rnd = self.train_payload.get("round")
        return rnd is not None and rnd in self.sessions.uploaded_rounds.get(cid, ())

    def client_done(self, client_id: int) -> bool:
        return self.monitor.state.get(client_id) == "done"

    def broadcast_shutdown(self, client_ids=None) -> int:
        """Send every known (or given) client a ``TERMINATE`` with reason
        ``"shutdown"`` — the end-of-campaign teardown signal a multihost
        worker exits on (a plain ``TERMINATE`` only ends its round)."""
        cids = list(client_ids) if client_ids is not None else list(self.monitor.state)
        for cid in cids:
            self.transport.send_to_client(
                Message(MsgType.TERMINATE, cid, {"reason": "shutdown"})
            )
        return len(cids)


def run_client_session(
    server: FLServer,
    client_id: int,
    train_fn: Callable[[int], Dict[str, Any]],
    *,
    local_steps: int = 1,
    max_polls: int = 20,
) -> bool:
    """Client-side loop: poll-for-instruction until TERMINATE (paper: the
    client 'jumps out of the request loop' on the terminate signal)."""
    t = server.transport
    result: Dict[str, Any] = {}
    trained = False
    t.send_to_server(Message(MsgType.REGISTER, client_id))
    server.step()
    t.poll_client(client_id)  # WAIT
    t.send_to_server(Message(MsgType.READY, client_id, {"local_steps": local_steps}))
    for _ in range(max_polls):
        server.step()
        inst = t.poll_client(client_id)
        if inst is None:
            continue
        if inst.kind is MsgType.TRAIN:
            result = train_fn(inst.payload["local_steps"])
            trained = True
            t.send_to_server(Message(MsgType.TRAIN_DONE, client_id))
        elif inst.kind is MsgType.SEND_UPDATE:
            # A duplicate/reordered SEND_UPDATE before any TRAIN must not
            # crash the loop: upload what we have (nothing) and let the
            # status monitor's protocol-violation path TERMINATE us.
            t.send_to_server(Message(
                MsgType.UPLOAD, client_id,
                result if trained else {},
            ))
        elif inst.kind is MsgType.TERMINATE:
            return True
        else:  # WAIT
            t.send_to_server(Message(MsgType.HEARTBEAT, client_id))
    return False
