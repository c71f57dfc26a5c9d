"""repro_torch.fed.net — the multi-host socket transport.

The port of ``repro.fed.net``, pure Python over the port's codec: a socket
transport of either package talks to the other's (same handshake, frames,
sequence numbers and acks).

``SocketServerTransport`` and ``SocketClientTransport`` implement the
4-method :class:`repro_torch.fed.transport.Transport` surface over TCP, carrying
the negotiated wire format (v2 binary tensor framing by default, v1 JSON
fallback) in length-prefixed frames (see ``docs/wire-protocol.md`` for the
normative spec).  Connection lifecycle is first-class:

* **Handshake + version negotiation** — the first frame each way
  exchanges magic, the versions each side accepts, client id and a
  session token; the server picks the highest common wire version (the
  hello itself is always JSON, so any two versions can negotiate), and
  no common version is refused before any session state is allocated.
* **Timeouts** — connect/send/receive timeouts are configurable; a client
  ``poll_client`` blocks at most ``recv_timeout`` before returning None.
* **Reconnect** — a client that loses its connection retries with bounded
  exponential backoff, presenting the same session token; the server
  resumes the session instead of creating a new one.
* **Idempotent delivery** — every message carries a per-session sequence
  number and a piggybacked cumulative ack.  Unacked messages are buffered
  and retransmitted after reconnect; the receiver drops any sequence number
  it has already seen, so a resent ``UPLOAD`` is deduplicated server-side
  and a resent instruction client-side.  Exactly-once delivery per session,
  both directions.
* **Teardown** — ``close()`` is clean on both ends; a dying client can
  ``close(send_abort=True)`` to put an ``ABORT`` on the wire first, and the
  server unbinds the dead connection while keeping session state for a
  possible reconnect.  An optional ``session_ttl`` sweeps sessions that
  have been disconnected longer than the TTL (checked at every
  handshake), so a long-lived server does not accumulate dead-session
  state forever.

Byte accounting is split: ``wire_bytes`` counts framed bytes (length
prefix included) both directions, ``payload_bytes`` the tensor-segment
share of them, ``header_bytes`` the rest — per transport and, on the
server, per client session (``session_stats``).

``ChaosProxy`` is the loopback fault-injection harness: a frame-aware TCP
proxy that can kill connections mid-session, delay frames, and duplicate
frames — the tests drive the reconnect/dedup machinery through it.  It
forwards frame bodies verbatim (never transcodes), so v2 binary frames
survive it bit-for-bit.
"""
from __future__ import annotations

import json
import queue
import selectors
import socket
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.fed.transport import (
    CachedSegments,
    EncodedEnvelope,
    FrameDecoder,
    Message,
    MsgType,
    ProtocolError,
    WireCounters,
    check_hello,
    decode_wire_body,
    default_accept_versions,
    default_protocol_version,
    default_session_key,
    encode_envelope_cached,
    encode_envelope_wire,
    encode_frame,
    encode_frame_raw,
    hydrate_cached,
    make_client_hello,
    make_error_hello,
    make_server_hello,
    negotiate_version,
    parse_envelope,
    verify_session_auth,
)
from repro_torch.obs.metrics import Counter

__all__ = [
    "SocketClientTransport",
    "SocketServerTransport",
    "AsyncSocketServerTransport",
    "ChaosProxy",
    "FaultPlan",
    "FaultEvent",
    "FaultSchedule",
    "TransportClosed",
    "TransportDead",
]


class TransportClosed(RuntimeError):
    """The transport was closed locally; no further sends/polls allowed."""


class TransportDead(ConnectionError):
    """The client transport exhausted its reconnect budget: the server is
    gone for good (as far as this process can tell).  Subclasses
    ``ConnectionError`` so existing handlers keep working; typed so
    ``launch.multihost`` workers can exit cleanly instead of crashing."""


def _recv_chunk(sock: socket.socket, timeout: Optional[float]) -> Optional[bytes]:
    """One recv with a timeout. Returns b'' on EOF, None on timeout."""
    sock.settimeout(timeout)
    try:
        return sock.recv(65536)
    except socket.timeout:
        return None


def _close_conn(sock: Optional[socket.socket]) -> None:
    """Shutdown + close: a bare close() on a socket another thread is
    blocked reading leaves the file description (and the TCP connection)
    alive; shutdown wakes the reader with EOF first."""
    if sock is None:
        return
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


# --------------------------------------------------------------------------
# Client side
# --------------------------------------------------------------------------


class SocketClientTransport:
    """Client end of the wire: one TCP connection to the FL server.

    Implements the client half of the ``Transport`` surface
    (``send_to_server`` / ``poll_client``); the server half raises.  All
    lifecycle behavior (handshake, version negotiation, reconnect,
    retransmission, dedup) is internal — callers just send and poll.
    ``wire_version`` is the negotiated session version after connect.
    """

    def __init__(
        self,
        host: str,
        port: int,
        client_id: int,
        *,
        connect_timeout: float = 5.0,
        send_timeout: float = 5.0,
        recv_timeout: float = 0.2,
        reconnect_base: float = 0.05,
        reconnect_max: float = 2.0,
        max_reconnect_attempts: int = 10,
        protocol_version: Optional[int] = None,
        accept_versions: Optional[Sequence[int]] = None,
        deflate: Optional[bool] = None,
        session_key: Optional[bytes] = None,
        heartbeat_interval: Optional[float] = None,
        obs=None,
        sleep=time.sleep,
    ):
        self.host, self.port = host, int(port)
        self.client_id = int(client_id)
        self.heartbeat_interval = heartbeat_interval
        # injectable for deterministic backoff tests (a test
        # passes a recording fake so the suite never really sleeps)
        self._sleep = sleep
        self.session = uuid.uuid4().hex
        # None defers to FEDHC_SESSION_KEY inside make_client_hello; an
        # explicit key (tests, multi-tenant configs) wins over the env
        self.session_key = session_key
        self.connect_timeout = connect_timeout
        self.send_timeout = send_timeout
        self.recv_timeout = recv_timeout
        self.reconnect_base = reconnect_base
        self.reconnect_max = reconnect_max
        self.max_reconnect_attempts = int(max_reconnect_attempts)
        self.protocol_version = (default_protocol_version()
                                 if protocol_version is None
                                 else int(protocol_version))
        self.accept_versions = tuple(
            accept_versions if accept_versions is not None
            else default_accept_versions(self.protocol_version)
        )
        self.deflate = deflate
        self.wire_version = self.protocol_version  # until negotiated

        self._sock: Optional[socket.socket] = None
        self._decoder = FrameDecoder(raw=True)
        self._pending: List[Message] = []      # decoded instructions
        self._send_seq = 0                     # last seq assigned to our msgs
        self._recv_seq = 0                     # last server seq received
        self._outbox: List[Tuple[int, Message]] = []   # unacked sends
        self._closed = False
        self._lock = threading.Lock()

        # observability (sent-frame counters; see docs/wire-protocol.md) —
        # on the shared repro_torch.obs counter primitive, registry-aliased when
        # an ObsPlane is provided
        scope = f"client:{self.client_id}"
        self._wirec = WireCounters(obs=obs, scope=scope)
        reg = obs.registry if obs is not None else None
        self._m_reconnects = reg.counter("wire.reconnects", scope) \
            if reg else Counter()
        self._m_dups = reg.counter("wire.duplicates_dropped", scope) \
            if reg else Counter()

        self._connect(first=True)

        # liveness: while a heartbeat interval is set, a daemon thread puts
        # a HEARTBEAT on the wire whenever the session has been quiet —
        # ordinary traffic already proves liveness, the beat only covers
        # long silences (e.g. a slow local training step); the server-side
        # reaper (missed-beat threshold) declares silent sessions dead
        self._hb_thread: Optional[threading.Thread] = None
        if heartbeat_interval is not None:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop,
                name=f"fedhc-hb-{self.client_id}", daemon=True)
            self._hb_thread.start()

    def _heartbeat_loop(self) -> None:
        assert self.heartbeat_interval is not None
        while not self._closed:
            deadline = time.monotonic() + self.heartbeat_interval
            while time.monotonic() < deadline:
                if self._closed:
                    return
                time.sleep(min(0.05, self.heartbeat_interval))
            try:
                self.send_to_server(Message(MsgType.HEARTBEAT, self.client_id))
            except (TransportClosed, ConnectionError, ProtocolError, OSError):
                return  # dead or closed: the beat's job is over

    # legacy counter surface (unchanged values, now counter-backed)
    @property
    def wire_bytes(self) -> int:
        return int(self._wirec.framed.value)

    @property
    def payload_bytes(self) -> int:
        return int(self._wirec.payload.value)

    @property
    def header_bytes(self) -> int:
        return int(self._wirec.header.value)

    @property
    def messages_encoded(self) -> int:
        return int(self._wirec.messages.value)

    @property
    def reconnects(self) -> int:
        return int(self._m_reconnects.value)

    @property
    def duplicates_dropped(self) -> int:
        return int(self._m_dups.value)

    # -- connection lifecycle ---------------------------------------------

    def _connect(self, first: bool = False) -> None:
        """Dial, handshake (negotiating the wire version), and retransmit
        unacked messages.  Bounded exponential backoff between attempts;
        raises ``ConnectionError`` when the budget is exhausted."""
        last_err: Optional[Exception] = None
        for attempt in range(self.max_reconnect_attempts):
            if self._closed:
                raise TransportClosed("transport closed during reconnect")
            sock: Optional[socket.socket] = None
            try:
                sock = socket.create_connection(
                    (self.host, self.port), timeout=self.connect_timeout
                )
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                hello = encode_frame(make_client_hello(
                    self.client_id, self.session, self._recv_seq,
                    version=self.protocol_version,
                    accept=self.accept_versions,
                    auth_key=self.session_key,
                ))
                sock.settimeout(self.send_timeout)
                sock.sendall(hello)
                dec = FrameDecoder(raw=True)
                reply, extras = self._read_handshake(sock, dec)
                self.wire_version = check_hello(
                    reply, accept_versions=self.accept_versions
                )
                server_recv = int(reply.get("recv_seq", 0))
                if not reply.get("resumed", False):
                    # the server allocated a FRESH session (first connect, or
                    # our old session state is gone server-side): its send
                    # sequence restarts at 1, so our dedup floor must too —
                    # otherwise every new instruction would be dropped
                    self._recv_seq = 0
                self._sock = sock
                # the handshake decoder carries any bytes that arrived right
                # behind the hello (retransmitted instructions, possibly a
                # partial frame) — it IS the stream decoder from here on
                self._decoder = dec
                if not first:
                    self._m_reconnects.inc()
                for body in extras:
                    self._ingest(body)
                # drop acked sends, retransmit the rest in order
                self._outbox = [(s, m) for s, m in self._outbox if s > server_recv]
                for seq, msg in self._outbox:
                    self._write_envelope(seq, msg)
                return
            except ProtocolError:
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                raise  # version/magic mismatch is fatal, never retried
            except OSError as e:
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                last_err = e
                delay = min(self.reconnect_base * (2 ** attempt), self.reconnect_max)
                self._sleep(delay)
        raise TransportDead(
            f"client {self.client_id}: gave up after "
            f"{self.max_reconnect_attempts} connection attempts: {last_err}"
        )

    def _read_handshake(
        self, sock: socket.socket, dec: FrameDecoder
    ) -> Tuple[Dict[str, Any], List[bytes]]:
        """Read frames until the server hello is complete; returns it plus
        any stream frame *bodies* that arrived behind it (``dec`` keeps
        buffering a trailing partial frame, so nothing on the wire is
        lost).  Hellos are always JSON regardless of wire version."""
        deadline = time.monotonic() + self.connect_timeout
        while True:
            chunk = _recv_chunk(sock, max(deadline - time.monotonic(), 0.01))
            if chunk == b"":
                raise OSError("connection closed during handshake")
            if chunk is None:
                raise OSError("handshake timed out")
            bodies = dec.feed(chunk)
            if bodies:
                return json.loads(bodies[0]), bodies[1:]

    def _write_envelope(self, seq: int, msg: Message) -> None:
        enc = encode_envelope_wire(seq, self._recv_seq, msg,
                                   version=self.wire_version,
                                   deflate=self.deflate)
        self._wirec.account(enc)
        assert self._sock is not None
        self._sock.settimeout(self.send_timeout)
        self._sock.sendall(enc.data)

    def _drop_connection(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    # -- Transport surface (client half) ----------------------------------

    def send_to_server(self, msg: Message) -> None:
        """Assign the next session sequence number, buffer until acked,
        and transmit (reconnecting once if the connection is dead)."""
        with self._lock:
            if self._closed:
                raise TransportClosed("send after close")
            self._send_seq += 1
            seq = self._send_seq
            self._outbox.append((seq, msg))
            try:
                if self._sock is None:
                    raise OSError("not connected")
                self._write_envelope(seq, msg)
            except OSError:
                self._drop_connection()
                # _connect retransmits the whole unacked outbox, msg included
                self._connect()

    def poll_client(self, client_id: int) -> Optional[Message]:
        """Next instruction for this client, or None after ``recv_timeout``.
        Duplicated frames (retransmission races) are dropped here."""
        if client_id != self.client_id:
            raise ValueError(
                f"this socket belongs to client {self.client_id}, not {client_id}"
            )
        with self._lock:
            if self._closed:
                raise TransportClosed("poll after close")
            if self._pending:
                return self._pending.pop(0)
            if self._sock is None:
                self._connect()
            try:
                chunk = _recv_chunk(self._sock, self.recv_timeout)
            except OSError:
                chunk = b""
            if chunk is None:          # timeout: nothing for us right now
                return None
            if chunk == b"":           # peer dropped us: reconnect + resume
                self._drop_connection()
                self._connect()
                return None
            for body in self._decoder.feed(chunk):
                self._ingest(body)
            return self._pending.pop(0) if self._pending else None

    def _ingest(self, body: bytes) -> None:
        frame, _payload_bytes = decode_wire_body(body)
        seq, ack, msg = parse_envelope(frame)
        self._outbox = [(s, m) for s, m in self._outbox if s > ack]
        if seq <= self._recv_seq:
            self._m_dups.inc()
            return
        self._recv_seq = seq
        self._pending.append(msg)

    # the server half of the Transport protocol is not this object's side
    def send_to_client(self, msg: Message) -> None:
        raise RuntimeError("SocketClientTransport is the client end of the wire")

    def poll_server(self) -> Optional[Message]:
        raise RuntimeError("SocketClientTransport is the client end of the wire")

    # -- teardown ----------------------------------------------------------

    def close(self, *, send_abort: bool = False) -> None:
        """Clean teardown.  ``send_abort=True`` puts an ``ABORT`` on the
        wire first (the dying-client path), best-effort."""
        with self._lock:
            if self._closed:
                return
            if send_abort and self._sock is not None:
                try:
                    self._send_seq += 1
                    self._write_envelope(
                        self._send_seq, Message(MsgType.ABORT, self.client_id)
                    )
                except OSError:
                    pass
            self._closed = True
            self._drop_connection()


# --------------------------------------------------------------------------
# Server side
# --------------------------------------------------------------------------


class _Session:
    """Server-side state for one client's logical lifetime (survives
    reconnects; replaced when the client presents a new session token)."""

    def __init__(self, client_id: int, token: str, version: int):
        self.client_id = client_id
        self.token = token
        self.version = int(version)             # negotiated wire version
        self.recv_seq = 0                       # last client seq received
        self.send_seq = 0                       # last seq assigned to sends
        self.outbox: List[Tuple[int, bytes, Message]] = []  # unacked sends
        self.conn: Optional[socket.socket] = None
        self.lock = threading.Lock()
        self.last_seen = 0.0                    # monotonic, for TTL sweeps
        # standalone counters on the shared primitive — deliberately NOT
        # registry-aliased: a new session token must start at zero, while
        # a registry scope would get-or-create the old lifetime's counters
        self.wire = WireCounters()
        # last STATS blob the worker piggybacked on an upload envelope
        self.peer_stats: Dict[str, Any] = {}


class SocketServerTransport:
    """Server end of the wire: listens, accepts N clients, routes frames.

    Implements the server half of the ``Transport`` surface
    (``poll_server`` / ``send_to_client``).  An accept thread performs the
    handshake (negotiating the session wire version) for each incoming
    connection and hands it to a per-connection reader thread; decoded
    requests land in one FIFO inbox that ``poll_server`` drains
    non-blockingly (so ``FLServer.step`` keeps its exact semantics).
    ``send_to_client`` never raises on a dead connection — the instruction
    stays in the session outbox and is retransmitted when the client
    reconnects.  Sessions for clients that stay disconnected longer than
    ``session_ttl`` are evicted at the next handshake.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        handshake_timeout: float = 5.0,
        send_timeout: float = 5.0,
        protocol_version: Optional[int] = None,
        accept_versions: Optional[Sequence[int]] = None,
        deflate: Optional[bool] = None,
        session_ttl: Optional[float] = None,
        heartbeat_interval: Optional[float] = None,
        missed_beats: int = 3,
        clock=time.monotonic,
        session_key: Optional[bytes] = None,
        obs=None,
    ):
        self.handshake_timeout = handshake_timeout
        self.send_timeout = send_timeout
        # HMAC session auth: with a key (explicit or FEDHC_SESSION_KEY),
        # every client hello must carry a valid signature
        self.session_key = (default_session_key() if session_key is None
                            else (session_key or None))
        self.obs = obs
        self._trace = obs.tracer if obs is not None and obs.tracer.enabled \
            else None
        self.protocol_version = (default_protocol_version()
                                 if protocol_version is None
                                 else int(protocol_version))
        self.accept_versions = tuple(
            accept_versions if accept_versions is not None
            else default_accept_versions(self.protocol_version)
        )
        self.deflate = deflate
        self.session_ttl = session_ttl
        # liveness reaper: a session (connected or not) with no traffic for
        # ``heartbeat_interval * missed_beats`` is declared DEAD — distinct
        # from TTL eviction, which only reclaims *disconnected* idle state
        self.heartbeat_interval = heartbeat_interval
        self.missed_beats = max(1, int(missed_beats))
        self.clock = clock
        self._last_sweep = clock()
        sweepable = [x for x in (session_ttl, heartbeat_interval)
                     if x is not None]
        self._sweep_every = min(sweepable) / 4.0 if sweepable else None

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, int(port)))
        self._listener.listen(128)
        self.host, self.port = self._listener.getsockname()[:2]

        self._inbox: "queue.SimpleQueue[Message]" = queue.SimpleQueue()
        self._sessions: Dict[int, _Session] = {}
        self._lock = threading.Lock()
        # guards the byte counters (global + per-session): they are bumped
        # from concurrent per-connection reader threads and the send path
        self._stats_lock = threading.Lock()
        self._closed = False

        # observability — all counters on the shared repro_torch.obs primitive,
        # registry-aliased (scope "server") when an ObsPlane is provided
        reg = obs.registry if obs is not None else None
        self._wirec = WireCounters(obs=obs, scope="server")
        self._m_reconnects = reg.counter("wire.reconnects", "server") \
            if reg else Counter()
        self._m_dups = reg.counter("wire.duplicates_dropped", "server") \
            if reg else Counter()
        self._m_retransmits = reg.counter("wire.retransmits", "server") \
            if reg else Counter()
        self._m_auth_rejects = reg.counter("wire.auth_rejects", "server") \
            if reg else Counter()
        self._m_rejected = Counter()
        self._m_decode_errors = Counter()
        self._m_evicted = reg.counter("server.sessions_evicted", "server") \
            if reg else Counter()
        self._m_dead = reg.counter("wire.sessions_dead", "server") \
            if reg else Counter()
        self._h_train = reg.histogram("client.train_seconds", "server") \
            if reg else None

        self._start()

    def _start(self) -> None:
        """Spin up the I/O machinery (thread-per-connection accept loop
        here; the async subclass overrides this with one selector loop)."""
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="fedhc-accept", daemon=True
        )
        self._accept_thread.start()

    # legacy counter surface (unchanged values, now counter-backed)
    @property
    def wire_bytes(self) -> int:
        return int(self._wirec.framed.value)

    @property
    def payload_bytes(self) -> int:
        return int(self._wirec.payload.value)

    @property
    def header_bytes(self) -> int:
        return int(self._wirec.header.value)

    @property
    def messages_encoded(self) -> int:
        return int(self._wirec.messages.value)

    @property
    def reconnects(self) -> int:
        return int(self._m_reconnects.value)

    @property
    def duplicates_dropped(self) -> int:
        return int(self._m_dups.value)

    @property
    def retransmits(self) -> int:
        return int(self._m_retransmits.value)

    @property
    def auth_rejects(self) -> int:
        return int(self._m_auth_rejects.value)

    @property
    def handshakes_rejected(self) -> int:
        return int(self._m_rejected.value)

    @property
    def decode_errors(self) -> int:
        return int(self._m_decode_errors.value)

    @property
    def sessions_evicted(self) -> int:
        return int(self._m_evicted.value)

    @property
    def sessions_dead(self) -> int:
        return int(self._m_dead.value)

    @property
    def address(self) -> Tuple[str, int]:
        return (self.host, self.port)

    # -- accept / handshake ------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return  # listener closed
            threading.Thread(
                target=self._handshake_and_serve, args=(conn,),
                name="fedhc-conn", daemon=True,
            ).start()

    def _handshake_and_serve(self, conn: socket.socket) -> None:
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            dec = FrameDecoder(raw=True)
            deadline = time.monotonic() + self.handshake_timeout
            hello: Optional[Dict[str, Any]] = None
            extras: List[bytes] = []
            while hello is None:
                chunk = _recv_chunk(conn, max(deadline - time.monotonic(), 0.01))
                if not chunk:  # EOF or timeout before a full handshake
                    conn.close()
                    return
                bodies = dec.feed(chunk)
                if bodies:
                    hello, extras = json.loads(bodies[0]), bodies[1:]
            try:
                version = negotiate_version(hello, self.accept_versions)
                cid = int(hello["client_id"])
                token = str(hello["session"])
                if not verify_session_auth(hello, self.session_key):
                    # unsigned / garbage peer under an auth-enabled server:
                    # clean handshake-level ABORT, no session state exists
                    self._m_auth_rejects.inc()
                    if self._trace is not None:
                        self._trace.wall_instant(
                            "auth.reject", "server", "handshakes",
                            args={"client_id": hello.get("client_id"),
                                  "signed": "auth" in hello})
                    raise ProtocolError(
                        "session auth failed: bad or missing signature")
            except (ProtocolError, KeyError, TypeError, ValueError) as e:
                self._m_rejected.inc()
                try:
                    conn.settimeout(self.send_timeout)
                    conn.sendall(encode_frame(make_error_hello(str(e))))
                finally:
                    conn.close()
                return
            sess = self._bind_session(cid, token, version, conn,
                                      int(hello.get("recv_seq", 0)))
            for body in extras:
                self._ingest(sess, body)
            self._reader_loop(sess, conn, dec)
        except (OSError, ProtocolError, ValueError):
            # ProtocolError covers FrameError from a garbage pre-handshake
            # stream (e.g. an HTTP probe whose first bytes parse as an
            # oversize length prefix) — the socket must not leak
            try:
                conn.close()
            except OSError:
                pass

    def _evict_session_locked(self, cid: int, *, reason: str,
                              dead: bool) -> None:
        """THE single eviction path — both the TTL sweep and the liveness
        reaper land here, so the ``session.evict``/``session.dead`` events
        and their counters cannot drift apart.  Caller holds
        ``self._lock``.  ``dead=True`` is the liveness verdict (counted as
        ``wire.sessions_dead``); ``dead=False`` is idle-state reclamation
        (``server.sessions_evicted``)."""
        sess = self._sessions.pop(cid, None)
        if sess is None:
            return
        with sess.lock:
            # a liveness-reaped session may still hold a (zombie) TCP
            # connection — tear it down so a half-open peer sees EOF
            _close_conn(sess.conn)
            sess.conn = None
        (self._m_dead if dead else self._m_evicted).inc()
        if self._trace is not None:
            self._trace.wall_instant(
                "session.dead" if dead else "session.evict", "server",
                f"session {cid}", args={"client_id": cid, "reason": reason})

    def _sweep_sessions(self, now: float) -> None:
        """Evict sessions disconnected longer than ``session_ttl``, and
        declare sessions silent past the missed-beat threshold dead.
        Caller holds ``self._lock``."""
        if self.session_ttl is not None:
            for cid in [cid for cid, s in self._sessions.items()
                        if s.conn is None
                        and now - s.last_seen > self.session_ttl]:
                self._evict_session_locked(cid, reason="ttl_idle",
                                           dead=False)
        if self.heartbeat_interval is not None:
            cutoff = self.heartbeat_interval * self.missed_beats
            for cid in [cid for cid, s in self._sessions.items()
                        if now - s.last_seen > cutoff]:
                self._evict_session_locked(cid, reason="missed_heartbeats",
                                           dead=True)

    def _maybe_sweep(self) -> None:
        """Rate-limited sweep from the control plane's poll loop — the
        liveness reaper must fire even when no handshake arrives."""
        if self._sweep_every is None:
            return
        now = self.clock()
        if now - self._last_sweep < self._sweep_every:
            return
        self._last_sweep = now
        with self._lock:
            self._sweep_sessions(now)

    def _attach_session(self, cid: int, token: str, version: int,
                        now: float) -> Tuple[_Session, bool,
                                             Optional[_Session]]:
        """Session-map bookkeeping shared by both accept loops: sweep,
        resume-or-create for (cid, token), count the reconnect.  Returns
        ``(session, resumed, superseded_old_lifetime_or_None)``."""
        with self._lock:
            self._sweep_sessions(now)
            sess = self._sessions.get(cid)
            resumed = sess is not None and sess.token == token
            stale: Optional[_Session] = None
            if not resumed:
                stale = sess                  # superseded lifetime, if any
                sess = _Session(cid, token, version)  # fresh client lifetime
                self._sessions[cid] = sess
            else:
                # renegotiated on reconnect (same forced version in practice)
                sess.version = int(version)
                self._m_reconnects.inc()
        assert sess is not None
        sess.last_seen = now
        return sess, resumed, stale

    def _bind_session(self, cid: int, token: str, version: int,
                      conn: socket.socket, client_recv: int) -> _Session:
        sess, resumed, stale = self._attach_session(cid, token, version,
                                                    self.clock())
        if stale is not None:
            # a new token replaces the session: the old lifetime's live
            # connection (half-open after a client restart) must be torn
            # down, or its reader would keep feeding stale frames into the
            # inbox under this client id
            with stale.lock:
                _close_conn(stale.conn)
                stale.conn = None
        with sess.lock:
            old = sess.conn
            sess.conn = conn
            if old is not None and old is not conn:
                _close_conn(old)   # wakes the old reader thread with EOF
            try:
                conn.settimeout(self.send_timeout)
                conn.sendall(encode_frame(make_server_hello(
                    sess.recv_seq, resumed=resumed, version=sess.version,
                )))
                # retransmit instructions the client never saw
                sess.outbox = [(s, f, m) for s, f, m in sess.outbox
                               if s > client_recv]
                for _seq, frame, _msg in sess.outbox:
                    conn.sendall(frame)
                    self._m_retransmits.inc()
            except OSError:
                sess.conn = None
        return sess

    def _reader_loop(self, sess: _Session, conn: socket.socket,
                     dec: FrameDecoder) -> None:
        # Blocking reads from here on: an idle-but-healthy client must NOT
        # be dropped by a stale handshake timeout on the socket.  A send
        # path may briefly set a timeout on the same socket (its sendall is
        # bounded); if this recv observes it, tolerate the timeout and keep
        # reading — only EOF and hard errors drop the connection.  close()
        # unblocks the recv by closing the socket.
        try:
            conn.settimeout(None)
        except OSError:
            return
        while not self._closed:
            try:
                chunk = conn.recv(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            if not chunk:
                break
            with self._stats_lock:
                self._wirec.framed.inc(len(chunk))
                sess.wire.framed.inc(len(chunk))
            try:
                bodies = dec.feed(chunk)
            except (ProtocolError, ValueError):
                self._m_decode_errors.inc()
                break  # corrupt stream: drop the connection, keep the session
            corrupt = False
            for body in bodies:
                try:
                    self._ingest(sess, body)
                except (ProtocolError, ValueError, KeyError):
                    # corrupt frame body (bad magic/header, blob crc
                    # mismatch): the stream can no longer be trusted —
                    # drop the CONNECTION so the peer reconnects and
                    # retransmits from its outbox; the session survives
                    # and nothing corrupt was delivered upward
                    self._m_decode_errors.inc()
                    corrupt = True
                    break
            if corrupt:
                break
        with sess.lock:
            if sess.conn is conn:
                sess.conn = None   # dead; session survives for reconnect
        sess.last_seen = self.clock()
        try:
            conn.close()
        except OSError:
            pass

    def _ingest(self, sess: _Session, body: bytes) -> None:
        frame, payload_bytes = decode_wire_body(body)
        seq, ack, msg = parse_envelope(frame)
        with self._stats_lock:
            self._wirec.payload.inc(payload_bytes)
            self._wirec.header.inc(len(body) + 4 - payload_bytes)
            sess.wire.payload.inc(payload_bytes)
            sess.wire.header.inc(len(body) + 4 - payload_bytes)
            sess.last_seen = self.clock()
        with sess.lock:
            sess.outbox = [(s, f, m) for s, f, m in sess.outbox if s > ack]
            if seq <= sess.recv_seq:
                self._m_dups.inc()             # resent after reconnect: drop
                return
            sess.recv_seq = seq
        if self._trace is not None:
            self._trace.wall_instant("wire.recv", "server",
                                     f"session {sess.client_id}",
                                     args={"kind": msg.kind.value, "seq": seq,
                                           "bytes": len(body) + 4})
        # STATS piggyback: a worker-side telemetry blob rides the upload
        # envelope; record it on the session (surfaced via session_stats)
        stats = msg.payload.get("stats") if isinstance(msg.payload, dict) \
            else None
        if isinstance(stats, dict):
            self.record_peer_stats(sess.client_id, stats)
        self._inbox.put(msg)

    # -- Transport surface (server half) -----------------------------------

    def poll_server(self) -> Optional[Message]:
        """Next pending client request (non-blocking), or None."""
        self._maybe_sweep()
        try:
            return self._inbox.get_nowait()
        except queue.Empty:
            return None

    def _session_for_send(self, client_id: int) -> _Session:
        if self._closed:
            raise TransportClosed("send after close")
        with self._lock:
            sess = self._sessions.get(client_id)
        if sess is None:
            # The client has never connected, so there is no wire to route
            # on.  NOTE this diverges from LocalTransport, which happily
            # buffers for clients it has never seen — code that pre-sends
            # instructions must not assume that works over sockets (the
            # Transport docstring records this).
            raise KeyError(f"no session for client {client_id}")
        return sess

    def _stamp(self, sess: _Session, msg: Message, *,
               cached: Optional[CachedSegments] = None,
               extra: Optional[Dict[str, Any]] = None) -> EncodedEnvelope:
        """Assign the next session seq, encode (cached fast path when
        given), account, record in the outbox.  Caller holds ``sess.lock``
        and follows up with :meth:`_dispatch_locked`."""
        sess.send_seq += 1
        if cached is not None:
            enc = encode_envelope_cached(sess.send_seq, sess.recv_seq,
                                         msg.kind, msg.client_id, cached,
                                         extra_payload=extra)
        else:
            enc = encode_envelope_wire(sess.send_seq, sess.recv_seq, msg,
                                       version=sess.version,
                                       deflate=self.deflate)
        with self._stats_lock:
            self._wirec.account(enc)
            sess.wire.account_frame(len(enc.data), enc.payload_bytes,
                                    count_message=False)
        if self._trace is not None:
            self._trace.wall_instant("wire.send", "server",
                                     f"session {msg.client_id}",
                                     args={"kind": msg.kind.value,
                                           "seq": sess.send_seq,
                                           "bytes": len(enc.data)})
        sess.outbox.append((sess.send_seq, enc.data, msg))
        return enc

    def _dispatch_locked(self, sess: _Session, enc: EncodedEnvelope) -> None:
        """Push one stamped frame onto the live connection, if any.
        Caller holds ``sess.lock``.  (The async subclass overrides this to
        enqueue on the selector loop's outbuf instead of writing inline.)"""
        if sess.conn is not None:
            try:
                # bounded send: a frozen client must not hang the whole
                # control plane inside FLServer.step() (the reader
                # tolerates observing this timeout).  On timeout the
                # conn is dropped and the frame is redelivered at
                # reconnect — never lost.
                sess.conn.settimeout(self.send_timeout)
                sess.conn.sendall(enc.data)
                sess.conn.settimeout(None)
            except OSError:
                _close_conn(sess.conn)
                sess.conn = None  # redelivered on reconnect

    def send_to_client(self, msg: Message) -> None:
        """Issue an instruction to ``msg.client_id``, encoded in the
        session's negotiated wire version.  Never raises on a dead
        connection: the frame stays in the session outbox and is
        redelivered on reconnect (idempotent via sequence numbers)."""
        sess = self._session_for_send(msg.client_id)
        with sess.lock:
            enc = self._stamp(sess, msg)
            self._dispatch_locked(sess, enc)

    def send_to_client_cached(self, client_id: int, kind: MsgType,
                              cached: CachedSegments,
                              extra_payload: Optional[Dict[str, Any]] = None,
                              ) -> None:
        """Issue an instruction whose tensor payload was pre-extracted by
        :func:`repro_torch.fed.transport.precompute_segments`: a v2 session gets
        the cached blob with only the small header re-stamped (the
        broadcast fan-out fast path); a v1-negotiated session falls back
        to an equivalent plain message — bit-identical payload, encoded
        the slow way."""
        sess = self._session_for_send(client_id)
        extra = dict(extra_payload or {})
        with sess.lock:
            if sess.version >= 2:
                msg = Message(kind, client_id, extra)
                enc = self._stamp(sess, msg, cached=cached, extra=extra)
            else:
                msg = Message(kind, client_id,
                              {**hydrate_cached(cached), **extra})
                enc = self._stamp(sess, msg)
            self._dispatch_locked(sess, enc)

    # client-half methods belong to the other end of the wire
    def send_to_server(self, msg: Message) -> None:
        raise RuntimeError("SocketServerTransport is the server end of the wire")

    def poll_client(self, client_id: int) -> Optional[Message]:
        raise RuntimeError("SocketServerTransport is the server end of the wire")

    # -- introspection / teardown -----------------------------------------

    def connected_clients(self) -> List[int]:
        """Client ids with a live connection right now."""
        with self._lock:
            return [cid for cid, s in self._sessions.items() if s.conn is not None]

    def known_clients(self) -> List[int]:
        """Client ids with any session state (live or awaiting reconnect)."""
        with self._lock:
            return list(self._sessions)

    def session_stats(self) -> Dict[int, Dict[str, int]]:
        """Per-client wire accounting: negotiated version plus framed /
        payload / header bytes both directions for each live session."""
        with self._lock, self._stats_lock:
            out: Dict[int, Dict[str, Any]] = {}
            for cid, s in self._sessions.items():
                entry: Dict[str, Any] = {
                    "version": s.version,
                    "wire_bytes": int(s.wire.framed.value),
                    "payload_bytes": int(s.wire.payload.value),
                    "header_bytes": int(s.wire.header.value),
                }
                if s.peer_stats:
                    entry["peer"] = dict(s.peer_stats)
                out[cid] = entry
            return out

    def record_peer_stats(self, client_id: int, stats: Dict[str, Any]) -> None:
        """Store a client's piggybacked STATS blob on its live session.

        Only plain scalar values are kept — the blob rides on the upload
        envelope and is advisory telemetry, never control state.
        """
        clean = {k: v for k, v in stats.items()
                 if isinstance(k, str) and isinstance(v, (int, float, str))}
        train_s = clean.get("train_s")
        if self._h_train is not None and isinstance(train_s, (int, float)):
            self._h_train.observe(float(train_s))
        with self._lock:
            sess = self._sessions.get(int(client_id))
        if sess is None:
            return
        with self._stats_lock:
            sess.peer_stats.update(clean)

    def close(self) -> None:
        self._closed = True
        try:
            # wake the accept thread: a bare close() leaves the listening
            # file description alive (and the port bound) while accept()
            # blocks on it
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            sessions = list(self._sessions.values())
        for sess in sessions:
            with sess.lock:
                _close_conn(sess.conn)
                sess.conn = None


# --------------------------------------------------------------------------
# Async server: one selector loop, thousands of sessions
# --------------------------------------------------------------------------


class _AsyncConn:
    """Per-connection state on the selector loop: the nonblocking socket,
    its frame decoder, the bound session (None until the hello lands),
    and the pending output buffer."""

    __slots__ = ("sock", "dec", "sess", "outbuf", "deadline", "closing")

    def __init__(self, sock: socket.socket, deadline: float):
        self.sock = sock
        self.dec = FrameDecoder(raw=True)
        self.sess: Optional[_Session] = None
        self.outbuf = bytearray()
        self.deadline = deadline        # handshake deadline (pre-bind only)
        self.closing = False            # flush outbuf, then drop


class AsyncSocketServerTransport(SocketServerTransport):
    """``selectors``-based rewrite of the accept loop: one event-loop
    thread multiplexes the listener and every client connection, so a
    leaf aggregator holds thousands of concurrent sessions without a
    thread per connection (the sync transport's ceiling).

    Everything above the I/O layer is inherited unchanged — handshake
    semantics (:meth:`_attach_session`), sequence/ack bookkeeping
    (:meth:`_ingest`), the outbox/retransmit contract, byte accounting,
    and the whole ``Transport`` surface.  Only the three seams differ:

    * :meth:`_start` spins the selector loop instead of accept threads;
    * :meth:`_dispatch_locked` appends stamped frames to the connection's
      output buffer and wakes the loop (never blocks the control plane);
    * reads/writes happen nonblockingly on the loop, with half-written
      frames carried in ``_AsyncConn.outbuf``.
    """

    _WAKE = b"\x00"

    def _start(self) -> None:
        self._listener.setblocking(False)
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._listener, selectors.EVENT_READ, "accept")
        # self-pipe: send paths run on control-plane threads; one byte on
        # the pair pops the loop out of select() to pick up fresh outbufs
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        # guards _live / _dirty / every conn.outbuf (touched by both the
        # loop thread and control-plane send threads)
        self._io_lock = threading.Lock()
        self._live: Dict[int, _AsyncConn] = {}
        self._dirty: Set[_AsyncConn] = set()
        self._pre: Set[_AsyncConn] = set()     # awaiting their hello
        self._loop_thread = threading.Thread(
            target=self._loop, name="fedhc-async-io", daemon=True
        )
        self._loop_thread.start()

    # -- the loop ----------------------------------------------------------

    def _loop(self) -> None:
        while not self._closed:
            try:
                events = self._sel.select(timeout=0.2)
            except OSError:
                break
            for key, mask in events:
                tag = key.data
                if tag == "accept":
                    self._accept_ready()
                elif tag == "wake":
                    self._drain_wake()
                else:
                    conn: _AsyncConn = tag
                    if mask & selectors.EVENT_READ:
                        self._on_readable(conn)
                    if (mask & selectors.EVENT_WRITE
                            and conn.sock.fileno() != -1):
                        self._on_writable(conn)
            self._flush_interest()
            self._sweep_handshakes()
        self._teardown_loop()

    def _drain_wake(self) -> None:
        try:
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, OSError):
            pass

    def _accept_ready(self) -> None:
        while True:
            try:
                sock, _addr = self._listener.accept()
            except (BlockingIOError, OSError):
                return
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            sock.setblocking(False)
            conn = _AsyncConn(sock,
                              time.monotonic() + self.handshake_timeout)
            self._pre.add(conn)
            try:
                self._sel.register(sock, selectors.EVENT_READ, conn)
            except (ValueError, OSError):
                self._pre.discard(conn)
                try:
                    sock.close()
                except OSError:
                    pass

    def _on_readable(self, conn: _AsyncConn) -> None:
        try:
            chunk = conn.sock.recv(65536)
        except BlockingIOError:
            return
        except OSError:
            self._drop(conn)
            return
        if not chunk:
            self._drop(conn)
            return
        if conn.sess is not None:
            # framed-byte accounting mirrors the sync reader: chunks that
            # arrive before the session is bound ride with the handshake
            with self._stats_lock:
                self._wirec.framed.inc(len(chunk))
                conn.sess.wire.framed.inc(len(chunk))
        try:
            bodies = conn.dec.feed(chunk)
        except (ProtocolError, ValueError):
            self._m_decode_errors.inc()
            self._drop(conn)
            return
        for body in bodies:
            if conn.sess is None:
                if not self._handle_hello(conn, body):
                    return      # rejected: error hello queued (or dropped)
            else:
                try:
                    self._ingest(conn.sess, body)
                except (ProtocolError, ValueError, KeyError):
                    # corrupt frame body: same contract as the sync reader
                    # — drop the connection, keep the session, let the
                    # peer's reconnect retransmit the clean frame
                    self._m_decode_errors.inc()
                    self._drop(conn)
                    return

    def _handle_hello(self, conn: _AsyncConn, body: bytes) -> bool:
        try:
            hello = json.loads(body)
        except ValueError:
            self._m_decode_errors.inc()
            self._drop(conn)
            return False
        try:
            version = negotiate_version(hello, self.accept_versions)
            cid = int(hello["client_id"])
            token = str(hello["session"])
            if not verify_session_auth(hello, self.session_key):
                self._m_auth_rejects.inc()
                if self._trace is not None:
                    self._trace.wall_instant(
                        "auth.reject", "server", "handshakes",
                        args={"client_id": hello.get("client_id"),
                              "signed": "auth" in hello})
                raise ProtocolError(
                    "session auth failed: bad or missing signature")
        except (ProtocolError, KeyError, TypeError, ValueError) as e:
            self._m_rejected.inc()
            with self._io_lock:
                conn.outbuf += encode_frame(make_error_hello(str(e)))
                conn.closing = True
                self._dirty.add(conn)
            return False
        client_recv = int(hello.get("recv_seq", 0))
        sess, resumed, stale = self._attach_session(cid, token, version,
                                                    self.clock())
        if stale is not None:
            with stale.lock:
                stale.conn = None
        with self._io_lock:
            old = self._live.pop(cid, None)
        if old is not None and old is not conn:
            # superseded connection (client reconnected before the old
            # socket died, or a new lifetime replaced the session)
            self._drop(old)
        self._pre.discard(conn)
        conn.sess = sess
        with sess.lock:
            sess.conn = conn.sock
            out = bytearray(encode_frame(make_server_hello(
                sess.recv_seq, resumed=resumed, version=sess.version)))
            # retransmit instructions the client never saw
            sess.outbox = [(s, f, m) for s, f, m in sess.outbox
                           if s > client_recv]
            for _seq, frame, _msg in sess.outbox:
                out += frame
                self._m_retransmits.inc()
        with self._io_lock:
            self._live[cid] = conn
            conn.outbuf += out
            self._dirty.add(conn)
        return True

    def _on_writable(self, conn: _AsyncConn) -> None:
        err = False
        flushed = False
        with self._io_lock:
            if conn.outbuf:
                try:
                    n = conn.sock.send(conn.outbuf)
                    del conn.outbuf[:n]
                except BlockingIOError:
                    pass
                except OSError:
                    err = True
            if not err and not conn.outbuf:
                flushed = True
        if err:
            self._drop(conn)
            return
        if flushed:
            try:
                self._sel.modify(conn.sock, selectors.EVENT_READ, conn)
            except (KeyError, ValueError, OSError):
                pass
            if conn.closing:
                self._drop(conn)

    def _flush_interest(self) -> None:
        with self._io_lock:
            dirty = [c for c in self._dirty if c.outbuf]
            self._dirty.clear()
        for conn in dirty:
            if conn.sock.fileno() == -1:
                continue
            try:
                self._sel.modify(
                    conn.sock,
                    selectors.EVENT_READ | selectors.EVENT_WRITE, conn)
            except (KeyError, ValueError, OSError):
                pass

    def _sweep_handshakes(self) -> None:
        now = time.monotonic()
        for conn in [c for c in self._pre if now > c.deadline]:
            self._drop(conn)

    def _drop(self, conn: _AsyncConn) -> None:
        """Tear one connection down (loop thread only); the session, if
        bound, survives for reconnect — exactly the sync reader's exit."""
        self._pre.discard(conn)
        with self._io_lock:
            self._dirty.discard(conn)
            sess = conn.sess
            if sess is not None and self._live.get(sess.client_id) is conn:
                del self._live[sess.client_id]
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        if sess is not None:
            with sess.lock:
                if sess.conn is conn.sock:
                    sess.conn = None
            sess.last_seen = self.clock()
        try:
            conn.sock.close()
        except OSError:
            pass

    # -- control-plane seams -----------------------------------------------

    def _dispatch_locked(self, sess: _Session, enc) -> None:
        # never writes inline: frames go on the connection's outbuf and
        # the loop flushes them — the control plane cannot block on a
        # slow client (caller holds sess.lock, per the base contract)
        with self._io_lock:
            conn = self._live.get(sess.client_id)
            if conn is None or conn.sess is not sess:
                return   # no live connection: outbox redelivers on reconnect
            conn.outbuf += enc.data
            self._dirty.add(conn)
        self._wake()

    def _wake(self) -> None:
        try:
            self._wake_w.send(self._WAKE)
        except (BlockingIOError, OSError):
            pass

    # -- teardown ----------------------------------------------------------

    def _teardown_loop(self) -> None:
        with self._io_lock:
            conns = list(self._live.values())
            self._live.clear()
            self._dirty.clear()
        for conn in conns + list(self._pre):
            try:
                self._sel.unregister(conn.sock)
            except (KeyError, ValueError, OSError):
                pass
            try:
                conn.sock.close()
            except OSError:
                pass
        self._pre.clear()
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass
        try:
            self._sel.close()
        except OSError:
            pass

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._wake()
        t = self._loop_thread
        if t.is_alive() and t is not threading.current_thread():
            t.join(timeout=5.0)
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            sessions = list(self._sessions.values())
        for sess in sessions:
            with sess.lock:
                sess.conn = None


# --------------------------------------------------------------------------
# Fault injection: the loopback chaos proxy
# --------------------------------------------------------------------------


@dataclass
class FaultPlan:
    """What the proxy does to each client's traffic.

    ``kill_after_frames``  — close the connection (both directions) after
        forwarding this many *post-handshake* client frames; applied at most
        ``kill_times`` times per client (the reconnect then passes through).
    ``delay_frames``       — sleep this long before forwarding each frame.
    ``duplicate_every``    — forward every k-th post-handshake client frame
        twice (exercises receiver-side dedup).
    ``corrupt_after_frames`` — flip bytes in the first post-handshake client
        frame at index >= this, at most ``corrupt_times`` per client.  The
        receiver MUST reject the frame (v2 blob crc / FrameError) and drop
        the connection — never deliver it upward; the sender's reconnect
        retransmits the clean copy.  ``corrupt_tail_only=True`` restricts
        the flips to the second half of the frame (the tensor-segment blob
        region, past the magic/header), specifically exercising the crc.
    ``blackhole_after_frames`` — partition: swallow post-handshake frames
        (both directions) from this client-frame index on, for clients in
        ``blackhole_clients`` (None = all).  ``blackhole_frames`` bounds
        the partition: after swallowing that many client frames the
        connection is killed so the client's reconnect heals the gap
        (None = partitioned forever — the quorum-deadline case).
    ``trickle_bytes``      — slow-loris: forward client frames in chunks of
        this many bytes with ``trickle_delay_s`` sleeps in between.
    """

    kill_after_frames: Optional[int] = None
    kill_times: int = 1
    delay_frames: float = 0.0
    duplicate_every: Optional[int] = None
    corrupt_after_frames: Optional[int] = None
    corrupt_times: int = 1
    corrupt_tail_only: bool = False
    blackhole_after_frames: Optional[int] = None
    blackhole_frames: Optional[int] = None
    blackhole_clients: Optional[Tuple[int, ...]] = None
    trickle_bytes: Optional[int] = None
    trickle_delay_s: float = 0.002
    kills_done: Dict[int, int] = field(default_factory=dict)
    corrupts_done: Dict[int, int] = field(default_factory=dict)


@dataclass(frozen=True)
class FaultEvent:
    """One scripted fault: fires when ``client_id`` (None = any client)
    reaches post-handshake client-frame index ``frame``.

    ``op`` ∈ {"kill", "corrupt", "blackhole", "delay"}.  ``arg`` is the
    delay in seconds for ``delay``, and the partition length in client
    frames for ``blackhole`` (0 = forever).  Each event fires at most once
    per client."""

    frame: int
    op: str
    client_id: Optional[int] = None
    arg: float = 0.0


class FaultSchedule:
    """A deterministic, replayable chaos script: the same schedule against
    the same (deterministic) workload reproduces the same fault sequence,
    because events key on per-client post-handshake frame indices — not
    wall clock.  ``fired`` records what actually happened, in order."""

    def __init__(self, events: Sequence[FaultEvent]):
        self.events = tuple(events)
        self._consumed: Set[Tuple[int, int]] = set()   # (event idx, cid)
        self.fired: List[Tuple[int, FaultEvent]] = []  # (cid, event)
        self._lock = threading.Lock()

    def take(self, client_id: Optional[int], frame: int) -> List[FaultEvent]:
        """Events due for this client at this frame index; each is marked
        consumed for the client and recorded in ``fired``."""
        cid = -1 if client_id is None else int(client_id)
        out: List[FaultEvent] = []
        with self._lock:
            for i, ev in enumerate(self.events):
                if ev.frame != frame:
                    continue
                if ev.client_id is not None and ev.client_id != client_id:
                    continue
                if (i, cid) in self._consumed:
                    continue
                self._consumed.add((i, cid))
                self.fired.append((cid, ev))
                out.append(ev)
        return out


def _flip_bytes(body: bytes, *, tail_only: bool = False) -> bytes:
    """Deterministically corrupt a frame body: XOR a spray of bytes.
    ``tail_only`` confines the damage to the second half (v2: the tensor
    segment blob, past the magic byte and JSON header)."""
    b = bytearray(body)
    lo = len(b) // 2 if tail_only and len(b) > 8 else 0
    step = max(1, (len(b) - lo) // 8)
    for i in range(lo, len(b), step):
        b[i] ^= 0xA5
    return bytes(b)


def _peek_handshake(body: bytes) -> Optional[Dict[str, Any]]:
    """Parse a frame body iff it is a JSON handshake (has ``magic``);
    returns None for envelopes of either version."""
    if body[:1] != b"{":
        return None  # v2 binary envelope
    try:
        obj = json.loads(body)
    except ValueError:
        return None
    return obj if isinstance(obj, dict) and "magic" in obj else None


class ChaosProxy:
    """Frame-aware TCP proxy between clients and a SocketServerTransport.

    Splits the length-prefixed frame stream (handshakes are always passed
    through untouched), applies the :class:`FaultPlan` per client, and
    forwards each frame body *verbatim* — v1 JSON and v2 binary frames
    alike survive bit-for-bit.  Clients connect to ``proxy.port`` instead
    of the server's.
    """

    def __init__(self, upstream_host: str, upstream_port: int,
                 plan: Optional[FaultPlan] = None, host: str = "127.0.0.1",
                 schedule: Optional[FaultSchedule] = None):
        self.upstream = (upstream_host, int(upstream_port))
        self.plan = plan or FaultPlan()
        self.schedule = schedule
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, 0))
        self._listener.listen(128)
        self.host, self.port = self._listener.getsockname()[:2]
        self._closed = False
        self.frames_forwarded = 0
        self.frames_duplicated = 0
        self.frames_corrupted = 0
        self.frames_blackholed = 0
        self.connections_killed = 0
        self._lock = threading.Lock()
        threading.Thread(target=self._accept_loop, name="chaos-accept",
                         daemon=True).start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                downstream, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(downstream,),
                             name="chaos-conn", daemon=True).start()

    def _serve(self, downstream: socket.socket) -> None:
        try:
            upstream = socket.create_connection(self.upstream, timeout=5.0)
        except OSError:
            downstream.close()
            return
        stop = threading.Event()
        # per-connection fault state, shared by both pump directions:
        # bh_left < 0 = partitioned forever, > 0 = frames left to swallow
        state = {"client_id": None, "bh_left": 0, "bh_on": False}

        def kill_both(count: bool = False) -> None:
            if count:
                with self._lock:
                    self.connections_killed += 1
            stop.set()
            for s in (downstream, upstream):
                # shutdown before close: the peer pump thread is parked in
                # recv() on one of these sockets, and close() alone neither
                # wakes it nor sends FIN while that recv holds the socket —
                # the un-killed side would hang half-open forever
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    s.close()
                except OSError:
                    pass

        def _blackhole_due(cid, post: int) -> bool:
            plan = self.plan
            if plan.blackhole_after_frames is None:
                return False
            if post < plan.blackhole_after_frames:
                return False
            return (plan.blackhole_clients is None
                    or cid in plan.blackhole_clients)

        def pump(src: socket.socket, dst: socket.socket, from_client: bool) -> None:
            dec = FrameDecoder(raw=True)
            n_frames = 0
            while not stop.is_set():
                try:
                    chunk = src.recv(65536)
                except OSError:
                    break
                if not chunk:
                    break
                try:
                    bodies = dec.feed(chunk)
                except (ProtocolError, ValueError):
                    break
                for body in bodies:
                    n_frames += 1
                    post = n_frames - 1   # post-handshake frame count
                    hello = _peek_handshake(body)
                    is_handshake = hello is not None
                    if is_handshake and from_client:
                        state["client_id"] = hello.get("client_id")
                    cid = state["client_id"]
                    corrupt = False
                    kill = False
                    if not is_handshake and from_client:
                        # scripted schedule first: deterministic, replayable
                        if self.schedule is not None:
                            for ev in self.schedule.take(cid, post):
                                if ev.op == "delay":
                                    time.sleep(ev.arg)
                                elif ev.op == "corrupt":
                                    corrupt = True
                                elif ev.op == "kill":
                                    kill = True
                                elif ev.op == "blackhole":
                                    state["bh_on"] = True
                                    state["bh_left"] = (int(ev.arg)
                                                        if ev.arg > 0 else -1)
                        # ambient plan modes
                        if (not state["bh_on"]
                                and _blackhole_due(cid, post)):
                            state["bh_on"] = True
                            bh = self.plan.blackhole_frames
                            state["bh_left"] = -1 if bh is None else int(bh)
                        if self.plan.corrupt_after_frames is not None:
                            done = self.plan.corrupts_done.get(cid, 0)
                            if (done < self.plan.corrupt_times
                                    and post >= self.plan.corrupt_after_frames):
                                self.plan.corrupts_done[cid] = done + 1
                                corrupt = True
                        if self.plan.kill_after_frames is not None:
                            done = self.plan.kills_done.get(cid, 0)
                            if (done < self.plan.kill_times
                                    and post >= self.plan.kill_after_frames):
                                self.plan.kills_done[cid] = done + 1
                                kill = True
                    # partition: swallow post-handshake frames in BOTH
                    # directions while the blackhole is active
                    if state["bh_on"] and not is_handshake:
                        with self._lock:
                            self.frames_blackholed += 1
                        if from_client and state["bh_left"] > 0:
                            state["bh_left"] -= 1
                            if state["bh_left"] == 0:
                                # bounded partition heals by killing the
                                # connection: the client's reconnect then
                                # retransmits everything the hole swallowed
                                kill_both(count=True)
                                return
                        continue
                    if self.plan.delay_frames and not is_handshake:
                        time.sleep(self.plan.delay_frames)
                    if corrupt:
                        with self._lock:
                            self.frames_corrupted += 1
                        body = _flip_bytes(
                            body, tail_only=self.plan.corrupt_tail_only)
                    data = encode_frame_raw(body)
                    try:
                        if (self.plan.trickle_bytes and from_client
                                and not is_handshake):
                            step = int(self.plan.trickle_bytes)
                            for i in range(0, len(data), step):
                                dst.sendall(data[i:i + step])
                                time.sleep(self.plan.trickle_delay_s)
                        else:
                            dst.sendall(data)
                        with self._lock:
                            self.frames_forwarded += 1
                        if (not is_handshake and from_client
                                and self.plan.duplicate_every
                                and post % self.plan.duplicate_every == 0):
                            dst.sendall(data)
                            with self._lock:
                                self.frames_duplicated += 1
                    except OSError:
                        kill_both()
                        return
                    if kill:
                        kill_both(count=True)
                        return
            kill_both()

        threading.Thread(target=pump, args=(downstream, upstream, True),
                         daemon=True).start()
        threading.Thread(target=pump, args=(upstream, downstream, False),
                         daemon=True).start()

    def close(self) -> None:
        self._closed = True
        try:
            self._listener.shutdown(socket.SHUT_RDWR)  # wake the accept thread
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
