"""Write-ahead round journal: durable crash-restart for the server tiers.

The port of ``repro.fed.wal``, pure Python.  A journal's bytes are the
reference's, so each package recovers the other's file.

A killed-and-restarted ``FLServer`` / ``LeafAggregator`` / ``RootAggregator``
loses every accepted upload of the in-flight round; with a journal it
replays the log and resumes mid-round **bit-identical** — no client
re-upload needed, because the ``(cid, round)`` dedup floor is part of what
replay restores (``docs/wire-protocol.md`` § Write-ahead round journal is
the normative record layout; ``docs/architecture.md`` § Failure model says
what survives which crash).

Stdlib-only.  Each record reuses the v2 wire codec for its body, framed as

    [u32 BE body length][u32 BE crc32(body)][body]

where ``body`` is a v2 envelope body (``seq`` = record ordinal, ``ack`` =
0) — so a journal record is decodable by the exact code path that decoded
the frame off the socket, and tensor payloads (deltas, partial-sum
windows) round-trip bit-exactly.  Appends ``flush()`` to the OS after
every record: a SIGKILLed process loses at most the record being written
(recovery tolerates a torn tail), and nothing that was already
acknowledged upstream.  ``fsync=True`` additionally survives machine
crashes, at a per-append cost.

Record kinds (the :class:`~repro_torch.fed.transport.MsgType` of the body):

* ``TRAIN``        — round open: ``{"round": r, ...}`` metadata
* ``UPLOAD``       — one accepted upload (flat client delta, or a leaf's
                     ``PARTIAL_SUM`` payload accepted at the root)
* ``PARTIAL_SUM``  — an ``ExactAccumulator`` window (the hierarchy's)
                     checkpoint (``{"folds": k, ...to_payload()}``):
                     recovery adopts the latest window and re-folds only
                     the uploads appended after it
* ``TERMINATE``    — round close: ``{"round": r, "reason": ..., ...}``
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Set, Tuple

from repro_torch.fed.transport import (
    FrameError, Message, MsgType, encode_envelope_wire, decode_wire_body,
    parse_envelope,
)

#: Journal record header: u32 BE body length, u32 BE crc32 of the body.
_REC = struct.Struct(">II")

#: Hard cap on one journal record body — same bound as a wire frame.
MAX_RECORD_BYTES = 64 * 1024 * 1024


class WalError(RuntimeError):
    """The journal file is corrupt beyond the tolerated torn tail."""


class RoundJournal:
    """Append-only write-ahead journal for one server/aggregator process.

    Opened in append mode: restarting a process against an existing
    journal keeps the history (call :func:`recover` first to rebuild
    state, then keep appending).  Thread-safe appends are the caller's
    concern — every tier appends from its single control loop.
    """

    def __init__(self, path, *, fsync: bool = False, obs=None,
                 scope: str = "wal"):
        self.path = Path(path)
        # a SIGKILL mid-append leaves a partial final record; appending
        # after it would bury every later record behind what recovery must
        # then treat as mid-journal corruption — drop the torn tail first
        torn_at = _torn_tail_offset(self.path)
        if torn_at is not None:
            with open(self.path, "r+b") as f:
                f.truncate(torn_at)
        self._f = open(self.path, "ab")
        self._fsync = bool(fsync)
        self._seq = 0
        self.bytes_written = 0
        if obs is not None:
            self._m_appends = obs.registry.counter("fault.wal_appends", scope)
        else:
            from repro_torch.obs.metrics import Counter

            self._m_appends = Counter()

    @property
    def appends(self) -> int:
        return int(self._m_appends)

    # -- raw append ------------------------------------------------------
    def append(self, kind: MsgType, client_id: int,
               payload: Dict[str, Any]) -> int:
        """Append one record; returns its size in bytes.  The record is
        flushed to the OS before returning (write-ahead: callers append
        *before* mutating in-memory round state)."""
        enc = encode_envelope_wire(self._seq, 0,
                                   Message(kind, int(client_id), payload),
                                   version=2, deflate=False)
        body = enc.data[4:]                     # strip the wire length prefix
        if len(body) > MAX_RECORD_BYTES:
            raise WalError(f"journal record {len(body)}B exceeds "
                           f"{MAX_RECORD_BYTES}B")
        rec = _REC.pack(len(body), zlib.crc32(body)) + body
        self._f.write(rec)
        self._f.flush()
        if self._fsync:
            import os

            os.fsync(self._f.fileno())
        self._seq += 1
        self.bytes_written += len(rec)
        self._m_appends.inc()
        return len(rec)

    # -- round-structured convenience wrappers ---------------------------
    def open_round(self, rnd: int, **meta: Any) -> None:
        self.append(MsgType.TRAIN, -1, {"round": int(rnd), **meta})

    def upload(self, client_id: int, payload: Dict[str, Any]) -> None:
        self.append(MsgType.UPLOAD, client_id, payload)

    def checkpoint(self, folds: int, payload: Dict[str, Any]) -> None:
        self.append(MsgType.PARTIAL_SUM, -1, {"folds": int(folds), **payload})

    def close_round(self, rnd: int, **meta: Any) -> None:
        self.append(MsgType.TERMINATE, -1, {"round": int(rnd), **meta})

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass

    def __enter__(self) -> "RoundJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def iter_records(path) -> Iterator[Tuple[Message, bool]]:
    """Yield ``(message, torn)`` per journal record.  A truncated or
    crc-failing final record (the one a SIGKILL interrupted) terminates
    iteration with ``torn=True`` on a sentinel ``(None, True)``-free
    basis: the generator simply stops and the *caller* of :func:`recover`
    sees ``torn`` there.  Corruption *before* the tail raises
    :class:`WalError` — that is a damaged journal, not a torn append."""
    path = Path(path)
    data = path.read_bytes()
    off, n = 0, len(data)
    while off < n:
        if off + _REC.size > n:
            return  # torn tail: header itself truncated
        length, crc = _REC.unpack_from(data, off)
        if length > MAX_RECORD_BYTES:
            raise WalError(f"{path}: record at byte {off} claims {length}B")
        body = data[off + _REC.size: off + _REC.size + length]
        if len(body) < length or zlib.crc32(body) != crc:
            if off + _REC.size + length >= n:
                return  # torn tail: body truncated / partially written
            raise WalError(f"{path}: crc mismatch at byte {off} "
                           f"(mid-journal corruption)")
        try:
            frame, _ = decode_wire_body(body)
            _seq, _ack, msg = parse_envelope(frame)
        except (FrameError, ValueError, KeyError) as e:
            raise WalError(f"{path}: undecodable record at byte {off}: {e}")
        yield msg, False
        off += _REC.size + length


@dataclass
class WalRound:
    """Recovered per-round state."""

    round: int
    meta: Dict[str, Any]
    uploads: List[Tuple[int, Dict[str, Any]]] = field(default_factory=list)
    checkpoint: Optional[Dict[str, Any]] = None
    checkpoint_folds: int = 0
    closed: bool = False
    close_meta: Dict[str, Any] = field(default_factory=dict)


@dataclass
class WalRecovery:
    """Everything a restarted tier needs to resume mid-round."""

    rounds: Dict[int, WalRound] = field(default_factory=dict)
    #: (cid → rounds uploaded) across the whole journal — the dedup floor.
    uploaded_rounds: Dict[int, Set[int]] = field(default_factory=dict)
    records: int = 0
    torn: bool = False

    @property
    def open_round(self) -> Optional[WalRound]:
        """The in-flight round a crash interrupted (opened, not closed),
        or ``None`` if the journal ends cleanly."""
        live = [r for r in self.rounds.values() if not r.closed]
        return max(live, key=lambda r: r.round) if live else None


def recover(path) -> WalRecovery:
    """Replay a journal into a :class:`WalRecovery`.  Missing file →
    empty recovery (first boot)."""
    rec = WalRecovery()
    path = Path(path)
    if not path.exists():
        return rec
    current: Optional[WalRound] = None
    for msg, _ in iter_records(path):
        rec.records += 1
        p = msg.payload
        if msg.kind is MsgType.TRAIN:
            rnd = int(p["round"])
            existing = rec.rounds.get(rnd)
            if existing is not None and not existing.closed:
                # resume marker: a restarted tier re-opens the round it is
                # resuming — keep accumulating onto the same WalRound so a
                # second crash still sees the pre-first-crash uploads
                current = existing
                current.meta.update(p)
            else:
                current = WalRound(round=rnd, meta=dict(p))
                rec.rounds[rnd] = current
        elif msg.kind is MsgType.UPLOAD:
            if current is not None:
                current.uploads.append((int(msg.client_id), p))
            rnd = p.get("round")
            if rnd is not None:
                rec.uploaded_rounds.setdefault(
                    int(msg.client_id), set()).add(int(rnd))
        elif msg.kind is MsgType.PARTIAL_SUM:
            if current is not None:
                current.checkpoint = dict(p)
                current.checkpoint_folds = int(p.get("folds", 0))
        elif msg.kind is MsgType.TERMINATE:
            rnd = int(p["round"])
            if rnd in rec.rounds:
                rec.rounds[rnd].closed = True
                rec.rounds[rnd].close_meta = dict(p)
            if current is not None and current.round == rnd:
                current = None
    rec.torn = _has_torn_tail(path)
    return rec


def _torn_tail_offset(path: Path) -> Optional[int]:
    """Byte offset of a torn FINAL record (its claimed extent reaches
    EOF), or ``None`` for a clean journal, a missing file, or damage
    *before* the tail — the latter is :class:`WalError` territory for
    :func:`recover`, never something to silently truncate."""
    if not path.exists():
        return None
    data = path.read_bytes()
    off, n = 0, len(data)
    while off < n:
        if off + _REC.size > n:
            return off
        length, crc = _REC.unpack_from(data, off)
        if length > MAX_RECORD_BYTES:
            return None
        body = data[off + _REC.size: off + _REC.size + length]
        if len(body) < length or zlib.crc32(body) != crc:
            return off if off + _REC.size + length >= n else None
        off += _REC.size + length
    return None


def _has_torn_tail(path: Path) -> bool:
    return _torn_tail_offset(path) is not None
