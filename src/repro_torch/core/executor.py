"""Dynamic process manager (paper §4.1, Fig 4).

On the GPU, a client's resource budget lives in its process's CUDA context
and cannot change after process start — so FedHC terminates the process when
its client finishes and launches a fresh one (with a fresh budget) for the
next client, and lets the number of live processes float with resource
availability instead of pinning a fixed worker pool.

A pure-Python copy of ``repro.core.executor``: the bookkeeping — status
monitor, per-row FIFO record table, determination module — that the
campaign engine drives, and tests assert over its event history.
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from enum import Enum
from typing import Deque, Dict, List, Optional


class ExecState(str, Enum):
    IDLE = "idle"
    RUNNING = "running"
    TERMINATED = "terminated"


class EventKind(str, Enum):
    SPAWN = "spawn"
    RUN = "run"
    COMPLETE = "complete"
    UPLOAD = "upload"
    TERMINATE = "terminate"
    FAIL = "fail"
    RESCHEDULE = "reschedule"


@dataclass
class Event:
    time: float
    executor_id: int
    kind: EventKind
    client_id: Optional[int] = None
    payload: dict = field(default_factory=dict)


@dataclass
class Executor:
    eid: int
    budget: float
    client_id: Optional[int]
    state: ExecState = ExecState.RUNNING
    spawned_at: float = 0.0
    slot: int = 0  # AvailE slot consumed at spawn; freed on terminate


class RecordTable:
    """Per-executor-row FIFO event queues + a global history log."""

    def __init__(self):
        self.rows: Dict[int, Deque[Event]] = {}
        self.history: List[Event] = []

    def push(self, ev: Event) -> None:
        self.rows.setdefault(ev.executor_id, deque()).append(ev)
        self.history.append(ev)

    def pop(self, executor_id: int) -> Optional[Event]:
        row = self.rows.get(executor_id)
        return row.popleft() if row else None


class ProcessManager:
    """Spawns one executor per client; parallelism floats up to
    ``max_parallel`` (dynamic mode) or stays at a fixed pool size."""

    def __init__(self, mode: str = "dynamic", max_parallel: int = 64,
                 record_events: bool = True):
        if mode not in ("dynamic", "fixed"):
            raise ValueError(f"unknown manager mode {mode!r}")
        self.mode = mode
        self.max_parallel = max_parallel
        # lean mode (record_events=False) keeps memory flat over campaigns
        # with hundreds of thousands of executor lifecycles: no event
        # history, terminated executors dropped
        self.record_events = record_events
        self.table = RecordTable()
        self.executors: Dict[int, Executor] = {}
        self._ids = itertools.count()
        # Available "slots" presented to the scheduler as the AvailE queue.
        self.avail: Deque[int] = deque(range(max_parallel))

    # -- lifecycle ---------------------------------------------------------
    def spawn(self, slot: int, client_id: int, budget: float, now: float) -> Executor:
        eid = next(self._ids)
        ex = Executor(eid=eid, budget=budget, client_id=client_id, spawned_at=now,
                      slot=slot)
        self.executors[eid] = ex
        if self.record_events:
            self.table.push(Event(now, eid, EventKind.SPAWN, client_id,
                                  {"budget": budget, "slot": slot}))
            self.table.push(Event(now, eid, EventKind.RUN, client_id))
        return ex

    def complete(self, ex: Executor, now: float) -> None:
        """Client finished: upload, terminate the process, free the slot."""
        if self.record_events:
            self.table.push(Event(now, ex.eid, EventKind.COMPLETE, ex.client_id))
            self.table.push(Event(now, ex.eid, EventKind.UPLOAD, ex.client_id))
        self.terminate(ex, now)

    def fail(self, ex: Executor, now: float) -> None:
        """Executor/client failure: terminate and mark for rescheduling."""
        if self.record_events:
            self.table.push(Event(now, ex.eid, EventKind.FAIL, ex.client_id))
        self.terminate(ex, now)

    def terminate(self, ex: Executor, now: float) -> None:
        if ex.state is ExecState.TERMINATED:
            return
        ex.state = ExecState.TERMINATED
        if self.record_events:
            self.table.push(Event(now, ex.eid, EventKind.TERMINATE, ex.client_id))
        else:
            self.executors.pop(ex.eid, None)
        self.avail.append(ex.slot)

    # -- introspection ------------------------------------------------------
    @property
    def live(self) -> List[Executor]:
        return [e for e in self.executors.values() if e.state is ExecState.RUNNING]

    def parallelism(self) -> int:
        return len(self.live)
