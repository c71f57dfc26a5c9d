"""Client schedulers: FedHC's resource-aware double-pointer Algorithm 1 and
the greedy FIFO baseline used by prior frameworks (Flower/FedScale).
A pure-Python copy of ``repro.core.scheduler``.

Faithful port of Algorithm 1:
  * participants sorted by resource budget;
  * a LEFT pointer admits the smallest-budget remaining client, a RIGHT
    pointer the largest, alternating;
  * ``Check_Current_Client`` admits iff the budget fits under θ and an
    executor is free;
  * a failed check at the RIGHT pointer only halts the right pointer (small
    clients can still fill the remaining slack);
  * a failed check at the LEFT pointer ends scheduling (nothing smaller
    exists to fill the gap).

Campaign-scale accounting: ``select`` accepts a precomputed
``running_total`` (the caller maintains it incrementally), and the FedHC
scheduler keeps its pending candidates in a pair of lazy-deletion heaps
(min-budget for the left pointer, max-budget for the right), so a select
call costs O((admitted + 2)·log n), not O(pending) — the difference
between O(n log n) and O(n²) over a 10k-client round.  ``park``/
``unpark`` take clients out of / back into the candidate set in O(log n)
when availability churn moves them, and ``requeue`` returns an evicted
client to pending (optionally with a renegotiated budget).
"""
from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.budget import ClientBudget


@dataclass
class ScheduleEntry:
    client_id: int
    budget: float
    executor_id: int


class SchedulerBase:
    """Stateful per-round scheduler over a fixed participant list."""

    def __init__(self, participants: Sequence[ClientBudget], theta: float = 100.0):
        self.theta = float(theta)
        self.participants = list(participants)
        self.n = len(self.participants)
        self.count = 0  # clients scheduled so far this round

    def select(
        self,
        running_budgets: Sequence[float],
        avail_executors: Deque[int],
        *,
        running_total: Optional[float] = None,
    ) -> List[ScheduleEntry]:
        raise NotImplementedError

    def requeue(self, client_id: int, new_budget: Optional[float] = None) -> None:
        """Return a scheduled client to the pending set (eviction, failure
        rescheduling, availability churn).  Optionally renegotiate its
        budget (elastic downsizing)."""
        raise NotImplementedError

    def park(self, client_id: int) -> None:
        """Remove a *pending* client from the candidate set (it went away).
        O(1): parked clients cost select() nothing, unlike the per-call
        ``available`` predicate scan."""
        raise NotImplementedError

    def unpark(self, client_id: int) -> None:
        """Return a parked client to the candidate set (it came back)."""
        raise NotImplementedError

    def renegotiate_pending(self, cap: float) -> None:
        """Clamp every pending client's budget to the (shrunken) pool so
        admission can still make progress (elastic downsizing)."""
        raise NotImplementedError

    def pending_live(self) -> bool:
        """Any un-scheduled, un-parked candidate left?"""
        return not self.done

    def queue_depth(self) -> int:
        """Un-scheduled, un-parked candidates waiting for an executor."""
        return self.n - self.count

    @property
    def done(self) -> bool:
        return self.count >= self.n


class FedHCScheduler(SchedulerBase):
    """Algorithm 1: resource-aware double-pointer scheduling.

    The pending set lives in two lazy-deletion heaps: ``_min`` pops the
    smallest-budget candidate (left pointer), ``_max`` the largest (right
    pointer).  A heap entry is live iff its version matches the client's
    current version and the client is neither scheduled nor parked; any
    transition back to pending (requeue, unpark, renegotiation) bumps the
    version and pushes fresh entries, so stale duplicates die lazily.
    """

    def __init__(self, participants: Sequence[ClientBudget], theta: float = 100.0):
        super().__init__(participants, theta)
        self._budget: Dict[int, float] = {
            c.client_id: c.budget for c in self.participants
        }
        self._scheduled = set()
        self._parked = set()
        self._ver: Dict[int, int] = {c.client_id: 0 for c in self.participants}
        order = sorted((c.budget, c.client_id) for c in self.participants)
        # an ascending list is a valid min-heap; ties break like the sorted
        # participant array did: left pointer takes the smallest client_id,
        # right pointer the largest
        self._min: List[Tuple[float, int, int]] = [(b, cid, 0) for b, cid in order]
        self._max: List[Tuple[float, float, int]] = [
            (-b, -cid, 0) for b, cid in reversed(order)
        ]
        self._n_live = self.n

    def _peek_live(self, left: bool) -> Optional[Tuple[float, int]]:
        heap = self._min if left else self._max
        while heap:
            if left:
                b, cid, ver = heap[0]
            else:
                nb, ncid, ver = heap[0]
                b, cid = -nb, int(-ncid)
            if (
                cid in self._scheduled
                or cid in self._parked
                or ver != self._ver[cid]
            ):
                heapq.heappop(heap)  # tombstone — each is popped once, ever
                continue
            return b, cid
        return None

    def select(
        self,
        running_budgets,
        avail_executors,
        *,
        running_total: Optional[float] = None,
    ) -> List[ScheduleEntry]:
        total = (
            float(running_total)
            if running_total is not None
            else float(sum(running_budgets))
        )
        s: List[ScheduleEntry] = []
        use_left = True
        right_stopped = False
        while self._n_live > 0 and self.count < self.n and total < self.theta:
            is_left = use_left or right_stopped
            top = self._peek_live(is_left)
            if top is None:
                break
            b, cid = top
            if b + total <= self.theta and avail_executors:
                eid = avail_executors.popleft()
                heapq.heappop(self._min if is_left else self._max)
                total += b
                self.count += 1
                self._scheduled.add(cid)
                self._n_live -= 1
                s.append(ScheduleEntry(cid, b, eid))
            elif is_left:
                break  # failing at the left pointer ends scheduling
            else:
                right_stopped = True
            use_left = not use_left
        return s

    def _push(self, cid: int) -> None:
        """(Re-)insert a pending client under a fresh version."""
        self._ver[cid] += 1
        ver = self._ver[cid]
        b = self._budget[cid]
        heapq.heappush(self._min, (b, cid, ver))
        heapq.heappush(self._max, (-b, -cid, ver))

    def park(self, client_id: int) -> None:
        if client_id in self._scheduled or client_id in self._parked:
            return
        self._parked.add(client_id)
        self._n_live -= 1

    def unpark(self, client_id: int) -> None:
        if client_id not in self._parked:
            return
        self._parked.discard(client_id)
        self._n_live += 1
        self._push(client_id)

    def requeue(self, client_id: int, new_budget: Optional[float] = None) -> None:
        if client_id not in self._scheduled:
            return
        self._scheduled.discard(client_id)
        self.count -= 1
        self._n_live += 1
        if new_budget is not None:
            self._budget[client_id] = float(new_budget)
        self._push(client_id)

    def renegotiate_pending(self, cap: float) -> None:
        floor = max(cap, 1.0)
        for cid, b in self._budget.items():
            if cid not in self._scheduled and b > floor:
                self._budget[cid] = floor
                self._push(cid)

    def pending_live(self) -> bool:
        return self._n_live > 0

    def queue_depth(self) -> int:
        return self._n_live


class GreedyScheduler(SchedulerBase):
    """Prior-framework baseline: FIFO arrival order with head-of-line
    blocking — if the next client does not fit, nothing behind it runs.
    Clients that are currently away keep their queue position but do not
    block the head (they are simply not there to be launched)."""

    def __init__(self, participants: Sequence[ClientBudget], theta: float = 100.0):
        super().__init__(participants, theta)
        self._queue: Deque[ClientBudget] = deque(self.participants)
        self._by_id: Dict[int, ClientBudget] = {
            c.client_id: c for c in self.participants
        }
        self._scheduled = set()
        self._parked = set()
        self._held: Dict[int, ClientBudget] = {}  # parked clients popped lazily
        self._pos: Dict[int, int] = {
            c.client_id: i for i, c in enumerate(self.participants)
        }

    def select(
        self,
        running_budgets,
        avail_executors,
        *,
        running_total: Optional[float] = None,
    ) -> List[ScheduleEntry]:
        total = (
            float(running_total)
            if running_total is not None
            else float(sum(running_budgets))
        )
        s: List[ScheduleEntry] = []
        while self._queue:
            nxt = self._queue[0]
            if nxt.client_id in self._parked:
                # lazily move parked clients aside; unpark restores them
                self._held[nxt.client_id] = self._queue.popleft()
                continue
            if nxt.budget + total <= self.theta and avail_executors:
                self._queue.popleft()
                eid = avail_executors.popleft()
                total += nxt.budget
                self.count += 1
                self._scheduled.add(nxt.client_id)
                s.append(ScheduleEntry(nxt.client_id, nxt.budget, eid))
            else:
                break  # head-of-line blocking
        return s

    def park(self, client_id: int) -> None:
        if client_id in self._scheduled or client_id in self._parked:
            return
        self._parked.add(client_id)

    def unpark(self, client_id: int) -> None:
        if client_id not in self._parked:
            return
        self._parked.discard(client_id)
        held = self._held.pop(client_id, None)
        if held is not None:
            # restore the client's original FIFO position: ahead of everything
            # still queued behind it, but behind any earlier-queued client
            # that was itself restored before (only restored clients can sit
            # in front with a smaller arrival index, so this walk is short)
            i = 0
            for c in self._queue:
                if self._pos[c.client_id] >= self._pos[client_id]:
                    break
                i += 1
            self._queue.insert(i, held)

    def requeue(self, client_id: int, new_budget: Optional[float] = None) -> None:
        if client_id not in self._scheduled:
            return
        self._scheduled.discard(client_id)
        cli = self._by_id[client_id]
        if new_budget is not None:
            cli = ClientBudget(client_id, new_budget)
            self._by_id[client_id] = cli
        self._queue.appendleft(cli)
        self.count -= 1

    def renegotiate_pending(self, cap: float) -> None:
        floor = max(cap, 1.0)

        def clamp(c: ClientBudget) -> ClientBudget:
            if c.budget <= floor:
                return c
            c2 = ClientBudget(c.client_id, floor)
            self._by_id[c.client_id] = c2
            return c2

        self._queue = deque(clamp(c) for c in self._queue)
        for cid, held in list(self._held.items()):
            self._held[cid] = clamp(held)

    def pending_live(self) -> bool:
        return any(c.client_id not in self._parked for c in self._queue)

    def queue_depth(self) -> int:
        return sum(1 for c in self._queue if c.client_id not in self._parked)


SCHEDULERS = {"fedhc": FedHCScheduler, "greedy": GreedyScheduler}
