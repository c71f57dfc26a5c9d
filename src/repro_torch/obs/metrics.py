"""Metrics registry: counters, gauges, bounded histograms.

The port of ``repro.obs.metrics``: one shared set of primitives for the
counters of the stack.  ``Counter`` is the byte-accounting primitive the
trainer's ``comm_bytes`` rides on, with or without an observability plane.

Design constraints, in order:

1. hot-path cost — ``Counter.inc`` is one attribute add, no locks;
2. no dependencies — stdlib only;
3. counters hold exact ints (or floats where the accounting is a float),
   never sampled or rounded.

``CANONICAL_METRICS`` is the normative name table, trimmed to the names
the port registers; every entry is the reference's, word for word.
"""
from __future__ import annotations

from bisect import bisect_right
from typing import Dict, List, Optional, Sequence, Tuple


class Counter:
    """Monotonic accumulator (int or float, matching what you feed it)."""

    __slots__ = ("value",)

    def __init__(self, value=0):
        self.value = value

    def inc(self, n=1):
        self.value += n

    def reset(self, value=0) -> None:
        """Checkpoint-resume support: restore an absolute value."""
        self.value = value

    def __int__(self) -> int:
        return int(self.value)

    def __float__(self) -> float:
        return float(self.value)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Counter({self.value!r})"


class Gauge:
    """Instantaneous value: last-write-wins via :meth:`set`, or *pull mode*
    via :meth:`bind` — a bound callable is evaluated at read time, so a
    hot loop never pays to keep the gauge current (the campaign engine
    binds its queue-depth/utilization gauges this way)."""

    __slots__ = ("_value", "fn")

    def __init__(self, value=0.0):
        self._value = value
        self.fn = None

    def set(self, v) -> None:
        self.fn = None
        self._value = v

    def bind(self, fn) -> None:
        """Pull mode: ``value`` evaluates ``fn()`` on every read."""
        self.fn = fn

    @property
    def value(self):
        return self._value if self.fn is None else self.fn()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Gauge({self.value!r})"


class Histogram:
    """Bounded histogram: fixed bucket edges chosen at creation time, so
    ``observe`` is a bisect + two adds — no allocation, no growth."""

    __slots__ = ("edges", "counts", "count", "sum", "min", "max")

    #: default edges: ~exponential from 1ms to ~17min, good for both
    #: wall-clock training steps and fabric-clock round latencies.
    DEFAULT_EDGES: Tuple[float, ...] = tuple(
        0.001 * (4.0 ** i) for i in range(10)
    )

    def __init__(self, edges: Optional[Sequence[float]] = None):
        self.edges: Tuple[float, ...] = tuple(edges) if edges else self.DEFAULT_EDGES
        if list(self.edges) != sorted(self.edges):
            raise ValueError("histogram edges must be sorted ascending")
        self.counts: List[int] = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        self.counts[bisect_right(self.edges, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Bucket-upper-edge estimate of the q-quantile (q in [0, 1])."""
        if not self.count:
            return 0.0
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target and c:
                if i >= len(self.edges):
                    return self.max
                return self.edges[i]
        return self.max

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.mean,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "p50": self.quantile(0.5),
            "p99": self.quantile(0.99),
        }


#: Normative metric-name table: every name the port registers (a strict
#: registry refuses any other).
CANONICAL_METRICS: Dict[str, str] = {
    "campaign.rounds_completed": "counter — rounds closed by the engine",
    "campaign.clients_completed": "counter — client executions that reached COMPLETE",
    "campaign.clients_failed": "counter — client executions that FAILed",
    "campaign.clients_evicted": "counter — executions evicted (deadline / availability)",
    "campaign.round_latency": "histogram — per-round fabric-clock duration (s)",
    "campaign.queue_depth": "gauge (pull) — scheduler pending queue depth, read-time",
    "campaign.slot_utilization": "gauge (pull) — granted rate / capacity, read-time",
    "fabric.preemptions": "counter — slot leases preempted by the arbiter",
    "fabric.capacity_events": "counter — elastic capacity changes applied",
    "exec.spawns": "counter — executor processes spawned",
    "fed.comm_bytes": "counter — application-level bytes moved (mirror/trainer)",
    "round.degraded": "counter — rounds closed DEGRADED by the quorum policy",
    "client.train_seconds": "histogram — wall-clock local training time (s)",
    "client.batch_waves": "counter — batched COLLECT waves executed",
    "client.batch_clients": "counter — clients trained through batched waves",
    "client.batch_compiles": "counter — wave programs built (compile-cache misses)",
    "client.batch_fallbacks": "counter — wave clients run on the sequential fallback",
}


class MetricsRegistry:
    """Get-or-create registry keyed by ``(name, scope)``.

    ``scope`` separates instances of the same logical metric (per tenant,
    per session, per transport) while keeping one canonical name for the
    name table.  ``snapshot()`` flattens to plain dicts for JSON export.
    """

    def __init__(self, strict: bool = False):
        self._counters: Dict[Tuple[str, str], Counter] = {}
        self._gauges: Dict[Tuple[str, str], Gauge] = {}
        self._histograms: Dict[Tuple[str, str], Histogram] = {}
        self.strict = strict

    def _check(self, name: str) -> None:
        if self.strict and name not in CANONICAL_METRICS:
            raise KeyError(
                f"metric {name!r} is not in CANONICAL_METRICS — add it to "
                f"the normative table"
            )

    def counter(self, name: str, scope: str = "") -> Counter:
        key = (name, scope)
        c = self._counters.get(key)
        if c is None:
            self._check(name)
            c = self._counters[key] = Counter()
        return c

    def gauge(self, name: str, scope: str = "") -> Gauge:
        key = (name, scope)
        g = self._gauges.get(key)
        if g is None:
            self._check(name)
            g = self._gauges[key] = Gauge()
        return g

    def histogram(self, name: str, scope: str = "",
                  edges: Optional[Sequence[float]] = None) -> Histogram:
        key = (name, scope)
        h = self._histograms.get(key)
        if h is None:
            self._check(name)
            h = self._histograms[key] = Histogram(edges)
        return h

    def names(self) -> List[str]:
        seen = set()
        for (name, _scope) in (*self._counters, *self._gauges,
                               *self._histograms):
            seen.add(name)
        return sorted(seen)

    def counters_snapshot(self) -> dict:
        """``{name: {scope: value}}`` for every live counter — the
        checkpointable subset of :meth:`snapshot`.  Counters are the only
        primitive worth persisting: gauges are instantaneous (often bound
        to callables) and histograms summarize a window, but counters are
        cumulative accounting that must stay monotone across a resume."""
        out: dict = {}
        for (name, scope), c in sorted(self._counters.items()):
            out.setdefault(name, {})[scope] = c.value
        return out

    def restore_counters(self, values: dict) -> None:
        """Re-seed counters from a :meth:`counters_snapshot` (checkpoint
        meta).  Missing counters are created; counters absent from the
        snapshot keep their current value (a restored trainer may share
        the registry with scopes that never checkpointed)."""
        for name, scopes in values.items():
            for scope, v in scopes.items():
                self.counter(name, scope).reset(v)

    def snapshot(self) -> dict:
        """``{kind: {name: {scope: value_or_dict}}}`` — JSON-ready."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for (name, scope), c in sorted(self._counters.items()):
            out["counters"].setdefault(name, {})[scope] = c.value
        for (name, scope), g in sorted(self._gauges.items()):
            out["gauges"].setdefault(name, {})[scope] = g.value
        for (name, scope), h in sorted(self._histograms.items()):
            out["histograms"].setdefault(name, {})[scope] = h.snapshot()
        return out
