"""Span/event tracer over both the simulated fabric clock and wall clock.

The port of ``repro.obs.trace``, with its event layout and hot-path
contract.  Events are stored as flat tuples (no dataclass, no dict) so a
traced 10k-client campaign stays cheap; the export layer
(``repro_torch.obs.export``) converts to Chrome trace-event JSON on demand.

Event tuple layout::

    (ph, name, cat, pid, tid, ts_sim, dur_sim, ts_wall, dur_wall, args)

``ph`` is the Chrome phase ("X" complete span, "i" instant).  ``pid`` and
``tid`` are *names* (tenant / slot / session); the exporter assigns the
numeric ids Perfetto wants.  ``ts_sim`` is fabric-clock seconds (None for
wall-only events); ``ts_wall`` is ``time.time()`` epoch seconds (None for
sim-only events).  ``args`` is a small dict or None.

Hot-path contract: call sites hold a ``self._trace`` reference that is
either a ``Tracer`` or ``None`` and guard with ``if self._trace is not
None`` — with tracing disabled the per-event cost is one attribute load
and a branch, nothing else.  ``NULL_TRACER`` exists for call sites that
prefer unconditional calls; every method is a no-op.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

Event = Tuple[str, str, str, str, str, Optional[float], Optional[float],
              Optional[float], Optional[float], Optional[Any]]

#: High-rate spans may carry ``args`` as a positional tuple instead of a
#: dict (a dict literal is ~40% of the per-event cost on the engine hot
#: path); the exporter zips the tuple with the schema registered here.
ARG_SCHEMAS: Dict[str, Tuple[str, ...]] = {
    "client.exec": ("cid", "round", "budget", "status"),
}


class Tracer:
    """Bounded in-memory trace buffer.

    ``max_events`` caps memory: past the cap, new events are dropped and
    counted in ``drops`` (dropping the *tail* keeps the campaign's start
    intact, which is what you want when a run blows the budget).
    """

    __slots__ = ("enabled", "events", "drops", "max_events", "meta",
                 "_flush_cbs")

    def __init__(self, enabled: bool = True, max_events: int = 1_000_000):
        self.enabled = enabled
        self.events: List[Event] = []
        self.drops = 0
        self.max_events = max_events
        self.meta: Dict[str, Any] = {}
        # deferred-emission hooks: a hot loop may log raw records on the
        # side and register a callback that materializes them into event
        # tuples when the trace is actually read (export/report time) —
        # the campaign engine's client.exec spans work this way
        self._flush_cbs: List[Any] = []

    # -- emission -----------------------------------------------------------

    def span(self, name: str, t0: float, t1: float, pid: str, tid: str,
             cat: str = "sim", args: Optional[Dict[str, Any]] = None) -> None:
        """Complete span on the fabric clock (seconds)."""
        if not self.enabled:
            return
        if len(self.events) >= self.max_events:
            self.drops += 1
            return
        self.events.append(
            ("X", name, cat, pid, tid, t0, t1 - t0, None, None, args))

    def instant(self, name: str, t: float, pid: str, tid: str,
                cat: str = "sim",
                args: Optional[Dict[str, Any]] = None) -> None:
        """Instant event on the fabric clock."""
        if not self.enabled:
            return
        if len(self.events) >= self.max_events:
            self.drops += 1
            return
        self.events.append(
            ("i", name, cat, pid, tid, t, None, None, None, args))

    def wall_span(self, name: str, t0: float, t1: float, pid: str, tid: str,
                  cat: str = "wall",
                  args: Optional[Dict[str, Any]] = None) -> None:
        """Complete span on the wall clock (epoch seconds)."""
        if not self.enabled:
            return
        if len(self.events) >= self.max_events:
            self.drops += 1
            return
        self.events.append(
            ("X", name, cat, pid, tid, None, None, t0, t1 - t0, args))

    def wall_instant(self, name: str, pid: str, tid: str, cat: str = "wall",
                     args: Optional[Dict[str, Any]] = None,
                     t: Optional[float] = None) -> None:
        """Instant event on the wall clock (defaults to now)."""
        if not self.enabled:
            return
        if len(self.events) >= self.max_events:
            self.drops += 1
            return
        self.events.append(("i", name, cat, pid, tid, None, None,
                            time.time() if t is None else t, None, args))

    # -- deferred emission --------------------------------------------------

    def add_flush(self, cb) -> None:
        """Register an idempotent callback that materializes deferred
        records into ``events``; run by :meth:`flush` before any read."""
        self._flush_cbs.append(cb)

    def flush(self) -> None:
        for cb in self._flush_cbs:
            cb()

    # -- access -------------------------------------------------------------

    def __len__(self) -> int:
        self.flush()
        return len(self.events)

    def clear(self) -> None:
        self.events.clear()
        self.drops = 0

    def to_dict(self) -> dict:
        """Raw (pre-export) form: JSON-able, one dict per event (tuple
        args are resolved to dicts via ``ARG_SCHEMAS`` here)."""
        keys = ("ph", "name", "cat", "pid", "tid", "ts_sim", "dur_sim",
                "ts_wall", "dur_wall", "args")
        self.flush()
        events = []
        for ev in self.events:
            d = dict(zip(keys, ev))
            d["args"] = resolve_args(d["name"], d["args"])
            events.append(d)
        return {
            "meta": dict(self.meta),
            "drops": self.drops,
            "events": events,
        }

    def save(self, path: str, clock: str = "sim") -> None:
        """Write a Chrome trace-event JSON file (Perfetto-loadable)."""
        import json

        from .export import to_chrome_trace

        with open(path, "w") as f:
            json.dump(to_chrome_trace(self, clock=clock), f)


def resolve_args(name: str, args) -> Optional[Dict[str, Any]]:
    """Dict form of an event's args: tuples are zipped with the span
    name's ``ARG_SCHEMAS`` entry (positional ``arg0..n`` fallback)."""
    if args is None or isinstance(args, dict):
        return args
    schema = ARG_SCHEMAS.get(name)
    if schema is None or len(schema) != len(args):
        schema = tuple(f"arg{i}" for i in range(len(args)))
    return dict(zip(schema, args))


class NullTracer(Tracer):
    """No-op tracer: safe to call unconditionally, records nothing."""

    __slots__ = ()

    def __init__(self):
        super().__init__(enabled=False, max_events=0)

    def span(self, *a, **kw) -> None:
        pass

    def instant(self, *a, **kw) -> None:
        pass

    def wall_span(self, *a, **kw) -> None:
        pass

    def wall_instant(self, *a, **kw) -> None:
        pass


NULL_TRACER = NullTracer()
