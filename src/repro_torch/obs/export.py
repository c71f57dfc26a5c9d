"""Chrome trace-event / Perfetto JSON export.

The port of ``repro.obs.export``.  Converts a ``Tracer`` (or its
``to_dict()`` form) into the Chrome trace-event JSON object format,
loadable at https://ui.perfetto.dev:

* one *process* per ``pid`` name (tenant, host role, …),
* one *thread* per ``tid`` name within it (executor slot, socket
  session, rounds track, …),
* "M" metadata events name the tracks, "X"/"i" events carry the spans.

Timestamps: Chrome traces use integer-ish microseconds on one timeline.
``clock="sim"`` exports fabric-clock events (ts = sim seconds × 1e6);
``clock="wall"`` exports wall-clock events re-based to the earliest wall
timestamp so the trace starts at t=0.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple, Union

from .trace import Tracer, resolve_args

_CLOCKS = ("sim", "wall")


def _iter_events(source) -> Tuple[Iterable[tuple], int, dict]:
    if isinstance(source, Tracer):
        source.flush()   # materialize deferred hot-path records
        return source.events, source.drops, dict(source.meta)
    # to_dict() form
    keys = ("ph", "name", "cat", "pid", "tid", "ts_sim", "dur_sim",
            "ts_wall", "dur_wall", "args")
    events = [tuple(ev[k] for k in keys) for ev in source.get("events", ())]
    return events, int(source.get("drops", 0)), dict(source.get("meta", {}))


def to_chrome_trace(source: Union[Tracer, dict], clock: str = "sim") -> dict:
    """Render ``source`` to a Chrome trace-event JSON object."""
    if clock not in _CLOCKS:
        raise ValueError(f"clock must be one of {_CLOCKS}, got {clock!r}")
    events, drops, meta = _iter_events(source)

    pids: Dict[str, int] = {}
    tids: Dict[Tuple[str, str], int] = {}
    trace_events: List[dict] = []

    def _track(pid_name: str, tid_name: str) -> Tuple[int, int]:
        pid = pids.get(pid_name)
        if pid is None:
            pid = pids[pid_name] = len(pids) + 1
            trace_events.append({
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": pid_name},
            })
        tkey = (pid_name, tid_name)
        tid = tids.get(tkey)
        if tid is None:
            tid = tids[tkey] = sum(1 for k in tids if k[0] == pid_name) + 1
            trace_events.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": tid_name},
            })
        return pid, tid

    wall_base: Optional[float] = None
    if clock == "wall":
        walls = [ev[7] for ev in events if ev[7] is not None]
        wall_base = min(walls) if walls else 0.0

    for ph, name, cat, pid_name, tid_name, ts_sim, dur_sim, ts_wall, \
            dur_wall, args in events:
        if clock == "sim":
            if ts_sim is None:
                continue
            ts, dur = ts_sim, dur_sim
        else:
            if ts_wall is None:
                continue
            ts, dur = ts_wall - wall_base, dur_wall
        pid, tid = _track(pid_name, tid_name)
        ev: dict = {
            "ph": ph, "name": name, "cat": cat, "pid": pid, "tid": tid,
            "ts": ts * 1e6,
        }
        if ph == "X":
            ev["dur"] = max(dur, 0.0) * 1e6 if dur is not None else 0.0
        elif ph == "i":
            ev["s"] = "t"  # thread-scoped instant
        if args:
            ev["args"] = resolve_args(name, args)
        trace_events.append(ev)

    out_meta = {"clock": clock, "drops": drops}
    out_meta.update(meta)
    return {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "metadata": out_meta,
    }


def validate_chrome_trace(obj) -> List[str]:
    """Structural checks on an exported trace; returns a list of problems
    (empty = valid)."""
    errors: List[str] = []
    if not isinstance(obj, dict):
        return ["trace is not a JSON object"]
    evs = obj.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents is not a list"]
    if not any(e.get("ph") in ("X", "i") for e in evs if isinstance(e, dict)):
        errors.append("trace has no span or instant events")
    for i, e in enumerate(evs):
        if not isinstance(e, dict):
            errors.append(f"event {i} is not an object")
            continue
        ph = e.get("ph")
        if ph not in ("X", "i", "M"):
            errors.append(f"event {i}: unknown phase {ph!r}")
            continue
        if "name" not in e or "pid" not in e or "tid" not in e:
            errors.append(f"event {i}: missing name/pid/tid")
        if ph in ("X", "i") and not isinstance(e.get("ts"), (int, float)):
            errors.append(f"event {i}: missing numeric ts")
        if ph == "X" and not isinstance(e.get("dur"), (int, float)):
            errors.append(f"event {i}: X event missing numeric dur")
    return errors
