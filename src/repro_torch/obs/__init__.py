"""repro_torch.obs — the unified observability plane (the port of
``repro.obs``).

One bundle (``ObsPlane``) threads through every layer of the stack:

* ``obs.tracer`` — span/instant events against both the simulated fabric
  clock and the wall clock (``repro_torch.obs.trace``);
* ``obs.registry`` — counters / gauges / bounded histograms with a
  normative name table (``repro_torch.obs.metrics.CANONICAL_METRICS``);
* export — Chrome trace-event / Perfetto JSON
  (``repro_torch.obs.export``) and a plain-text report
  (``repro_torch.obs.report``).

Disabled mode is near-zero-cost: ``ObsPlane(trace=False)`` hands out the
shared ``NULL_TRACER`` and call sites cache ``None`` (see the hot-path
contract in ``repro_torch.obs.trace``).
"""
from __future__ import annotations

from typing import Optional

from .metrics import (CANONICAL_METRICS, Counter, Gauge, Histogram,
                      MetricsRegistry)
from .trace import NULL_TRACER, NullTracer, Tracer

__all__ = [
    "CANONICAL_METRICS", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "NULL_TRACER", "NullTracer", "Tracer", "ObsPlane",
]


class ObsPlane:
    """The observability bundle passed down the stack as ``obs=``."""

    def __init__(self, trace: bool = True, max_events: int = 1_000_000,
                 strict: bool = False):
        self.registry = MetricsRegistry(strict=strict)
        self.tracer: Tracer = Tracer(max_events=max_events) if trace \
            else NULL_TRACER

    @property
    def tracing(self) -> bool:
        return self.tracer.enabled

    def save_trace(self, path: str, clock: str = "sim") -> None:
        self.tracer.save(path, clock=clock)

    def report(self, title: str = "repro_torch.obs report") -> str:
        from .report import render_report

        return render_report(self.registry, tracer=self.tracer, title=title)
