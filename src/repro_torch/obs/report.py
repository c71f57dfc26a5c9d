"""Plain-text observability report: the port of ``repro.obs.report``.

Human-readable summary of a registry snapshot (plus optional trace
stats) for terminals and CI logs — the no-Perfetto companion to
``repro_torch.obs.export``.
"""
from __future__ import annotations

from typing import Optional, Union

from .metrics import MetricsRegistry
from .trace import Tracer


def _fmt(v) -> str:
    if isinstance(v, float):
        if v and (abs(v) >= 1e6 or abs(v) < 1e-3):
            return f"{v:.3e}"
        return f"{v:,.3f}".rstrip("0").rstrip(".")
    return f"{v:,}"


def render_report(registry: Union[MetricsRegistry, dict],
                  tracer: Optional[Tracer] = None,
                  title: str = "repro_torch.obs report") -> str:
    """Render a registry (or its ``snapshot()`` dict) as aligned text."""
    snap = registry.snapshot() if isinstance(registry, MetricsRegistry) \
        else registry
    lines = [title, "=" * len(title)]

    counters = snap.get("counters", {})
    gauges = snap.get("gauges", {})
    if counters or gauges:
        lines.append("")
        lines.append("counters / gauges")
        lines.append("-----------------")
        rows = []
        for name, scopes in counters.items():
            for scope, v in scopes.items():
                rows.append((f"{name}[{scope}]" if scope else name, _fmt(v)))
        for name, scopes in gauges.items():
            for scope, v in scopes.items():
                rows.append((f"{name}[{scope}]" if scope else name, _fmt(v)))
        width = max(len(r[0]) for r in rows)
        lines += [f"  {n:<{width}}  {v:>14}" for n, v in rows]

    hists = snap.get("histograms", {})
    if hists:
        lines.append("")
        lines.append("histograms")
        lines.append("----------")
        for name, scopes in hists.items():
            for scope, h in scopes.items():
                label = f"{name}[{scope}]" if scope else name
                lines.append(
                    f"  {label}: n={h['count']:,} mean={_fmt(h['mean'])} "
                    f"p50={_fmt(h['p50'])} p99={_fmt(h['p99'])} "
                    f"max={_fmt(h['max'])}"
                )

    if tracer is not None:
        lines.append("")
        lines.append(
            f"trace: {len(tracer):,} events"
            + (f" ({tracer.drops:,} dropped past cap)" if tracer.drops
               else "")
        )
    return "\n".join(lines) + "\n"

