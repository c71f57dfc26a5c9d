"""The port's observability plane against the live reference: the metric
primitives and registry, the tracer, the Chrome/Perfetto export and the
text report, on the same scripted inputs and after the same campaigns.

Sim-clock outputs are pure functions of the simulated timeline, so they
must be EQUAL: registry counters, pull gauges and sim histograms, the
trace's sim fields, the sim-clock Perfetto JSON.  Wall-clock fields
(``ts_wall``/``dur_wall``, ``client.train_seconds``) are present in both
and compared after they are taken out.  Inputs come from numpy seeds."""
import json
import re

import numpy as np
import pytest

import repro.obs as ref_obs
import repro.obs.export as ref_export
import repro.obs.report as ref_report
import repro.obs.trace as ref_trace
import repro_torch.obs as port_obs
import repro_torch.obs.export as port_export
import repro_torch.obs.report as port_report
import repro_torch.obs.trace as port_trace

from _torch_worlds import twin_fabric_trainers

PKGS = {"ref": (ref_obs, ref_trace, ref_export), "port": (port_obs, port_trace, port_export)}


def _both(fn):
    return fn(*PKGS["ref"]), fn(*PKGS["port"])


# ------------------- primitives ----------------------------------------------


@pytest.mark.parametrize("edges", [None, (0.5, 1.0, 2.0, 8.0), (1e-4, 1e-2)],
                         ids=["default", "custom", "narrow"])
def test_histogram_buckets_equal_reference(edges):
    values = np.random.default_rng(3).lognormal(-2.0, 2.0, size=500).tolist()

    def run(obs, trace, export):
        h = obs.Histogram(edges)
        for v in values:
            h.observe(v)
        return (h.edges, h.counts, h.snapshot(),
                [h.quantile(q) for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0)])
    ref, port = _both(run)
    assert port == ref
    assert sum(port[1]) == len(values)


def test_histogram_refuses_unsorted_edges_and_empty_snapshot():
    with pytest.raises(ValueError):
        port_obs.Histogram(edges=(2.0, 1.0))
    assert port_obs.Histogram().snapshot() == ref_obs.Histogram().snapshot()


def test_counter_gauge_and_registry_equal_reference():
    def run(obs, trace, export):
        c = obs.Counter()
        c.inc()
        c.inc(4)
        out = [c.value, int(c), float(c)]
        c.reset(42)
        out.append(c.value)
        g = obs.Gauge()
        g.set(3)
        out.append(g.value)
        depth = [7]
        g.bind(lambda: depth[0])
        depth[0] = 9
        out.append(g.value)
        reg = obs.MetricsRegistry()
        reg.counter("fed.comm_bytes", "a").inc(123)
        reg.counter("exec.spawns", "b").inc(2)
        reg.gauge("campaign.queue_depth", "a").set(5)
        reg.histogram("campaign.round_latency", "a").observe(1.5)
        snap = reg.counters_snapshot()
        reg2 = obs.MetricsRegistry()
        reg2.counter("exec.spawns", "c").inc(1)
        reg2.restore_counters(snap)
        out += [reg.snapshot(), reg.names(), snap, reg2.counters_snapshot()]
        return out
    ref, port = _both(run)
    assert port == ref


def test_canonical_table_is_the_references_and_strict_mode_gates_it():
    for name, text in port_obs.CANONICAL_METRICS.items():
        assert ref_obs.CANONICAL_METRICS[name] == text
    for name, text in ref_obs.CANONICAL_METRICS.items():
        assert port_obs.CANONICAL_METRICS[name] == text
    reg = port_obs.MetricsRegistry(strict=True)
    for name in port_obs.CANONICAL_METRICS:
        reg.counter(name, "x")
    assert "hier.leaf_restarts" not in ref_obs.CANONICAL_METRICS
    with pytest.raises(KeyError, match="CANONICAL_METRICS"):
        reg.counter("hier.leaf_restarts", "x")


def test_tracer_units_equal_reference():
    def run(obs, trace, export):
        tr = trace.Tracer(max_events=6)
        tr.span("round", 1.0, 3.0, "t", "rounds", args={"round": 0})
        tr.instant("capacity.change", 2.0, "t", "rounds")
        tr.wall_span("client.train", 100.0, 101.5, "trainer", "train")
        tr.wall_instant("round.degraded", "trainer", "rounds", t=100.0)
        pending = [("deferred", 4.0)]

        def flush():
            for name, t in pending:
                tr.instant(name, t, "p", "t")
            pending.clear()
        tr.add_flush(flush)
        for i in range(4):
            tr.span("client.exec", float(i), i + 0.5, "t", f"slot {i}", args=(i, 0, 10.0, "ok"))
        off = trace.Tracer(enabled=False)
        off.span("round", 0, 1, "t", "r")
        trace.NULL_TRACER.span("x", 0, 1, "p", "t")
        return (len(tr), tr.drops, tr.to_dict(), len(off), len(trace.NULL_TRACER),
                trace.resolve_args("client.exec", (7, 2, 0.5, "ok")),
                trace.resolve_args("no.schema", (1, 2)))
    ref, port = _both(run)
    assert port == ref
    assert port[1] > 0


def test_export_validation_equal_reference():
    bad = [{"traceEvents": "nope"}, [], {"traceEvents": []},
           {"traceEvents": [{"ph": "X", "name": "x", "pid": 1, "tid": 1, "ts": 0.0}]},
           {"traceEvents": [{"ph": "Q", "name": "x", "pid": 1, "tid": 1}, 3]}]
    for obj in bad:
        ref, port = _both(lambda obs, trace, export: export.validate_chrome_trace(obj))
        assert port == ref and port
    with pytest.raises(ValueError):
        port_export.to_chrome_trace(port_trace.Tracer(), clock="tai")


# ------------------- after the same campaigns --------------------------------


def _churn_campaign(obs_pkg):
    """The reference's obs campaign: 40 FedScale-budget clients, a quarter
    of them churning, 3 rounds on 8 executors, in the package of
    ``obs_pkg``."""
    import importlib
    root = obs_pkg.__name__.split(".")[0]
    budget = importlib.import_module(f"{root}.core.budget")
    campaign = importlib.import_module(f"{root}.core.campaign")
    scheduler = importlib.import_module(f"{root}.core.scheduler")
    obs = obs_pkg.ObsPlane(trace=True)
    clients = [campaign.SimClient(b.client_id, b.budget, 1.0)
               for b in budget.fedscale_budget_distribution(40, seed=0)]
    churn = campaign.AvailabilityTrace.periodic(
        [c.client_id for c in clients[:10]], period=20.0, duty=0.6, horizon=1e4, seed=1)
    eng = campaign.CampaignEngine(scheduler.FedHCScheduler, max_parallel=8,
                                  availability=churn, obs=obs)
    res = eng.run_campaign([clients] * 3)
    return obs, res


def test_campaign_registry_and_trace_equal_reference():
    (ref, ref_res), (port, port_res) = _both(lambda obs, t, e: _churn_campaign(obs))
    assert port.registry.snapshot() == ref.registry.snapshot()
    assert len(port.tracer) == len(ref.tracer)
    assert port.tracer.to_dict() == ref.tracer.to_dict()
    snap = port.registry.snapshot()["counters"]
    assert snap["campaign.clients_completed"]["campaign"] == port_res.total_completed
    assert snap["campaign.clients_evicted"]["campaign"] == port_res.churn_evictions > 0
    assert port.tracer.drops == 0


@pytest.fixture(scope="module")
def traced_fabric():
    """Two trainer tenants on one fabric with a traced obs plane in each
    package: sim spans from the engines, wall spans from the trainers."""
    _, _, _, ref, port = twin_fabric_trainers(obs=True)
    return ref, port


def _sim_fields(tracer):
    tracer.flush()
    return [ev[:7] + (ev[9],) for ev in tracer.events]


def test_trace_sim_fields_equal_with_wall_fields_present(traced_fabric):
    ref, port = traced_fabric
    assert _sim_fields(port.tracer) == _sim_fields(ref.tracer)
    wall = [ev for ev in port.tracer.events if ev[5] is None]
    names = {(ev[3], ev[1]) for ev in wall}
    assert {("A", "client.batch_wave"), ("B", "client.train"), ("A", "round.aggregate")} <= names
    assert all(ev[7] is not None and ev[8] >= 0.0 for ev in wall)
    assert [(ev[3], ev[1]) for ev in wall] == \
        [(ev[3], ev[1]) for ev in ref.tracer.events if ev[5] is None]


def _without_wall(chrome):
    """A Chrome trace with the wall timestamps and durations taken out."""
    evs = [{k: v for k, v in e.items() if k not in ("ts", "dur")} for e in chrome["traceEvents"]]
    return dict(chrome, traceEvents=evs)


def test_perfetto_export_equal_reference(traced_fabric, tmp_path):
    ref, port = traced_fabric
    sim = port_export.to_chrome_trace(port.tracer, clock="sim")
    assert sim == ref_export.to_chrome_trace(ref.tracer, clock="sim")
    assert port_export.validate_chrome_trace(sim) == []
    procs = {e["args"]["name"] for e in sim["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert procs == {"A", "B"}
    wall = port_export.to_chrome_trace(port.tracer, clock="wall")
    assert port_export.validate_chrome_trace(wall) == []
    assert _without_wall(wall) == _without_wall(ref_export.to_chrome_trace(ref.tracer,
                                                                         clock="wall"))
    for clock in ("sim", "wall"):
        path = tmp_path / f"{clock}.json"
        port.save_trace(str(path), clock=clock)
        assert json.loads(path.read_text()) == (sim if clock == "sim" else wall)


#: report lines that carry wall-clock numbers: the local-training histogram
_WALL_LINE = re.compile(r"client\.train_seconds\[")


def _masked(text):
    return [re.sub(r"=[^ ]+", "=<wall>", ln) if _WALL_LINE.search(ln) else ln
            for ln in text.splitlines()]


def test_report_lines_equal_modulo_wall_numbers(traced_fabric):
    ref, port = traced_fabric
    ref_text, port_text = ref.report(title="obs report"), port.report(title="obs report")
    assert _masked(port_text) == _masked(ref_text)
    assert any(_WALL_LINE.search(ln) for ln in port_text.splitlines())
    from_snap = port_report.render_report(json.loads(json.dumps(port.registry.snapshot())),
                                          title="obs report")
    assert _masked(from_snap) == _masked(ref_report.render_report(
        json.loads(json.dumps(ref.registry.snapshot())), title="obs report"))

def test_histogram_of_train_seconds_counts_every_collection(traced_fabric):
    ref, port = traced_fabric
    for tid in ("A", "B"):
        got = port.registry.histogram("client.train_seconds", tid)
        want = ref.registry.histogram("client.train_seconds", tid)
        assert got.count == want.count > 0
        assert got.edges == want.edges
