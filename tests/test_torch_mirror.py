"""The port's control-plane mirror against the reference's: the same
campaign with ``mirror=True`` leaves the same ``StatusMonitor`` state and
log, record tables and upload counts, under async round overlap, failures,
churn and capacity sheds too (tests/test_campaign.py:214-366); a mirror
with a delta provider uploads the reference's bits (int8 with the
reference's noise injected, topk, none), over a ``SerializingTransport``
too; and the trainer's default engine mirrors, as the reference's does."""
import numpy as np
import pytest
import torch

from _torch_worlds import ref_noise, round_digest, twin_trainers
from repro.core.campaign import AvailabilityTrace as RefTrace
from repro.core.campaign import CampaignEngine as RefEngine
from repro.core.campaign import CapacityEvent as RefCapacity
from repro.core.campaign import RoundSpec as RefRoundSpec
from repro.core.campaign import SimClient as RefSimClient
from repro.core.scheduler import FedHCScheduler as RefFedHC
from repro.fed.compression import decompress_tree as ref_decompress_tree
from repro.fed.server import FLServer as RefFLServer
from repro.fed.transport import SerializingTransport as RefSerializingTransport
from repro_torch.core import ControlPlaneMirror
from repro_torch.core.campaign import (AvailabilityTrace, CampaignEngine, CapacityEvent,
                                       RoundSpec, SimClient)
from repro_torch.core.scheduler import FedHCScheduler
from repro_torch.fed.compression import decompress_tree
from repro_torch.fed.server import FLServer
from repro_torch.fed.transport import SerializingTransport

FIG13_BUDGETS = [10, 15, 30, 80, 65, 40, 50, 10]
REF = dict(Engine=RefEngine, SimClient=RefSimClient, Sched=RefFedHC, Trace=RefTrace,
           Capacity=RefCapacity, RoundSpec=RefRoundSpec)
PORT = dict(Engine=CampaignEngine, SimClient=SimClient, Sched=FedHCScheduler,
            Trace=AvailabilityTrace, Capacity=CapacityEvent, RoundSpec=RoundSpec)


def _fig13(pkg, work=1.0):
    return [pkg["SimClient"](i, b, work) for i, b in enumerate(FIG13_BUDGETS)]


def _scenario(pkg, name):
    """(engine, results) of one mirrored campaign."""
    E, C, S = pkg["Engine"], pkg["SimClient"], pkg["Sched"]
    if name == "round with a failure":
        eng = E(S, max_parallel=8, mirror=True)
        return eng, [eng.run_round(_fig13(pkg)[:4], failure_times={2: 0.1})]
    if name == "campaign":
        eng = E(S, max_parallel=8, mirror=True)
        return eng, eng.run_campaign([_fig13(pkg)] * 2).rounds
    if name == "async overlap":
        eng = E(S, async_rounds=True, mirror=True)
        return eng, eng.run_campaign([[C(0, 50.0, 1.0), C(1, 50.0, 10.0)]] * 3).rounds
    if name == "async overlap with a failure":
        eng = E(S, async_rounds=True, mirror=True)
        r0 = [C(0, 50.0, 10.0), C(1, 40.0, 1.0)]
        specs = [pkg["RoundSpec"](tuple(r0), failure_times={0: 5.0}),
                 pkg["RoundSpec"]((C(0, 50.0, 1.0),))]
        return eng, eng.run_campaign(specs).rounds
    if name == "churn":
        eng = E(S, availability=pkg["Trace"]({0: [(0.0, 5.0), (8.0, 1e9)]}), mirror=True)
        return eng, eng.run_campaign([[C(0, 50.0, 10.0), C(1, 30.0, 4.0)]]).rounds
    if name == "capacity shed":
        eng = E(S, max_parallel=8, mirror=True,
                capacity_events=[pkg["Capacity"](0.5, 40.0), pkg["Capacity"](3.0, 100.0)])
        return eng, eng.run_campaign([_fig13(pkg, work=2.0)]).rounds
    raise KeyError(name)


SCENARIOS = ["round with a failure", "campaign", "async overlap",
             "async overlap with a failure", "churn", "capacity shed"]


def _mirror_digest(eng):
    srv = eng.server
    return {
        "state": dict(srv.monitor.state),
        "log": [(c, k.value, st) for c, k, st in srv.monitor.log],
        "uploads": sorted(srv.uploads),
        "rows": {cid: [o.kind.value for o in srv.record_table[row]]
                 for cid, row in srv._row_of.items()},
        "comm": eng.mirror.comm_bytes,
    }


@pytest.mark.parametrize("name", SCENARIOS)
def test_mirror_tracks_the_references_state_and_log(name):
    ref_eng, ref_rounds = _scenario(REF, name)
    port_eng, port_rounds = _scenario(PORT, name)
    assert [round_digest(r) for r in port_rounds] == [round_digest(r) for r in ref_rounds]
    assert _mirror_digest(port_eng) == _mirror_digest(ref_eng)
    log = port_eng.server.monitor.log
    done = sum(1 for _, k, st in log if k.value == "upload" and st == "done")
    assert done == sum(len(r.spans) for r in port_rounds)
    assert isinstance(port_eng.mirror, ControlPlaneMirror)


def _deltas(seed=0):
    rng = np.random.default_rng(seed)
    return {cid: ({"w": rng.normal(size=(4, 3)).astype(np.float32) * 0.01,
                   "b": rng.normal(size=(3,)).astype(np.float32) * 0.01}, float(16 + cid))
            for cid in range(4)}


def _leaf_bits(x):
    if type(x).__name__ == "QuantizedTensor":
        return ("q8", np.asarray(x.q).tobytes(), np.float32(x.scale).tobytes())
    if type(x).__name__ == "TopKTensor":
        return ("topk", np.asarray(x.idx).tobytes(), np.asarray(x.vals).tobytes(),
                tuple(x.shape))
    return ("dense", np.asarray(x).dtype.str, np.asarray(x).tobytes())


@pytest.mark.parametrize("serializing", [False, True], ids=["local", "serializing"])
@pytest.mark.parametrize("compression", ["none", "int8", "topk"])
def test_mirror_uploads_are_the_references_bits(compression, serializing):
    """int8 draws its rounding noise through the port's seam, here the
    reference's own noise: q and scale come out bit for bit.  Two rounds,
    so each client's second upload takes the next seed."""
    deltas = _deltas()
    out = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        kw = dict(max_parallel=8, mirror_delta_provider=lambda cid: deltas[cid],
                  mirror_compression=compression)
        if serializing:
            kw["server"] = (RefFLServer(RefSerializingTransport()) if name == "ref"
                            else FLServer(SerializingTransport()))
        if name == "port":
            kw["mirror_noise"] = ref_noise
        eng = pkg["Engine"](pkg["Sched"], **kw)
        res = eng.run_campaign([_fig13(pkg)[:4]] * 2)
        ups = eng.server.uploads
        dq = (ref_decompress_tree if name == "ref" else decompress_tree)
        out[name] = {
            "completed": res.total_completed, "comm": eng.mirror.comm_bytes,
            "leaves": {cid: {k: _leaf_bits(v) for k, v in ups[cid]["delta"].items()}
                       for cid in ups},
            "dense": {cid: {k: np.asarray(v).tobytes() for k, v in
                            dq(ups[cid]["delta"]).items()} for cid in ups},
            "n": {cid: ups[cid]["n"] for cid in ups},
            "wire": getattr(eng.server.transport, "wire_bytes", None),
        }
    assert out["port"] == out["ref"]
    raw = sum(sum(l.nbytes for l in d.values()) for d, _ in deltas.values())
    if compression == "none":
        assert out["port"]["comm"] == 2 * raw
    else:
        assert 0 < out["port"]["comm"] < 2 * raw
    kinds = {v[0] for leaves in out["port"]["leaves"].values() for v in leaves.values()}
    assert kinds == {"none": {"dense"}, "int8": {"q8"}, "topk": {"topk"}}[compression]


def test_mirror_refuses_a_torch_provider_output():
    eng = CampaignEngine(FedHCScheduler, max_parallel=8,
                         mirror_delta_provider=lambda cid: {"w": torch.zeros(3)})
    with pytest.raises(TypeError, match="delta provider: payload value is a torch.Tensor"):
        eng.run_round([SimClient(0, 50.0, 1.0)])


def test_trainer_engine_mirrors_like_the_references():
    """The reference trainer builds its engine with the mirror on; so does
    the port's now: both control planes track every client the same."""
    ref, port = twin_trainers(rounds=2, failure_rate=0.3, client_batching="off")
    ref.run()
    port.run()
    assert _mirror_digest(port.engine) == _mirror_digest(ref.engine)
    assert port.engine.server.monitor.state
    assert {"done", "failed"} >= set(port.engine.server.monitor.state.values())
