"""The port's flat multihost deployment on the CPU: the socket run (spawned
worker processes, loopback TCP) bit for bit against the port's inline run;
the chaos run against the fault-free one; quorum rounds closing DEGRADED;
the port's inline trainer against the reference's ``run_local_inline``;
the mixed world — the reference's server with the port's workers —
against the all-reference run (tests/test_net.py:417-457,
tests/test_faults.py:551,607); and the selector-based server and the
scripted fault schedule (tests/test_hier.py:332, tests/test_faults.py:149),
the port's against the reference's and a campaign through both against
the inline run; and ``--role aggregator``, a leaf of the port's tree.  Every socket run carries the reference's
round timeout, so nothing can hang the suite."""
import argparse
import dataclasses
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

from _torch_worlds import assert_histories_match
from repro.launch import multihost as ref_mh
from repro.models.small import init_small as ref_init_small
from repro_torch.bridge import params_from_numpy
from repro_torch.fed.net import (AsyncSocketServerTransport, ChaosProxy, FaultEvent, FaultPlan,
                                 FaultSchedule, SocketClientTransport, SocketServerTransport)
from repro_torch.fed.server import FLServer, LocalTransport, Message, MsgType, RoundPolicy
from repro_torch.fed.server import run_client_session
from repro_torch.launch import multihost as mh
from repro_torch.obs import ObsPlane
from repro_torch.tree import tree_flatten_with_path, tree_leaves

ROUND_TIMEOUT = 90.0


def _same_bits(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _max_gap(ref_params, port_params):
    ref = {p: np.asarray(v) for p, v in tree_flatten_with_path(jax.device_get(ref_params))}
    got = {p: v.numpy() for p, v in tree_flatten_with_path(port_params)}
    assert ref.keys() == got.keys()
    return max(float(np.max(np.abs(ref[k] - got[k]))) for k in ref)


def test_socket_run_bit_identical_to_inline():
    spec = mh.WorldSpec(n_clients=8, rounds=3, participants_per_round=8)
    local = mh.run_local_inline(spec, device="cpu")
    sock = mh.run_multihost(spec, round_timeout=ROUND_TIMEOUT, device="cpu")
    assert len(local.history) == len(sock.history) == 3
    assert all(r["completed"] == 8 for r in sock.history)
    assert _same_bits(local.params, sock.params)
    wires = [r["wire_bytes"] for r in sock.history]
    assert wires[0] > 0 and wires == sorted(wires)
    assert [r["wire_bytes"] for r in local.history] == [0, 0, 0]
    for r in sock.history:
        assert r["wire_payload_bytes"] + r["wire_header_bytes"] == r["wire_bytes"]


def test_chaos_run_bit_identical_to_fault_free():
    """Every worker's connection killed once mid-session, every third
    client frame duplicated: reconnect + dedup keep the campaign exact."""
    spec = mh.WorldSpec(n_clients=4, rounds=2, participants_per_round=4)
    ref = mh.run_local_inline(spec, device="cpu")
    transport = SocketServerTransport("127.0.0.1", 0)
    proxy = ChaosProxy(transport.host, transport.port,
                       FaultPlan(kill_after_frames=2, kill_times=1, duplicate_every=3))
    try:
        trainer = mh.run_multihost(spec, transport=transport, connect=(proxy.host, proxy.port),
                                   round_timeout=ROUND_TIMEOUT, device="cpu")
    finally:
        proxy.close()
    assert proxy.connections_killed == spec.n_clients
    assert transport.reconnects >= spec.n_clients
    assert [r["completed"] for r in trainer.history] == [4, 4]
    assert _same_bits(ref.params, trainer.params)


def test_dispatcher_quorum_degraded_stragglers_get_round_closed():
    obs = ObsPlane()
    t = LocalTransport()
    server = FLServer(t, obs=obs)
    disp = mh.ControlPlaneDispatcher(server, timeout=30.0, obs=obs,
                                     policy=RoundPolicy(deadline_s=0.3, quorum_frac=0.75))
    cids = list(range(8))

    def clients():
        for cid in cids[:6]:
            assert run_client_session(
                server, cid, lambda s, c=cid: {"delta": {"w": np.full(2, float(c), np.float32)},
                                               "n": 1 + c, "round": 0})

    out = {}
    rt = threading.Thread(target=lambda: out.setdefault(
        "res", disp.train_round(cids, params=None, local_steps=1, rnd=0)), daemon=True)
    rt.start()
    deadline = time.monotonic() + 5.0
    while not server.train_payload and time.monotonic() < deadline:
        time.sleep(0.002)
    driver = threading.Thread(target=clients, daemon=True)
    driver.start()
    rt.join(timeout=30.0)
    driver.join(timeout=30.0)
    assert not rt.is_alive() and not driver.is_alive()
    assert disp.last_round_report == {"mode": "DEGRADED", "reported": cids[:6],
                                      "stragglers": [6, 7]}
    assert [n for _d, n, _m in out["res"]] == [1.0 + c for c in cids[:6]]
    for cid in (6, 7):
        inst = t.poll_client(cid)
        assert inst.kind is MsgType.TERMINATE and inst.payload["reason"] == "round_closed"
    assert obs.registry.counters_snapshot()["fault.round_closed_aborts"]["control"] == 2


def test_quorum_multihost_two_of_eight_never_launched():
    """2 of 8 workers never launch: every round closes DEGRADED at the
    policy deadline and the params equal the inline straggler-drop run."""
    spec = mh.WorldSpec(n_clients=8, rounds=2, participants_per_round=8)
    policy = RoundPolicy(deadline_s=1.0, quorum_frac=0.75)
    transport = LocalTransport()
    mcfg, worker_clients, _test, fed = mh.build_world(spec)
    opt = mh.make_optimizer(fed.optimizer, fed.learning_rate)
    step_fn = mh.make_small_step(mcfg, opt, fed.prox_mu)
    workers = [mh.ClientWorker(transport, c, step_fn, opt, device="cpu")
               for c in worker_clients if c.client_id < 6]
    for w in workers:
        w.start_round()
    ref = mh.run_server(spec, transport, inline_workers=workers, policy=policy, device="cpu")
    obs = ObsPlane()
    sock = mh.run_multihost(spec, round_timeout=ROUND_TIMEOUT, policy=policy,
                            skip_clients=(6, 7), obs=obs, device="cpu")
    assert [r["mode"] for r in ref.history] == ["DEGRADED"] * 2
    assert [r["mode"] for r in sock.history] == ["DEGRADED"] * 2
    assert [r["completed"] for r in sock.history] == [6, 6]
    assert _same_bits(ref.params, sock.params)
    snap = obs.registry.counters_snapshot()
    assert snap["round.degraded"]["trainer"] == 2
    assert snap["fault.round_closed_aborts"]["control"] == 4


def _seeded_from_reference(monkeypatch, spec):
    """Make every port trainer ``multihost`` builds start from the
    reference trainer's initial params (jax.random bits cannot be drawn in
    torch), as tests/_torch_worlds.py:twin_trainers does."""
    ref_mcfg = ref_mh.build_world(spec)[0]
    init = jax.device_get(ref_init_small(jax.random.PRNGKey(spec.seed), ref_mcfg))

    class Seeded(mh.FederatedTrainer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.params = params_from_numpy(init, self.device)

    monkeypatch.setattr(mh, "FederatedTrainer", Seeded)


def test_port_inline_trainer_matches_reference_run_local_inline(monkeypatch):
    spec = ref_mh.WorldSpec(n_clients=8, rounds=3, participants_per_round=8)
    ref = ref_mh.run_local_inline(spec)
    _seeded_from_reference(monkeypatch, spec)
    port = mh.run_local_inline(mh.WorldSpec(n_clients=8, rounds=3, participants_per_round=8),
                               device="cpu")
    assert_histories_match(ref.history, port.history)
    assert _max_gap(ref.params, port.params) <= 1e-5
    assert ref.engine.server.monitor.state == port.engine.server.monitor.state


@pytest.mark.parametrize("compression", ["none", "topk"])
def test_mixed_world_reference_server_port_workers(compression):
    """The reference's server and trainer over its socket transport; the
    port's ``ClientWorker``s on the port's socket transports, one thread
    each, training on the CPU.  Held against the all-reference inline run."""
    from repro.fed.net import SocketServerTransport as RefServerTransport

    ref_spec = ref_mh.WorldSpec(n_clients=8, rounds=3, participants_per_round=8,
                                compression=compression)
    want = ref_mh.run_local_inline(ref_spec)
    spec = mh.WorldSpec(n_clients=8, rounds=3, participants_per_round=8,
                        compression=compression)
    transport = RefServerTransport("127.0.0.1", 0)
    mcfg, clients, _test, fed = mh.build_world(spec)
    opt = mh.make_optimizer(fed.optimizer, fed.learning_rate)
    step_fn = mh.make_small_step(mcfg, opt, fed.prox_mu)
    workers, threads = [], []
    try:
        for c in clients:
            t = SocketClientTransport(transport.host, transport.port, c.client_id,
                                      recv_timeout=0.05)
            w = mh.ClientWorker(t, c, step_fn, opt, session=t.session, poll_sleep=0.02,
                                device="cpu")
            workers.append(w)
            threads.append(threading.Thread(target=w.run, daemon=True))
        for th in threads:
            th.start()
        got = ref_mh.run_server(ref_spec, transport, round_timeout=ROUND_TIMEOUT)
        for th in threads:
            th.join(timeout=30.0)
    finally:
        transport.close()
        for w in workers:
            w.t.close()
    assert not any(th.is_alive() for th in threads)
    assert [w.rounds_trained for w in workers] == [3] * 8
    assert [r["completed"] for r in got.history] == [8, 8, 8]
    assert all(r["wire_bytes"] > 0 for r in got.history)
    assert_histories_match(want.history, got.history)
    ref_leaves = jax.tree.leaves(want.params)
    got_leaves = jax.tree.leaves(got.params)
    assert max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
               for a, b in zip(ref_leaves, got_leaves)) <= 1e-5


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_aggregator_role_serves_a_leaf_through_a_round(capsys):
    """``--role aggregator`` serves leaf 1 of a port root's tree: the root
    drives it through a round of simulated clients, to the flat digest, and
    its shutdown ends the role with the reference's two lines."""
    from repro_torch.fed.hier import (RootAggregator, drive_sim_clients, run_flat_campaign,
                                      run_root_campaign)

    template = {"w": np.zeros((3, 4), np.float32), "b": np.zeros(5, np.float32)}
    cids = list(range(6))
    root_t = SocketServerTransport("127.0.0.1", 0)
    root = RootAggregator(root_t, round_timeout=ROUND_TIMEOUT)
    leaf_port = _free_port()
    leaf = threading.Thread(target=mh.main, args=([
        "--role", "aggregator", "--leaf-id", "1", "--root-host", root_t.host,
        "--root-port", str(root_t.port), "--port", str(leaf_port)],), daemon=True)
    leaf.start()
    clients = threading.Thread(
        target=drive_sim_clients, args=("127.0.0.1", leaf_port, cids, template),
        kwargs={"threads": 2, "timeout": ROUND_TIMEOUT, "max_reconnect_attempts": 40},
        daemon=True)
    clients.start()
    try:
        digest, _ = run_root_campaign(root, {1: cids}, template, 1)
        clients.join(timeout=30.0)
        leaf.join(timeout=30.0)
        assert not clients.is_alive() and not leaf.is_alive()
    finally:
        root_t.close()
    assert digest == run_flat_campaign(template, cids, 1)[0]
    out = capsys.readouterr().out.splitlines()
    assert out[0] == (f"leaf 1: serving clients on 127.0.0.1:{leaf_port}, root at "
                      f"{root_t.host}:{root_t.port}")
    assert out[-1] == "leaf 1: shutdown"


def test_spec_from_args_carries_the_root_address_as_the_reference():
    args = argparse.Namespace(
        clients=6, rounds=2, participants=9, local_steps=3, seed=4, host="10.0.0.2",
        port=7001, compression="topk", wire_version=2, root_host="10.0.0.9", root_port=7002)
    got, want = mh._spec_from_args(args), ref_mh._spec_from_args(args)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.root_host, got.root_port, got.participants_per_round) == ("10.0.0.9", 7002, 6)


def _events(pkg_event):
    return [pkg_event(frame=2, op="kill"),
            pkg_event(frame=3, op="corrupt", client_id=7),
            pkg_event(frame=3, op="blackhole", client_id=8, arg=4),
            pkg_event(frame=5, op="delay", arg=0.01)]


def test_fault_schedule_fires_like_the_reference():
    """The same script and the same (client, frame) walk fire the same
    events, once per client, in the same order, in both packages."""
    from repro.fed.net import FaultEvent as RefFaultEvent
    from repro.fed.net import FaultSchedule as RefFaultSchedule

    ref, port = RefFaultSchedule(_events(RefFaultEvent)), FaultSchedule(_events(FaultEvent))
    rng = np.random.default_rng(0)
    walk = [(None if c < 0 else int(c), int(f))
            for c, f in zip(rng.integers(-1, 10, 200), rng.integers(0, 7, 200))]
    for cid, frame in walk:
        want, got = ref.take(cid, frame), port.take(cid, frame)
        assert [(e.frame, e.op, e.client_id, e.arg) for e in got] == \
            [(e.frame, e.op, e.client_id, e.arg) for e in want]
    assert [(c, e.frame, e.op) for c, e in port.fired] == \
        [(c, e.frame, e.op) for c, e in ref.fired]
    assert len(port.fired) > 10


def test_async_server_speaks_the_flat_protocol_too():
    """The selector-based server is a drop-in ``SocketServerTransport``: a
    plain ``FLServer`` round trip works unchanged."""
    t = AsyncSocketServerTransport("127.0.0.1", 0)
    server = FLServer(t)
    c = SocketClientTransport(t.host, t.port, client_id=3, recv_timeout=0.05)
    try:
        c.send_to_server(Message(MsgType.REGISTER, 3, {"session": c.session}))
        deadline = time.monotonic() + 5.0
        inst = None
        while inst is None and time.monotonic() < deadline:
            server.step()
            inst = c.poll_client(3)
        assert inst is not None and inst.kind is MsgType.WAIT
        assert t.wire_bytes > 0
        assert server.monitor.state[3] == "registered"
    finally:
        c.close()
        t.close()


def test_async_server_through_a_fault_schedule_bit_identical_to_inline():
    """A campaign over the selector-based server, its workers (threads)
    dialing a ``ChaosProxy`` that runs a ``FaultSchedule``: every client's
    connection killed at its third frame, client 1 held back at its fourth.
    Reconnect and retransmit keep it bit for bit the inline run."""
    spec = mh.WorldSpec(n_clients=4, rounds=2, participants_per_round=4)
    want = mh.run_local_inline(spec, device="cpu")
    transport = AsyncSocketServerTransport("127.0.0.1", 0)
    schedule = FaultSchedule([FaultEvent(frame=2, op="kill"),
                              FaultEvent(frame=3, op="delay", client_id=1, arg=0.05)])
    proxy = ChaosProxy(transport.host, transport.port, schedule=schedule)
    mcfg, clients, _test, fed = mh.build_world(spec)
    opt = mh.make_optimizer(fed.optimizer, fed.learning_rate)
    step_fn = mh.make_small_step(mcfg, opt, fed.prox_mu)
    workers, threads = [], []
    try:
        for c in clients:
            t = SocketClientTransport(proxy.host, proxy.port, c.client_id, recv_timeout=0.05)
            w = mh.ClientWorker(t, c, step_fn, opt, session=t.session, poll_sleep=0.02,
                                device="cpu")
            workers.append(w)
            threads.append(threading.Thread(target=w.run, daemon=True))
        for th in threads:
            th.start()
        got = mh.run_server(spec, transport, round_timeout=ROUND_TIMEOUT, device="cpu")
        for th in threads:
            th.join(timeout=30.0)
    finally:
        proxy.close()
        transport.close()
        for w in workers:
            w.t.close()
    assert not any(th.is_alive() for th in threads)
    assert [w.rounds_trained for w in workers] == [2] * 4
    assert [r["completed"] for r in got.history] == [4, 4]
    assert sorted((c, e.op) for c, e in schedule.fired) == \
        [(0, "kill"), (1, "delay"), (1, "kill"), (2, "kill"), (3, "kill")]
    assert proxy.connections_killed == 4 and transport.reconnects >= 4
    assert _same_bits(want.params, got.params)
