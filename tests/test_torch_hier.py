"""The port's hierarchical aggregation tree (``repro_torch.fed.hier``): a
twin of each of tests/test_hier.py's tests on the port, and the port held
against the reference (``repro.fed.hier``) bit for bit on the same numpy
inputs: the simulated deltas and weights, ``ExactAccumulator`` payloads
field for field in every encoding (int8 with the reference's noise
injected; bf16 as ``ml_dtypes`` in the reference and the same bits as a CPU
``torch.bfloat16`` in the port), payloads read by the other package,
digests, flat campaigns, in-process trees, and socket trees whose root and
leaf come from different packages.  Every socket run carries a timeout, so
nothing can hang the suite."""
import importlib.util
import pathlib
import queue
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - dev extra not installed
    from _hypothesis_fallback import given, settings, strategies as st

from _torch_worlds import ref_noise
from repro.fed import compression as ref_comp
from repro.fed import hier as R
from repro.fed import net as ref_net
from repro_torch.fed import compression as port_comp
from repro_torch.fed import hier as P
from repro_torch.fed.net import (AsyncSocketServerTransport, ChaosProxy, FaultPlan,
                                 SocketServerTransport)
from repro_torch.fed.server import FLServer
from repro_torch.obs import ObsPlane

ROOT = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT = 60.0

TEMPLATE = {
    "w": np.zeros((3, 4), np.float32),
    "b": np.zeros(5, np.float32),
    "layers": [np.zeros(7, np.float32), np.zeros((2, 2), np.float32)],
}
METHODS = ("fp32", "bf16", "int8", "topk")


def _as_torch_bf16(a):
    """An ``ml_dtypes`` bf16 array as the CPU ``torch.bfloat16`` of the
    same bits: the port's only form of a bf16 leaf."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _deltas(method, cids, rnd=0, template=TEMPLATE):
    """(reference deltas, port deltas) of ``cids`` in one encoding, the
    same values: int8 from the reference's noise in both packages."""
    ref, port = [], []
    for cid in cids:
        d = R.synth_delta(template, rnd, cid)
        if method == "fp32":
            ref.append(d)
            port.append(d)
        elif method == "bf16":
            b = _map(lambda a: a.astype(ml_dtypes.bfloat16), d)
            ref.append(b)
            port.append(_map(_as_torch_bf16, b))
        else:
            seed = rnd * 1000 + cid
            ref.append(ref_comp.compress_tree(d, method, seed=seed))
            port.append(port_comp.compress_tree(d, method, seed=seed, noise=ref_noise))
    return ref, port


def _assert_payloads_equal(got, want):
    """Two ``PARTIAL_SUM`` payloads field for field: counts, paths, shapes,
    windows, and the bins and signs with their dtypes."""
    assert (got["count"], got["weight"]) == (want["count"], want["weight"])
    if want["acc"] is None:
        assert got["acc"] is None
        return
    g, w = got["acc"], want["acc"]
    assert [list(p) for p in g["paths"]] == [list(p) for p in w["paths"]]
    assert [list(s) for s in g["shapes"]] == [list(s) for s in w["shapes"]]
    assert list(g["k0"]) == list(w["k0"])
    for key in ("bins", "sign"):
        assert len(g[key]) == len(w[key])
        for a, b in zip(g[key], w[key]):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def _random_tree(rng, depth, pods):
    """tests/test_hier.py's random (possibly uneven-depth) tree whose
    leaves are exactly ``pods``."""
    if len(pods) == 1:
        return pods[0]
    if depth == 0:
        return [c for p in pods for c in p]
    fan = min(int(rng.integers(2, 4)), len(pods))
    cuts = sorted(int(x) for x in rng.choice(np.arange(1, len(pods)), size=fan - 1,
                                             replace=False))
    groups, prev = [], 0
    for c in cuts + [len(pods)]:
        groups.append(pods[prev:c])
        prev = c
    return [_random_tree(rng, depth - 1, g) for g in groups]


# --------------------------- property: tree == flat --------------------------


@settings(max_examples=25, deadline=None)
@given(
    seed=st.integers(0, 10**6),
    depth=st.integers(1, 3),
    method=st.sampled_from(list(METHODS)),
)
def test_tree_bit_identical_to_flat_any_shape(seed, depth, method):
    """tests/test_hier.py's property on the port: random trees (uneven
    fan-out, zero-client leaves, stragglers, shuffled fold order), every
    tier's PARTIAL_SUM through the port's codec, reduce bit-identically to
    one flat accumulator; the port's tree payload is the reference's field
    for field, and its mean the reference's flat mean."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 13))
    part = [c for c in range(n) if rng.random() > 0.25] or [0]
    ref_deltas, port_deltas = _deltas(method, range(n), rnd=seed % 5)
    weights = [P.sim_weight(c) for c in range(n)]
    n_pods = int(rng.integers(1, len(part) + 2))
    order = [int(c) for c in rng.permutation(part)]
    pods = [order[i::n_pods] for i in range(n_pods)]
    if rng.random() < 0.5:
        pods.append([])
    rng.shuffle(pods)
    tree = _random_tree(rng, depth, list(pods))
    wire_version = 1 if rng.random() < 0.2 else 2

    payload = P.aggregate_tree_sim(tree, port_deltas, weights, wire_version=wire_version)
    assert payload["count"] == len(part)
    assert payload["weight"] == sum(weights[c] for c in part)
    _assert_payloads_equal(payload, R.aggregate_tree_sim(tree, ref_deltas, weights,
                                                         wire_version=wire_version))
    tree_mean = P.ExactAccumulator.from_payload(payload).finalize_mean()
    flat, ref_flat = P.ExactAccumulator(), R.ExactAccumulator()
    for c in rng.permutation(part):
        flat.fold(port_deltas[c], weights[c])
        ref_flat.fold(ref_deltas[c], weights[c])
    assert P.params_digest(tree_mean) == P.params_digest(flat.finalize_mean()) \
        == R.params_digest(ref_flat.finalize_mean())


# --------------------------- PARTIAL_SUM wire form ---------------------------


@pytest.mark.parametrize("method", METHODS)
def test_payload_roundtrip_preserves_exact_sum(method):
    """Round trip on the port, and the payload the reference's after the
    same folds, field for field; each package reads the other's payload to
    the same mean."""
    ref_deltas, port_deltas = _deltas(method, range(5))
    acc, ref_acc = P.ExactAccumulator(), R.ExactAccumulator()
    for c in range(5):
        acc.fold(port_deltas[c], P.sim_weight(c))
        ref_acc.fold(ref_deltas[c], R.sim_weight(c))
    payload = acc.to_payload()
    _assert_payloads_equal(payload, ref_acc.to_payload())
    back = P.ExactAccumulator.from_payload(payload)
    assert (back.count, back.weight) == (acc.count, acc.weight)
    digest = P.params_digest(acc.finalize_mean())
    assert P.params_digest(back.finalize_mean()) == digest
    assert P.params_digest(P.ExactAccumulator.from_payload(ref_acc.to_payload())
                           .finalize_mean()) == digest
    assert R.params_digest(R.ExactAccumulator.from_payload(payload).finalize_mean()) == digest
    np.testing.assert_array_equal(
        np.concatenate([b.ravel() for b in back.bins]),
        np.concatenate([b.ravel() for b in R.ExactAccumulator.from_payload(payload).bins]))


def test_empty_accumulator_payload_is_countable_but_unfinalizable():
    acc = P.ExactAccumulator()
    p = acc.to_payload()
    assert p["acc"] is None and p["count"] == 0 and p["weight"] == 0
    _assert_payloads_equal(p, R.ExactAccumulator().to_payload())
    back = P.ExactAccumulator.from_payload(p)
    with pytest.raises(ValueError, match="zero total weight"):
        back.finalize_mean()
    other = P.ExactAccumulator()
    other.fold(P.synth_delta(TEMPLATE, 0, 1), 3)
    ref = P.params_digest(other.finalize_mean())
    other.merge(back)
    assert P.params_digest(other.finalize_mean()) == ref


def test_payload_window_out_of_range_rejected():
    acc = P.ExactAccumulator()
    acc.fold(P.synth_delta(TEMPLATE, 0, 1), 2)
    p = acc.to_payload()
    p["acc"]["k0"] = [999] * len(p["acc"]["k0"])
    with pytest.raises(ValueError, match="window out of range"):
        P.ExactAccumulator.from_payload(p)
    p = acc.to_payload()
    p["acc"]["bins"] = [b[:, :-1] for b in p["acc"]["bins"]]     # a column short
    with pytest.raises(ValueError, match="window out of range"):
        P.ExactAccumulator.from_payload(p)


def test_catastrophic_cancellation_is_exact():
    """1e30 + 1.0 - 1e30 == 1.0 exactly, as in the reference."""
    acc = P.ExactAccumulator()
    acc.fold({"x": np.array([1e30, 1.0, 0.5], np.float32)}, 1)
    acc.fold({"x": np.array([-1e30, 0.0, 0.25], np.float32)}, 1)
    s = acc.finalize_sum()
    np.testing.assert_array_equal(s["x"], np.array([0.0, 1.0, 0.75], np.float64))
    assert P.params_digest(acc.finalize_mean()) == P.params_digest(
        {"x": (s["x"] / 2.0).astype(np.float32)})


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_fold_batch_bit_identical_to_fold_loop(dtype):
    """Batched folding equals the loop, on the port and against the
    reference's batch (bf16: the port's stacks are torch.bfloat16)."""
    cids = list(range(37))
    loop, batched, ref_batched = P.ExactAccumulator(), P.ExactAccumulator(), R.ExactAccumulator()
    for c in cids:
        d = P.synth_delta(TEMPLATE, 2, c)
        if dtype == "bf16":
            d = _map(lambda a: _as_torch_bf16(a.astype(ml_dtypes.bfloat16)), d)
        loop.fold(d, P.sim_weight(c))
    for lo, hi in ((0, 10), (10, 30), (30, 37)):
        chunk = cids[lo:hi]
        w = [P.sim_weight(c) for c in chunk]
        stacks = P.synth_delta_batch(TEMPLATE, 2, chunk)
        if dtype == "bf16":
            stacks = [a.astype(ml_dtypes.bfloat16) for a in stacks]
            ref_batched.fold_batch(stacks, w, template=TEMPLATE)
            batched.fold_batch([_as_torch_bf16(a) for a in stacks], w, template=TEMPLATE)
        else:
            ref_batched.fold_batch(stacks, w, template=TEMPLATE)
            batched.fold_batch(stacks, w, template=TEMPLATE)
    assert batched.count == loop.count and batched.weight == loop.weight
    assert P.params_digest(batched.finalize_mean()) == P.params_digest(loop.finalize_mean())
    _assert_payloads_equal(batched.to_payload(), ref_batched.to_payload())


def test_synth_deltas_and_weights_are_the_references():
    for rnd, cid in ((0, 0), (1, 7), (4, 99_999)):
        got, want = P.synth_delta(TEMPLATE, rnd, cid), R.synth_delta(TEMPLATE, rnd, cid)
        assert P.params_digest(got) == R.params_digest(want)
    cids = [3, 1, 4, 1, 5, 9, 2, 6]
    for a, b in zip(P.synth_delta_batch(TEMPLATE, 3, cids), R.synth_delta_batch(TEMPLATE, 3, cids)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert [P.sim_weight(c) for c in range(20)] == [R.sim_weight(c) for c in range(20)]


# --------------------------- content-addressed store -------------------------


def test_params_digest_is_content_addressed():
    a = {"w": np.ones((2, 2), np.float32)}
    b = {"w": np.ones((2, 2), np.float32)}
    assert P.params_digest(a) == P.params_digest(b)
    b["w"][0, 0] += np.float32(1e-7)
    assert P.params_digest(a) != P.params_digest(b)
    assert P.params_digest(a) != P.params_digest({"w": np.ones((2, 2), np.float64)})
    assert P.params_digest(a) != P.params_digest({"w": np.ones(4, np.float32)})
    with pytest.raises(TypeError, match="numpy at the seams"):
        P.params_digest({"w": torch.ones(2)})


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_params_digest_is_the_references(dtype):
    """The same tree hashes alike in both packages; a bf16 leaf as a CPU
    torch.bfloat16 has the address of the reference's ml_dtypes leaf."""
    tree = R.synth_delta(TEMPLATE, 1, 5)
    port = tree
    if dtype == "bf16":
        tree = _map(lambda a: a.astype(ml_dtypes.bfloat16), tree)
        port = _map(_as_torch_bf16, tree)
    assert P.params_digest(port) == R.params_digest(tree)


def test_tree_add_keeps_the_params_dtype_as_the_reference():
    """f32 params and bf16 params (torch.bfloat16 against ml_dtypes) plus
    an f32 delta: the same values and dtype as the reference's."""
    delta = R.synth_delta(TEMPLATE, 0, 3)
    params = _map(lambda a: (a + 1.37).astype(np.float32), R.synth_delta(TEMPLATE, 1, 4))
    assert P.params_digest(P.tree_add(params, delta)) == \
        R.params_digest(R.tree_add(params, delta))
    ref_bf = _map(lambda a: a.astype(ml_dtypes.bfloat16), params)
    got = P.tree_add(_map(_as_torch_bf16, ref_bf), delta)
    assert all(leaf.dtype == torch.bfloat16 for _, leaf in P._flatten(got))
    assert P.params_digest(got) == R.params_digest(R.tree_add(ref_bf, delta))


def test_chunk_store_lru_and_counters():
    store = P.ChunkStore(capacity=2)
    p = {"w": np.zeros(2, np.float32)}
    assert store.put("d1", p) is True
    assert store.put("d1", p) is False
    assert store.get("d1") is p
    store.put("d2", p)
    store.put("d3", p)
    assert store.get("d1") is None
    assert store.get("d3") is p
    assert int(store.misses) == 3 and int(store.hits) == 2


# --------------------------- flat campaigns and in-process trees -------------


@pytest.mark.parametrize("compression", ["none", "int8", "topk"])
def test_flat_campaign_digest_is_the_references(compression):
    cids = list(range(23))
    noise = ref_noise if compression == "int8" else None
    got = P.run_flat_campaign(TEMPLATE, cids, 2, compression=compression, noise=noise)
    want = R.run_flat_campaign(TEMPLATE, cids, 2, compression=compression)
    assert got[0] == want[0]
    assert P.params_digest(got[1]) == got[0]


def test_flat_campaign_int8_default_noise_is_the_ports_own():
    """Without the reference's noise the port's int8 campaign is its own:
    another digest than the reference's, the same on every call."""
    cids = list(range(9))
    a = P.run_flat_campaign(TEMPLATE, cids, 2, compression="int8")[0]
    assert a == P.run_flat_campaign(TEMPLATE, cids, 2, compression="int8")[0]
    assert a != R.run_flat_campaign(TEMPLATE, cids, 2, compression="int8")[0]


@pytest.mark.parametrize("method", METHODS)
def test_aggregate_tree_sim_payload_is_the_references(method):
    tree = [[0, 3], [[1], [], [4, 5, 2]], [6]]
    ref_deltas, port_deltas = _deltas(method, range(7), rnd=2)
    weights = [P.sim_weight(c) for c in range(7)]
    _assert_payloads_equal(P.aggregate_tree_sim(tree, port_deltas, weights),
                           R.aggregate_tree_sim(tree, ref_deltas, weights))


def test_hier_flat_digest_of_the_chip_smoke_is_the_references():
    """chip_smoke.py holds phase 26(a)'s flat digest as a constant (the
    card's machine has no JAX): it is the reference's."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    template = smoke.hier_template()
    want = R.run_flat_campaign(template, range(smoke.HIER_CLIENTS), smoke.HIER_ROUNDS)[0]
    assert smoke.HIER_FLAT_DIGEST == want
    assert P.run_flat_campaign(template, range(smoke.HIER_CLIENTS), smoke.HIER_ROUNDS)[0] == want


# --------------------------- socket trees ------------------------------------


def _leaf_thread(run_leaf, root_host, root_port, leaf_id=0, **kw):
    rq = queue.Queue()
    t = threading.Thread(target=run_leaf, args=(leaf_id, root_host, root_port),
                         kwargs={"ready_queue": rq, **kw}, daemon=True)
    t.start()
    _lid, port = rq.get(timeout=10.0)
    return t, port


def _drive(drive_sim_clients, port, cids, **kw):
    t = threading.Thread(target=drive_sim_clients, args=("127.0.0.1", port, cids, TEMPLATE),
                         kwargs={"threads": 4, "timeout": TIMEOUT, **kw}, daemon=True)
    t.start()
    return t


def test_chaos_leaf_kill_reconnect_no_double_fold():
    """Every client's connection to the port's leaf is killed once
    mid-round: sessions resume, and the int8 campaign (the port's own
    noise on both sides) stays bit-identical to flat."""
    cids = list(range(12))
    root_t = SocketServerTransport("127.0.0.1", 0)
    root = P.RootAggregator(root_t, round_timeout=TIMEOUT)
    leaf, leaf_port = _leaf_thread(P.run_leaf, root_t.host, root_t.port)
    proxy = ChaosProxy("127.0.0.1", leaf_port, FaultPlan(kill_after_frames=3, kill_times=1))
    clients = _drive(P.drive_sim_clients, proxy.port, cids)
    try:
        digest, _ = P.run_root_campaign(root, {0: cids}, TEMPLATE, 2, compression="int8")
        clients.join(timeout=30.0)
        leaf.join(timeout=30.0)
        assert not clients.is_alive() and not leaf.is_alive()
        assert proxy.connections_killed >= 1
        assert digest == P.run_flat_campaign(TEMPLATE, cids, 2, compression="int8")[0]
    finally:
        proxy.close()
        root_t.close()


def test_tree_over_sockets_async_server_counters():
    """Root + 2 port leaves (async selectors servers) over loopback: the
    hier counters line up and the digest is the reference's flat one."""
    obs = ObsPlane()
    cids = list(range(24))
    pods = {0: cids[0::2], 1: cids[1::2]}
    root_t = SocketServerTransport("127.0.0.1", 0, obs=obs)
    root = P.RootAggregator(root_t, obs=obs, round_timeout=TIMEOUT)
    leaves, drivers = [], []
    for lid in (0, 1):
        t, port = _leaf_thread(P.run_leaf, root_t.host, root_t.port, lid, obs=obs)
        leaves.append(t)
        drivers.append(_drive(P.drive_sim_clients, port, pods[lid]))
    try:
        digest, _ = P.run_root_campaign(root, pods, TEMPLATE, 2)
        for t in drivers + leaves:
            t.join(timeout=30.0)
        assert all(not t.is_alive() for t in drivers + leaves)
        assert digest == R.run_flat_campaign(TEMPLATE, cids, 2)[0]
        snap = obs.registry.counters_snapshot()
        assert sum(snap["hier.clients_folded"].values()) == len(cids) * 2
        assert snap["hier.partial_sums"]["root"] == 2 * 2
        assert sum(snap["hier.chunk_misses"].values()) == 2 * 2
        assert sum(snap["hier.chunk_hits"].values()) == 2 * 2
    finally:
        root_t.close()


def test_async_server_speaks_the_flat_protocol_to_a_reference_client():
    """The port's selectors server is a drop-in server for the reference's
    client transport: a plain FLServer round trip."""
    t = AsyncSocketServerTransport("127.0.0.1", 0)
    server = FLServer(t)
    c = ref_net.SocketClientTransport(t.host, t.port, client_id=3, recv_timeout=0.05)
    try:
        c.send_to_server(R.Message(R.MsgType.REGISTER, 3, {"session": c.session}))
        deadline = time.monotonic() + 5.0
        inst = None
        while inst is None and time.monotonic() < deadline:
            server.step()
            inst = c.poll_client(3)
        assert inst is not None and inst.kind is R.MsgType.WAIT
        assert t.wire_bytes > 0
        assert server.monitor.state[3] == "registered"
    finally:
        c.close()
        t.close()


@pytest.mark.parametrize("compression", ["none", "int8", "topk"])
def test_reference_root_over_a_port_leaf(compression):
    """A mixed tree: the reference's root, the port's leaf, the port's
    simulated clients (int8 with the reference's noise injected through
    ``drive_sim_clients``); the digest is the reference's flat one."""
    cids = list(range(10))
    root_t = ref_net.SocketServerTransport("127.0.0.1", 0)
    root = R.RootAggregator(root_t, round_timeout=TIMEOUT)
    leaf, port = _leaf_thread(P.run_leaf, root_t.host, root_t.port, 3)
    clients = _drive(P.drive_sim_clients, port, cids, noise=ref_noise)
    try:
        digest, _ = R.run_root_campaign(root, {3: cids}, TEMPLATE, 2, compression=compression)
        clients.join(timeout=30.0)
        leaf.join(timeout=30.0)
        assert not clients.is_alive() and not leaf.is_alive()
    finally:
        root_t.close()
    assert digest == R.run_flat_campaign(TEMPLATE, cids, 2, compression=compression)[0]


@pytest.mark.parametrize("compression", ["none", "int8", "topk"])
def test_port_root_over_a_reference_leaf(compression):
    """A mixed tree: the port's root, the reference's leaf and simulated
    clients; the digest is the reference's flat one."""
    cids = list(range(10))
    root_t = SocketServerTransport("127.0.0.1", 0)
    root = P.RootAggregator(root_t, round_timeout=TIMEOUT)
    leaf, port = _leaf_thread(R.run_leaf, root_t.host, root_t.port, 2)
    clients = _drive(R.drive_sim_clients, port, cids)
    try:
        digest, _ = P.run_root_campaign(root, {2: cids}, TEMPLATE, 2, compression=compression)
        clients.join(timeout=30.0)
        leaf.join(timeout=30.0)
        assert not clients.is_alive() and not leaf.is_alive()
    finally:
        root_t.close()
    assert digest == R.run_flat_campaign(TEMPLATE, cids, 2, compression=compression)[0]


# --------------------------- 100k clients, two tiers -------------------------


def test_100k_clients_two_tiers_bit_identical_to_flat():
    """100 000 simulated clients over two tiers (8 leaf accumulators, every
    partial through the port's codec) equal the flat run."""
    template = {"w": np.zeros((8, 8), np.float32)}
    n, n_leaves, rounds = 100_000, 8, 2
    cids = list(range(n))
    digest, params, counts = P.run_two_tier_campaign(template, cids, rounds, n_leaves)
    assert counts == [n] * rounds
    assert P.params_digest(params) == digest
    flat_digest, _ = P.run_flat_campaign(template, cids, rounds)
    assert digest == flat_digest
