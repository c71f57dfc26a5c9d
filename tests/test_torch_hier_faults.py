"""The leaf tests of tests/test_faults.py on the port's hierarchical tree
(``repro_torch.fed.hier``): the accumulator checkpoint that bounds journal
replay, a spawned port leaf SIGKILLed mid-round and restarted on its
journal, corrupted PARTIAL_SUM frames on the leaf's uplink, and a leaf
round closing DEGRADED under a quorum policy.  A leaf journal written by
either package is recovered by the other's ``wal.recover`` with the same
open round, checkpoint window and uploads.  The shapes are the reference
tests'; every socket run carries a timeout."""
import multiprocessing as mp
import os
import queue
import signal
import socket
import threading
import time

import numpy as np
import pytest

from _torch_worlds import ref_noise
from repro.fed import compression as ref_comp
from repro.fed import hier as R
from repro.fed import wal as ref_wal
from repro_torch.fed import compression as port_comp
from repro_torch.fed import hier as P
from repro_torch.fed import wal as port_wal
from repro_torch.fed.net import ChaosProxy, FaultPlan, SocketServerTransport
from repro_torch.fed.server import RoundPolicy
from repro_torch.fed.transport import QuantizedTensor

TEMPLATE = {
    "w": np.zeros((3, 4), np.float32),
    "b": np.zeros(5, np.float32),
}
TIMEOUT = 60.0


def _free_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _sample_upload(cid: int, rnd: int):
    return {"delta": {"w": np.full((3, 4), float(cid), np.float32)},
            "n": 10 + cid, "round": rnd}


def test_wal_checkpoint_bounds_replay(tmp_path):
    """Recovery adopts the newest accumulator checkpoint and re-folds only
    the uploads journaled after it."""
    path = tmp_path / "ckpt.wal"
    acc = P.ExactAccumulator()
    with port_wal.RoundJournal(path) as j:
        j.open_round(0)
        for cid in (1, 2, 3):
            up = _sample_upload(cid, 0)
            j.upload(cid, up)
            acc.fold(up["delta"], up["n"])
            if cid == 2:
                j.checkpoint(2, {"round": 0, **acc.to_payload()})
    live = port_wal.recover(path).open_round
    assert live.checkpoint_folds == 2
    restored = P.ExactAccumulator.from_payload(live.checkpoint)
    for _cid, up in live.uploads[live.checkpoint_folds:]:
        restored.fold(up["delta"], up["n"])
    assert restored.count == acc.count and restored.weight == acc.weight
    assert P.params_digest(restored.finalize_mean()) == P.params_digest(acc.finalize_mean())


PACKAGES = {"ref": (ref_wal, R, ref_comp, None), "port": (port_wal, P, port_comp, ref_noise)}


def _write_leaf_journal(path, pkg):
    """A leaf's journal as ``pkg``'s LeafAggregator writes it: round 0
    closed, round 1 open with four int8 uploads (the reference's noise in
    both packages) and an accumulator checkpoint after two folds.
    Returns the round-1 accumulator's digest."""
    wal, hier, comp, noise = PACKAGES[pkg]
    kw = {} if noise is None else {"noise": noise}
    acc = hier.ExactAccumulator()
    with wal.RoundJournal(path) as j:
        j.open_round(0, digest="d0")
        j.upload(7, {"delta": hier.synth_delta(TEMPLATE, 0, 7), "n": 3, "round": 0})
        j.close_round(0, mode="FULL", count=1, weight=3)
        j.open_round(1, digest="d1")
        for i, cid in enumerate((4, 5, 6, 7), 1):
            delta = comp.compress_tree(hier.synth_delta(TEMPLATE, 1, cid), "int8",
                                       seed=1000 + cid, **kw)
            up = {"delta": delta, "n": hier.sim_weight(cid), "round": 1}
            j.upload(cid, up)
            acc.fold(delta, up["n"])
            if i == 2:
                j.checkpoint(i, {"round": 1, **acc.to_payload()})
    return hier.params_digest(acc.finalize_mean())


def _as_plain(x):
    """A recovered payload in a package-neutral form: int8 leaves as
    ``(q, scale)``, arrays as numpy."""
    if isinstance(x, dict):
        return {k: _as_plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_as_plain(v) for v in x]
    if hasattr(x, "q") and hasattr(x, "scale"):
        return ("int8", _as_plain(np.asarray(x.q)), float(x.scale))
    if isinstance(x, np.ndarray):
        return ("array", str(x.dtype), x.shape, x.tobytes())
    return x


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_leaf_journal_recovers_across_packages(tmp_path, writer, reader):
    """A leaf journal written by one package is recovered by the other's
    ``wal.recover`` as by the writer's own: the same open round, checkpoint
    window and uploads; and the reader's accumulator resumes from it to
    the writer's digest."""
    path = tmp_path / "leaf.wal"
    digest = _write_leaf_journal(path, writer)
    read_wal, read_hier = PACKAGES[reader][:2]
    got, want = read_wal.recover(path), PACKAGES[writer][0].recover(path)
    assert (got.records, got.torn) == (want.records, want.torn)
    assert got.uploaded_rounds == want.uploaded_rounds == {7: {0, 1}, 4: {1}, 5: {1}, 6: {1}}
    live, live_w = got.open_round, want.open_round
    assert live.round == live_w.round == 1
    assert live.checkpoint_folds == live_w.checkpoint_folds == 2
    assert _as_plain(live.checkpoint) == _as_plain(live_w.checkpoint)
    assert [c for c, _ in live.uploads] == [c for c, _ in live_w.uploads] == [4, 5, 6, 7]
    assert _as_plain(live.uploads) == _as_plain(live_w.uploads)
    assert got.rounds[0].closed and got.rounds[0].close_meta == want.rounds[0].close_meta
    if reader == "port":
        assert all(isinstance(q, QuantizedTensor) for _, up in live.uploads
                   for q in up["delta"].values())
    acc = read_hier.ExactAccumulator.from_payload(live.checkpoint)
    for _cid, up in live.uploads[live.checkpoint_folds:]:
        acc.fold(up["delta"], up["n"])
    assert acc.count == 4
    assert read_hier.params_digest(acc.finalize_mean()) == digest


# --------------------------- leaf SIGKILL chaos ------------------------------


def _wal_upload_count(path, rnd: int) -> int:
    try:
        rec = port_wal.recover(path)
    except port_wal.WalError:
        return 0
    r = rec.rounds.get(rnd)
    return len(r.uploads) if r is not None else 0


def test_leaf_sigkill_midround_recovers_bit_identical(tmp_path):
    """A spawned port leaf SIGKILLed mid-round with uploads journaled; the
    restarted leaf (same port, same journal) replays the journal, refuses
    re-uploads, finishes the round, and the campaign digest is the no-fault
    flat run's (the reference's too) with zero duplicate aggregation."""
    cids = list(range(10))
    rounds = 2
    wal_path = str(tmp_path / "leaf0.wal")
    leaf_port = _free_port()
    root_t = SocketServerTransport("127.0.0.1", 0)
    root = P.RootAggregator(root_t, round_timeout=120.0)
    ctx = mp.get_context("spawn")

    def spawn_leaf():
        ready = ctx.Queue()
        p = ctx.Process(
            target=P.run_leaf, args=(0, root_t.host, root_t.port),
            kwargs={"port": leaf_port, "ready_queue": ready,
                    "wal_path": wal_path, "wal_checkpoint_every": 2},
            daemon=True)
        p.start()
        assert ready.get(timeout=30.0) == (0, leaf_port)
        return p

    def drive(batch):
        t = threading.Thread(
            target=P.drive_sim_clients, args=("127.0.0.1", leaf_port, batch, TEMPLATE),
            kwargs={"threads": 3, "timeout": 120.0, "max_reconnect_attempts": 40},
            daemon=True)
        t.start()
        return t

    proc = spawn_leaf()
    result = {}

    def campaign():
        result["digest"], _ = P.run_root_campaign(root, {0: cids}, TEMPLATE, rounds)

    camp = threading.Thread(target=campaign, daemon=True)
    camp.start()
    first = drive(cids[:6])
    try:
        deadline = time.monotonic() + 60.0
        while _wal_upload_count(wal_path, 0) < 3:
            assert time.monotonic() < deadline, "no uploads journaled"
            time.sleep(0.02)
        os.kill(proc.pid, signal.SIGKILL)
        proc.join(timeout=10.0)
        journaled_before = _wal_upload_count(wal_path, 0)
        assert journaled_before >= 3

        proc = spawn_leaf()
        second = drive(cids[6:])
        camp.join(timeout=120.0)
        assert not camp.is_alive(), "campaign hung after leaf restart"
        first.join(timeout=30.0)
        second.join(timeout=30.0)
        assert not first.is_alive() and not second.is_alive()
        proc.join(timeout=30.0)
    finally:
        if proc.is_alive():
            proc.terminate()
        root_t.close()

    flat_digest, _ = P.run_flat_campaign(TEMPLATE, cids, rounds)
    assert result["digest"] == flat_digest == R.run_flat_campaign(TEMPLATE, cids, rounds)[0]
    for rec in (port_wal.recover(wal_path), ref_wal.recover(wal_path)):
        for rnd in range(rounds):
            assert rec.rounds[rnd].closed
            assert rec.rounds[rnd].close_meta["mode"] == "FULL"
            assert rec.rounds[rnd].close_meta["count"] == len(cids)
            ups = [(c, p.get("round")) for c, p in rec.rounds[rnd].uploads]
            assert len(ups) == len(set(ups)) == len(cids)
        assert len(rec.rounds[0].uploads) > journaled_before - 1


# --------------------------- PARTIAL_SUM corruption fuzz ---------------------


@pytest.mark.parametrize("tail_only", [True, False])
def test_partial_sum_corruption_never_misaggregates(tail_only):
    """The port leaf's uplink through a corrupting ChaosProxy: a flipped
    PARTIAL_SUM is caught by the codec, the leaf retransmits the clean
    copy, and the digest still equals flat."""
    cids = list(range(8))
    root_t = SocketServerTransport("127.0.0.1", 0)
    root = P.RootAggregator(root_t, round_timeout=TIMEOUT)
    plan = FaultPlan(corrupt_after_frames=2, corrupt_times=2, corrupt_tail_only=tail_only)
    proxy = ChaosProxy(root_t.host, root_t.port, plan)
    ready = queue.Queue()
    leaf_thread = threading.Thread(target=P.run_leaf, args=(0, proxy.host, proxy.port),
                                   kwargs={"ready_queue": ready}, daemon=True)
    leaf_thread.start()
    _lid, leaf_port = ready.get(timeout=10.0)
    clients = threading.Thread(
        target=P.drive_sim_clients, args=("127.0.0.1", leaf_port, cids, TEMPLATE),
        kwargs={"threads": 4, "timeout": TIMEOUT}, daemon=True)
    clients.start()
    try:
        digest, _ = P.run_root_campaign(root, {0: cids}, TEMPLATE, 2)
        clients.join(timeout=30.0)
        leaf_thread.join(timeout=30.0)
        assert not clients.is_alive() and not leaf_thread.is_alive()
        assert proxy.frames_corrupted >= 1
        assert digest == P.run_flat_campaign(TEMPLATE, cids, 2)[0]
    finally:
        proxy.close()
        root_t.close()


# --------------------------- quorum rounds -----------------------------------


def test_leaf_quorum_closes_degraded_and_renormalizes():
    """2 of 8 clients never appear: the port leaf's round closes DEGRADED
    at the policy deadline with the 6 survivors, and the mean is the
    straggler-drop reference's bit for bit."""
    cids = list(range(8))
    live = cids[:6]
    root_t = SocketServerTransport("127.0.0.1", 0)
    policy = RoundPolicy(deadline_s=0.5, quorum_frac=0.75)
    root = P.RootAggregator(root_t, round_timeout=TIMEOUT)
    ready = queue.Queue()
    leaf_thread = threading.Thread(target=P.run_leaf, args=(0, root_t.host, root_t.port),
                                   kwargs={"ready_queue": ready, "policy": policy}, daemon=True)
    leaf_thread.start()
    _lid, leaf_port = ready.get(timeout=10.0)
    clients = threading.Thread(
        target=P.drive_sim_clients, args=("127.0.0.1", leaf_port, live, TEMPLATE),
        kwargs={"threads": 3, "timeout": TIMEOUT}, daemon=True)
    clients.start()
    try:
        digest, _ = P.run_root_campaign(root, {0: cids}, TEMPLATE, 1, allow_partial=True)
        clients.join(timeout=30.0)
        leaf_thread.join(timeout=30.0)
        assert not clients.is_alive() and not leaf_thread.is_alive()
    finally:
        root_t.close()
    ref = P.ExactAccumulator()
    for c in live:
        ref.fold(P.synth_delta(TEMPLATE, 0, c), P.sim_weight(c))
    expect = P.params_digest(P.tree_add(P._zeros_like_f32(TEMPLATE), ref.finalize_mean()))
    assert digest == expect
    ref_acc = R.ExactAccumulator()
    for c in live:
        ref_acc.fold(R.synth_delta(TEMPLATE, 0, c), R.sim_weight(c))
    assert digest == R.params_digest(R.tree_add(R._zeros_like_f32(TEMPLATE),
                                                ref_acc.finalize_mean()))
