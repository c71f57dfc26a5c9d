"""The port's control plane against the reference's: one scripted message
sequence drives both ``FLServer``s to the same ``StatusMonitor`` log, state,
session statistics, dedup verdicts and instructions; both packages' round
journals are byte-identical files that recover in the other package (torn
tails too); and the flat server's crash-restart replay of
tests/test_faults.py runs in the port."""
import numpy as np
import pytest

from repro.fed import server as ref_server
from repro.fed import transport as ref_transport
from repro.fed import wal as ref_wal
from repro.obs import ObsPlane as RefObsPlane
from repro_torch.fed import server as port_server
from repro_torch.fed import transport as port_transport
from repro_torch.fed import wal as port_wal
from repro_torch.obs import ObsPlane

PKGS = {"ref": (ref_server, ref_transport, ref_wal, RefObsPlane),
        "port": (port_server, port_transport, port_wal, ObsPlane)}


def _upload(cid, rnd):
    """tests/test_faults.py's sample upload."""
    return {"delta": {"w": np.full((3, 4), float(cid), np.float32)},
            "n": 10 + cid, "round": rnd}


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.shape, x.tobytes())
    if hasattr(x, "value") and type(x).__name__ == "MsgType":
        return x.value
    return x


#: (kind, client, payload) — a whole round and its faults: registrations
#: under session tokens, a parked READY outside the participants, the
#: normal TRAIN → UPLOAD path, a duplicate upload, a restart under a new
#: token, a protocol violation, a heartbeat, an ABORT and a PARTIAL_SUM
SCRIPT = [
    ("register", 1, {"session": "a"}), ("register", 2, {"session": "b"}),
    ("register", 9, {"session": "z"}),
    ("ready", 1, {}), ("ready", 2, {"local_steps": 3}), ("ready", 9, {}),
    ("train_done", 1, {}), ("upload", 1, _upload(1, 0)),
    ("upload", 1, _upload(1, 0)),                         # duplicate: dropped
    ("ready", 1, {}),                                     # uploaded: parked
    ("heartbeat", 2, {}), ("send_update", 2, {}),         # violation
    ("register", 2, {"session": "b2"}),                   # restart
    ("ready", 2, {}), ("train_done", 2, {}), ("upload", 2, _upload(2, 0)),
    ("register", 3, {"session": "c"}), ("ready", 3, {}), ("abort", 3, {}),
    ("register", 4, {"session": "d"}), ("ready", 4, {}),
    ("partial_sum", 4, {"round": 0, "count": 2, "delta": {"w": np.ones(2, np.float32)}}),
    ("upload", 5, _upload(5, 0)),                         # never registered
]


def _drive(name, serializing):
    srv_mod, tr_mod, _, obs_cls = PKGS[name]
    obs = obs_cls()
    t = tr_mod.SerializingTransport(obs=obs) if serializing else tr_mod.LocalTransport()
    srv = srv_mod.FLServer(t, obs=obs)
    srv.participants = {1, 2, 3, 4}
    srv.train_payload = {"round": 0, "params": {"w": np.arange(6, dtype=np.float32)}}
    out = []
    for kind, cid, payload in SCRIPT:
        t.send_to_server(tr_mod.Message(tr_mod.MsgType(kind), cid, payload))
        n = srv.step()
        inst = t.poll_client(cid)
        out.append((n, inst.kind.value, inst.client_id, _plain(inst.payload)))
    srv.broadcast_shutdown()
    shutdown = sorted((m.client_id, m.payload["reason"])
                      for cid in srv.monitor.state for m in [t.poll_client(cid)])
    rows = {cid: [o.kind.value for o in srv.record_table[row]]
            for cid, row in srv._row_of.items()}
    return {
        "instructions": out, "shutdown": shutdown, "rows": rows,
        "log": [(c, k.value, st) for c, k, st in srv.monitor.log],
        "state": dict(srv.monitor.state), "uploads": _plain(srv.uploads),
        "sessions": (dict(srv.sessions.session_of), _plain(srv.sessions.uploaded_rounds),
                     srv.sessions.restarts, srv.sessions.duplicate_uploads_dropped),
        "counters": obs.registry.counters_snapshot(),
        "wire": (getattr(t, "wire_bytes", None), getattr(t, "payload_bytes", None)),
    }


@pytest.mark.parametrize("serializing", [False, True], ids=["local", "serializing"])
def test_scripted_sequence_drives_both_servers_alike(serializing):
    r, p = _drive("ref", serializing), _drive("port", serializing)
    for key in r:
        assert p[key] == r[key], key
    assert r["sessions"][2:] == (1, 1)                    # one restart, one dup
    assert r["state"][3] == "failed" and r["state"][4] == "done"


def test_session_sweeps_and_round_policy_match():
    outs = []
    for srv_mod, tr_mod, _, obs_cls in PKGS.values():
        now = [0.0]
        obs = obs_cls()
        tr = srv_mod.SessionTracker(ttl=5.0, clock=lambda: now[0], obs=obs,
                                    heartbeat_interval=1.0, missed_beats=2)
        seen = []
        for t, cid in ((0.0, 1), (0.5, 2), (1.0, 3), (2.6, 2), (3.0, 4), (7.0, 4)):
            now[0] = t
            tr.note_register(cid, f"s{cid}")
            seen.append((sorted(tr.live_clients()), sorted(tr.session_of)))
        tr.uploaded_rounds = {1: {0, 1, 2, "x"}}
        tr.prune_rounds(2)
        pol = srv_mod.RoundPolicy(deadline_s=1.0, quorum_frac=0.75, min_clients=2)
        verdicts = [pol.may_close(n, 8, e) for n in range(9) for e in (0.5, 1.5)]
        outs.append((seen, tr.sessions_dead, tr.sessions_evicted, tr.uploaded_rounds,
                     pol.quorum(8), verdicts, obs.registry.counters_snapshot()))
    assert outs[0] == outs[1]
    assert outs[1][1] > 0


def _journal(name, path, torn=False):
    _, tr_mod, wal_mod, obs_cls = PKGS[name]
    obs = obs_cls()
    with wal_mod.RoundJournal(path, obs=obs) as j:
        j.open_round(0, digest="abc")
        j.upload(1, _upload(1, 0))
        j.upload(2, _upload(2, 0))
        j.checkpoint(2, {"round": 0, "count": 2, "sum": {"w": np.ones(3, np.float64)}})
        j.close_round(0, mode="FULL", count=2)
        j.open_round(1, digest="def")
        j.upload(3, _upload(3, 1))
        j.append(tr_mod.MsgType.UPLOAD, 4, {"delta": {"b": np.arange(5, dtype=np.int8)},
                                            "n": 1})
        appends = j.appends
    if torn:   # a SIGKILL mid-append: the last record's tail never landed
        data = path.read_bytes()
        path.write_bytes(data[:-7])
    return appends, obs.registry.counters_snapshot()


def _recovery(wal_mod, path):
    rec = wal_mod.recover(path)
    return {
        "records": rec.records, "torn": rec.torn,
        "uploaded": {c: sorted(r) for c, r in rec.uploaded_rounds.items()},
        "rounds": {r: (w.round, _plain(w.meta), [(c, _plain(p)) for c, p in w.uploads],
                       _plain(w.checkpoint), w.checkpoint_folds, w.closed,
                       _plain(w.close_meta))
                   for r, w in rec.rounds.items()},
        "open": None if rec.open_round is None else rec.open_round.round,
    }


@pytest.mark.parametrize("torn", [False, True], ids=["clean", "torn-tail"])
def test_round_journals_are_byte_identical_and_recover_across(tmp_path, torn):
    paths = {name: tmp_path / f"{name}.wal" for name in PKGS}
    meta = {name: _journal(name, paths[name], torn) for name in PKGS}
    assert meta["port"] == meta["ref"]
    assert paths["port"].read_bytes() == paths["ref"].read_bytes()
    got = {(reader, writer): _recovery(PKGS[reader][2], paths[writer])
           for reader in PKGS for writer in PKGS}
    want = got[("ref", "ref")]
    assert all(v == want for v in got.values())
    assert want["torn"] is torn and want["open"] == 1
    assert want["records"] == (7 if torn else 8)
    # reopening truncates a torn tail alike, and the next append lands clean
    for name, path in paths.items():
        _, tr_mod, wal_mod, _ = PKGS[name]
        with wal_mod.RoundJournal(path) as j:
            j.close_round(1, mode="FULL", count=1)
    assert paths["port"].read_bytes() == paths["ref"].read_bytes()
    assert _recovery(port_wal, paths["ref"])["torn"] is False


def test_mid_journal_corruption_raises_in_both(tmp_path):
    for name, (_, _, wal_mod, _) in PKGS.items():
        path = tmp_path / f"{name}.wal"
        _journal(name, path)
        data = bytearray(path.read_bytes())
        data[12] ^= 0xFF                   # inside the first record's body
        path.write_bytes(bytes(data))
        with pytest.raises(wal_mod.WalError, match="mid-journal corruption"):
            wal_mod.recover(path)


def test_flat_server_restart_replays_wal_no_duplicate_aggregation(tmp_path):
    """tests/test_faults.py's flat-tier durability acceptance, in the port:
    a server killed mid-round restarts, replays the journal, refuses the
    re-upload, and finishes the round with the no-fault run's uploads."""
    FLServer, LocalTransport = port_server.FLServer, port_transport.LocalTransport
    run_client_session = port_server.run_client_session
    path = tmp_path / "flat.wal"
    obs = ObsPlane()

    def serve_round(server, cids):
        server.train_payload = {"round": 0}
        for cid in cids:
            assert run_client_session(server, cid, lambda s, c=cid: {**_upload(c, 0)})

    srv1 = FLServer(LocalTransport(), obs=obs, wal=port_wal.RoundJournal(path, obs=obs))
    srv1.wal.open_round(0)
    serve_round(srv1, [1, 2])
    srv1.wal.close()                       # "SIGKILL": no close_round record

    rec = port_wal.recover(path)
    srv2 = FLServer(LocalTransport(), obs=obs, wal=port_wal.RoundJournal(path, obs=obs))
    assert srv2.restore_from_wal(rec) == 2
    srv2.wal.open_round(0)                 # resume marker
    np.testing.assert_array_equal(srv2.uploads[1]["delta"]["w"],
                                  np.full((3, 4), 1.0, np.float32))
    srv2.train_payload = {"round": 0}
    run_client_session(srv2, 1, lambda s: _upload(1, 0))
    assert srv2.sessions.duplicate_uploads_dropped == 1
    serve_round(srv2, [3, 4])
    assert sorted(srv2.uploads) == [1, 2, 3, 4]

    ref = FLServer(LocalTransport())
    ref.train_payload = {"round": 0}
    for cid in (1, 2, 3, 4):
        run_client_session(ref, cid, lambda s, c=cid: _upload(c, 0))
    for cid in ref.uploads:
        np.testing.assert_array_equal(srv2.uploads[cid]["delta"]["w"],
                                      ref.uploads[cid]["delta"]["w"])
    final = port_wal.recover(path)
    snap = obs.registry.counters_snapshot()
    assert sum(snap["fault.wal_appends"].values()) == final.records == 6
    pairs = [(c, p.get("round")) for r in final.rounds.values() for c, p in r.uploads]
    assert len(pairs) == len(set(pairs)) == 4
    # and the reference recovers the port's journal to the same state
    ref_rec = ref_wal.recover(path)
    assert ref_rec.records == final.records
    assert {c: sorted(r) for c, r in ref_rec.uploaded_rounds.items()} == \
        {c: sorted(r) for c, r in final.uploaded_rounds.items()}
