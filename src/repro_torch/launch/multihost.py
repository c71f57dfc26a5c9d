"""repro_torch.launch.multihost — run a federated campaign over real connections.

The port of ``repro.launch.multihost``: the ``FLServer`` control plane and N client *worker processes* speaking the Fig-4 protocol
over ``repro_torch.fed.net``'s socket transport, wired into
``FederatedTrainer`` so each global round's local training happens in the
workers and the deltas come back over the wire (with ``wire_bytes``
accounted in the round records).

Roles, one protocol:

* ``--role local``  — spawn the server *and* N workers on this machine
  (``multiprocessing`` spawn context, loopback TCP) and run the campaign;
* ``--role server`` — run only the server side, listening on
  ``--host/--port`` for remote workers;
* ``--role worker`` — run one client worker (``--client-id``) against a
  remote server at ``--host/--port``;
* ``--role aggregator`` — run one leaf aggregator of the hierarchical tree
  (``--leaf-id``): serve a pod of clients on ``--host/--port`` and ship one
  ``PARTIAL_SUM`` a round to the root at ``--root-host/--root-port``
  (``repro_torch.fed.hier``).

Every process rebuilds the same deterministic world from the shared
:class:`WorldSpec` (model config, budgets, Dirichlet data partition), so a
worker owns exactly its data shard and nothing else travels out-of-band —
the only channel between processes is the wire protocol itself.  Payloads
are numpy at the seams: the TRAIN params leave the trainer as numpy, a
worker moves them onto its device, trains, compresses on the device where
the round asks, and uploads numpy (or the compressed wire tree).  The
inline run hands its workers the same numpy objects, so inline and socket
runs train from identical inputs.

Every entry point takes ``device``: ``None`` is the CUDA card (each process
resolves it, and raises without one), ``"cpu"`` the host.  Worker processes
start under the ``spawn`` context, never ``fork``: the parent may hold a
CUDA context, which a forked child cannot use.

The timing authority stays on the server: the campaign engine simulates
the round (scheduling, rates, failures) exactly as in-process training
does; what moves to the workers is the *actual* local training.  With the
deterministic :class:`repro_torch.core.runtime.FixedRuntime` the simulated
timeline — and therefore the aggregation order and the resulting params —
is bit-identical between a ``LocalTransport`` run and a socket run.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.core.budget import uniform_budgets
from repro_torch.core.runtime import FixedRuntime
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fed.client import make_small_step
from repro_torch.fed.compression import compress_tree
from repro_torch.fed.server import (FLServer, LocalTransport, Message, MsgType,
                                    RoundPolicy)
from repro_torch.fed.trainer import FedConfig, FederatedTrainer, build_fl_clients
from repro_torch.models.small import SmallModelConfig
from repro_torch.obs.metrics import Counter
from repro_torch.optim.optimizers import make_optimizer

# heterogeneous budget template (the paper's Fig 13 client mix), cycled
# over however many clients the world asks for
_BUDGET_CYCLE = (10.0, 15.0, 30.0, 80.0, 65.0, 40.0, 50.0, 100.0)


@dataclass(frozen=True)
class WorldSpec:
    """Everything needed to rebuild the same federated world anywhere.

    Picklable and cheap: the server and every worker construct identical
    model configs, budgets and data shards from it (same seeds), so no
    tensors need to be shipped at startup.  The reference's fields,
    unchanged.
    """

    n_clients: int = 8
    rounds: int = 3
    participants_per_round: int = 8
    local_steps: int = 2
    seed: int = 0
    batch_size: int = 8
    n_samples: int = 640
    hidden: int = 16
    scheduler: str = "fedhc"
    max_parallel: int = 8
    host: str = "127.0.0.1"
    port: int = 0
    #: uplink delta compression (none | int8 | topk) — applied at the
    #: worker, transmitted as native wire types (codec v2)
    compression: str = "none"
    #: force a wire protocol version (None = FEDHC_WIRE_VERSION env /
    #: build default); both the server and every worker honor it
    wire_version: Optional[int] = None
    #: hierarchical deployment: number of leaf aggregator pods between the
    #: clients and the root (0 = flat)
    n_leaves: int = 0
    #: where leaf aggregators find the root when ``n_leaves > 0``
    root_host: str = "127.0.0.1"
    root_port: int = 0


def build_world(spec: WorldSpec):
    """(mcfg, clients, test_batch, fed) — identical on every host."""
    mcfg = SmallModelConfig(
        kind="mlp", n_classes=10, hidden=spec.hidden, n_layers=2,
        image_size=28, channels=1,
    )
    budgets = uniform_budgets(
        [_BUDGET_CYCLE[i % len(_BUDGET_CYCLE)] for i in range(spec.n_clients)]
    )
    clients, test = build_fl_clients(
        mcfg, budgets, "femnist",
        n_samples=spec.n_samples, batch_size=spec.batch_size,
        n_batches=2, seed=spec.seed,
    )
    for c in clients:
        c.data.y = c.data.y % 10
    test["y"] = test["y"] % 10
    fed = FedConfig(
        rounds=spec.rounds,
        participants_per_round=spec.participants_per_round,
        local_steps=spec.local_steps,
        scheduler=spec.scheduler,
        max_parallel=spec.max_parallel,
        compression=spec.compression,
        seed=spec.seed,
    )
    return mcfg, clients, test, fed


# --------------------------------------------------------------------------
# Client worker: the protocol loop that runs next to the data
# --------------------------------------------------------------------------


class ClientWorker:
    """Drives one client through REGISTER → READY → TRAIN → UPLOAD rounds
    over any :class:`repro_torch.fed.transport.Transport`.

    A plain ``TERMINATE`` ends the *round* (the worker re-registers for the
    next one); ``TERMINATE {"reason": "shutdown"}`` ends the worker.  The
    same object serves both deployment shapes: ``run()`` is the blocking
    loop a worker process lives in, ``pump()`` processes at most one
    instruction for in-process cooperative driving.  ``device`` is where
    the worker trains (``None``: the card).
    """

    def __init__(self, transport, client, step_fn, opt, *,
                 session: Optional[str] = None, poll_sleep: float = 0.0,
                 device: DeviceLike = None):
        self.t = transport
        self.client = client
        self.cid = client.client_id
        self.step_fn = step_fn
        self.opt = opt
        self.device = resolve_device(device)
        self.session = session or f"worker-{self.cid}"
        self.poll_sleep = poll_sleep
        self.done = False
        self.rounds_trained = 0
        self.train_seconds = 0.0
        self._upload: Optional[Dict[str, Any]] = None

    def _stats_blob(self, train_s: float) -> Dict[str, Any]:
        """Compact wire-telemetry piggyback for the upload envelope: local
        step time plus the transport's own counters as this worker sees
        them.  Advisory only — the server stores it per session
        (``session_stats()['peer']``), never acts on it."""
        t = self.t
        return {
            "train_s": round(float(train_s), 6),
            "train_s_total": round(float(self.train_seconds), 6),
            "rounds_trained": int(self.rounds_trained),
            "wire_bytes": int(getattr(t, "wire_bytes", 0)),
            "reconnects": int(getattr(t, "reconnects", 0)),
            "retransmits": int(getattr(t, "duplicates_dropped", 0)),
        }

    # -- protocol ----------------------------------------------------------

    def start_round(self) -> None:
        self.t.send_to_server(Message(
            MsgType.REGISTER, self.cid, {"session": self.session}
        ))

    def _ready(self) -> None:
        self.t.send_to_server(Message(MsgType.READY, self.cid))

    def _train(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """One TRAIN: numpy params onto the device, local steps, and the
        upload payload — the delta as numpy, or compressed at the source
        (int8 + scale / topk pairs are native wire types) with the seed of
        the trainer's in-process path, so both dequantize to identical
        bits."""
        params = params_from_numpy(payload["params"], self.device)
        t0 = time.time()
        delta, n_seen, metrics = self.client.train_local(
            params, self.step_fn, self.opt, n_steps=int(payload["local_steps"]),
        )
        train_s = time.time() - t0     # the metrics' floats waited for the device
        self.train_seconds += train_s
        self.rounds_trained += 1
        rnd = payload.get("round")
        method = payload.get("compression", "none")
        if method != "none":
            delta = compress_tree(delta, method, seed=int(rnd or 0) * 1000 + self.cid)
        else:
            delta = params_to_numpy(delta)
        return {
            "delta": delta,
            "n": int(n_seen),
            "metrics": metrics,
            "round": rnd,
            # wire-level telemetry piggyback: rides the upload envelope,
            # lands in SocketServerTransport.session_stats()["peer"]
            "stats": self._stats_blob(train_s),
        }

    def handle(self, inst: Message) -> bool:
        """Process one instruction; returns False on shutdown."""
        if inst.kind is MsgType.WAIT:
            # registered, or polled while not selected: (re)announce READY
            if self.poll_sleep and inst.payload.get("reason") == "not_selected":
                time.sleep(self.poll_sleep)
            self._ready()
        elif inst.kind is MsgType.TRAIN:
            self._upload = self._train(inst.payload)
            self.t.send_to_server(Message(MsgType.TRAIN_DONE, self.cid))
        elif inst.kind is MsgType.SEND_UPDATE:
            self.t.send_to_server(Message(
                MsgType.UPLOAD, self.cid, self._upload or {}
            ))
        elif inst.kind is MsgType.TERMINATE:
            if inst.payload.get("reason") == "shutdown":
                self.done = True
                return False
            self._upload = None
            self.start_round()          # round over: rejoin for the next one
        return True

    # -- drivers -----------------------------------------------------------

    def pump(self) -> bool:
        """In-process mode: handle at most one pending instruction."""
        inst = self.t.poll_client(self.cid)
        if inst is None:
            return False
        return self.handle(inst)

    def run(self) -> None:
        """Worker-process mode: block on the wire until shutdown."""
        self.start_round()
        while not self.done:
            inst = self.t.poll_client(self.cid)
            if inst is None:
                continue
            if not self.handle(inst):
                return


# --------------------------------------------------------------------------
# Control-plane dispatcher: the trainer's remote-training seam
# --------------------------------------------------------------------------


class ControlPlaneDispatcher:
    """Trains a round's finishers through the FLServer control plane.

    ``train_round(cids, params, local_steps, rnd)`` installs the round's
    participant set and TRAIN payload (global params travel in the TRAIN
    instruction, as numpy), then drives ``server.step()`` until every
    finisher's ``UPLOAD`` has landed, and returns ``(delta, n, metrics)``
    tuples *in the requested order* — so the caller's aggregation order is
    independent of wire arrival order.  Works over any transport: pass
    ``inline_workers`` to co-drive in-process workers (LocalTransport), or
    none when real worker processes poll over sockets.
    """

    def __init__(self, server: FLServer, *, inline_workers: Sequence[ClientWorker] = (),
                 timeout: float = 120.0, poll_interval: float = 0.002,
                 policy: Optional[RoundPolicy] = None, obs=None):
        self.server = server
        self.inline_workers = list(inline_workers)
        self.timeout = timeout
        self.poll_interval = poll_interval
        #: Optional quorum policy: lets a round close DEGRADED at the
        #: policy deadline with a quorum-satisfying subset instead of
        #: raising at ``timeout`` — the trainer reads the verdict from
        #: :attr:`last_round_report` and drops the stragglers' finisher
        #: slots (weight renormalization over the survivors).
        self.policy = policy
        self.last_round_report: Dict[str, Any] = {
            "mode": "FULL", "reported": [], "stragglers": []}
        self._m_round_closed = (obs.registry.counter("fault.round_closed_aborts", "control")
                                if obs is not None else Counter())

    def train_round(self, cids: List[int], params, local_steps: int,
                    rnd: int, *, compression: str = "none",
                    ) -> List[Tuple[Any, float, Dict[str, float]]]:
        srv = self.server
        srv.sessions.prune_rounds(int(rnd))   # closed rounds: free dedup tags
        for cid in cids:
            srv.uploads.pop(cid, None)
        srv.train_payload = {
            "params": params, "local_steps": int(local_steps), "round": int(rnd),
            "compression": str(compression),
        }
        srv.participants = set(cids)
        need = set(cids)
        start = time.monotonic()
        deadline = start + self.timeout
        mode = "FULL"
        stragglers: List[int] = []
        try:
            while True:
                missing = need - set(srv.uploads)
                if not missing:
                    break
                progressed = srv.step() > 0
                for w in self.inline_workers:
                    progressed = w.pump() or progressed
                if self.policy is not None and self.policy.may_close(
                        len(need) - len(missing), len(need),
                        time.monotonic() - start):
                    mode = "DEGRADED"
                    stragglers = sorted(missing)
                    break
                if not progressed and not self.inline_workers:
                    time.sleep(self.poll_interval)
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"round {rnd}: no upload from clients "
                        f"{sorted(missing)} within {self.timeout}s"
                    )
        finally:
            # between rounds every READY parks: nobody may receive a TRAIN
            # carrying a stale round's payload
            srv.participants = set()
            srv.train_payload = {}
        for cid in stragglers:
            self._m_round_closed.inc()
            try:
                srv.transport.send_to_client(Message(
                    MsgType.TERMINATE, cid,
                    {"reason": "round_closed", "round": int(rnd)}))
            except Exception:
                pass  # a straggler may have no live session to abort
        reported = [c for c in cids if c in srv.uploads]
        self.last_round_report = {
            "mode": mode, "reported": reported, "stragglers": stragglers}
        out = []
        for cid in reported:
            up = srv.uploads[cid]
            got = up.get("round")
            if got is not None and int(got) != int(rnd):
                raise RuntimeError(
                    f"client {cid} uploaded for round {got}, expected {rnd}"
                )
            out.append((up["delta"], float(up["n"]), dict(up.get("metrics", {}))))
        return out

    def wire_stats(self) -> Dict[str, int]:
        """Framed-byte accounting: total bytes the server transport has
        put on / taken off the wire so far (0 over LocalTransport, which
        has no wire), split into tensor payload vs framing/header
        overhead."""
        t = self.server.transport
        return {
            "wire_bytes": int(getattr(t, "wire_bytes", 0)),
            "wire_payload_bytes": int(getattr(t, "payload_bytes", 0)),
            "wire_header_bytes": int(getattr(t, "header_bytes", 0)),
        }

    def shutdown(self) -> None:
        """End-of-campaign teardown: tell every known worker to exit."""
        self.server.broadcast_shutdown()
        for w in self.inline_workers:
            while w.pump():
                pass


# --------------------------------------------------------------------------
# Deployment drivers
# --------------------------------------------------------------------------


def _runtime() -> FixedRuntime:
    # deterministic timing authority: identical simulated timelines (and
    # aggregation order) on every host and across transports
    return FixedRuntime(base=1.0, spread=1.0)


def _worker_step(spec: WorldSpec):
    """(clients, step_fn, opt) of a worker-side world build."""
    mcfg, clients, _test, fed = build_world(spec)
    opt = make_optimizer(fed.optimizer, fed.learning_rate)
    return clients, make_small_step(mcfg, opt, fed.prox_mu), opt


def run_server(spec: WorldSpec, transport, *,
               inline_workers: Sequence[ClientWorker] = (),
               round_timeout: float = 120.0, obs=None,
               policy: Optional[RoundPolicy] = None,
               device: DeviceLike = None) -> FederatedTrainer:
    """Run the full campaign's server side over ``transport``; returns the
    finished trainer (params, history).  Broadcasts shutdown at the end.
    ``obs`` (optional :class:`repro_torch.obs.ObsPlane`) is threaded
    through the control plane, trainer and campaign engine — one plane, one
    trace.  ``policy`` (optional :class:`RoundPolicy`) lets COLLECT close
    DEGRADED at the quorum deadline instead of waiting out every
    straggler."""
    mcfg, clients, test, fed = build_world(spec)
    server = FLServer(transport, obs=obs)
    dispatcher = ControlPlaneDispatcher(
        server, inline_workers=inline_workers, timeout=round_timeout,
        policy=policy, obs=obs,
    )
    trainer = FederatedTrainer(
        mcfg, clients, fed, test_batch=test,
        runtime=_runtime(), dispatcher=dispatcher, obs=obs, device=device,
    )
    trainer.run()
    dispatcher.shutdown()
    return trainer


def run_worker(spec: WorldSpec, client_id: int, host: str, port: int,
               device: DeviceLike = None) -> int:
    """One worker process: build the world, own shard ``client_id``, serve
    rounds until the server says shutdown.  Returns rounds trained."""
    from repro_torch.fed.net import SocketClientTransport, TransportDead

    dev = resolve_device(device)
    clients, step_fn, opt = _worker_step(spec)
    mine = next(c for c in clients if c.client_id == client_id)
    transport = SocketClientTransport(
        host, port, client_id,
        recv_timeout=0.05, reconnect_base=0.05, reconnect_max=1.0,
        max_reconnect_attempts=12,
        protocol_version=spec.wire_version,
    )
    worker = ClientWorker(
        transport, mine, step_fn, opt,
        session=transport.session, poll_sleep=0.02, device=dev,
    )
    try:
        worker.run()
    except TransportDead as e:
        # the server is permanently gone (retry budget exhausted): exit
        # cleanly rather than crash — there is nobody left to ABORT to
        print(f"worker {client_id}: server unreachable, exiting ({e})")
        transport.close()
    except Exception:
        transport.close(send_abort=True)   # dying client: clean ABORT teardown
        raise
    else:
        transport.close()
    return worker.rounds_trained


def _worker_entry(spec: WorldSpec, client_id: int, host: str, port: int,
                  device: DeviceLike = None) -> None:
    """A spawned worker process's target (module-level, so it pickles)."""
    run_worker(spec, client_id, host, port, device)


def run_aggregator(spec: WorldSpec, leaf_id: int, *,
                   host: Optional[str] = None, port: Optional[int] = None,
                   obs=None) -> None:
    """One leaf aggregator process (``--role aggregator``): serve a pod of
    clients on ``host:port`` and speak PARTIAL_SUM up to the root at
    ``spec.root_host:spec.root_port``.  Blocks until the root broadcasts
    shutdown.  The leaf is model-agnostic — it never builds the world and
    holds no tensor on a device; it folds whatever compressed deltas its
    clients upload."""
    from repro_torch.fed.hier import run_leaf

    run_leaf(
        leaf_id, spec.root_host, spec.root_port,
        host=spec.host if host is None else host,
        port=spec.port if port is None else port,
        obs=obs,
    )


def run_local_inline(spec: WorldSpec, device: DeviceLike = None) -> FederatedTrainer:
    """The whole campaign in-process over ``LocalTransport`` — worker
    replicas built exactly like worker processes build theirs, so this is
    the bit-identity reference for the socket deployment."""
    dev = resolve_device(device)
    transport = LocalTransport()
    # the workers' world is a separate build — fresh dataset replicas with
    # the same seeds — exactly as each worker process builds its own
    worker_clients, step_fn, opt = _worker_step(spec)
    workers = [
        ClientWorker(transport, c, step_fn, opt, device=dev) for c in worker_clients
    ]
    for w in workers:
        w.start_round()
    return run_server(spec, transport, inline_workers=workers, device=dev)


def run_multihost(spec: WorldSpec, *, transport=None,
                  connect: Optional[Tuple[str, int]] = None,
                  round_timeout: float = 120.0, obs=None,
                  policy: Optional[RoundPolicy] = None,
                  skip_clients: Sequence[int] = (),
                  device: DeviceLike = None) -> FederatedTrainer:
    """Loopback multi-host: N worker processes (``spawn`` context) + the
    server in this one.

    Pass a pre-built ``SocketServerTransport`` as ``transport`` and a
    ``connect`` (host, port) to interpose something between the workers
    and the server — the fault-injection tests dial the workers into a
    ``ChaosProxy`` this way.  The transport is closed on exit either way.
    Real multi-host uses ``run_server``/``run_worker`` directly, one per
    machine.  ``device`` goes to the server's trainer and to every worker,
    each of which resolves it on its own.

    ``skip_clients`` never launches those worker processes at all — paired
    with a :class:`RoundPolicy` it shows a round closing DEGRADED at
    deadline when some clients simply never report.
    """
    import multiprocessing as mp

    from repro_torch.fed.net import SocketServerTransport

    resolve_device(device)            # no card and no device: raise before spawning
    if transport is None:
        transport = SocketServerTransport(
            spec.host, spec.port, protocol_version=spec.wire_version,
            obs=obs,
        )
    host, port = connect or (transport.host, transport.port)
    skip = {int(c) for c in skip_clients}
    ctx = mp.get_context("spawn")
    procs = [
        ctx.Process(target=_worker_entry, args=(spec, cid, host, port, device),
                    daemon=True)
        for cid in range(spec.n_clients) if cid not in skip
    ]
    try:
        for p in procs:
            p.start()
        trainer = run_server(spec, transport, round_timeout=round_timeout,
                             obs=obs, policy=policy, device=device)
        for p in procs:
            p.join(timeout=30.0)
        return trainer
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
        transport.close()


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


def _spec_from_args(args: argparse.Namespace) -> WorldSpec:
    return WorldSpec(
        n_clients=args.clients,
        rounds=args.rounds,
        participants_per_round=min(args.participants, args.clients),
        local_steps=args.local_steps,
        seed=args.seed,
        host=args.host,
        port=args.port,
        compression=args.compression,
        wire_version=args.wire_version,
        root_host=args.root_host,
        root_port=args.root_port,
    )


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="FedHC multihost launcher: FLServer + N socket workers",
    )
    ap.add_argument("--role", choices=("local", "server", "worker",
                                       "aggregator"),
                    default="local")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--participants", type=int, default=8)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="server listen port (0 = ephemeral; server prints it)")
    ap.add_argument("--client-id", type=int, default=0,
                    help="worker role: which client shard this process owns")
    ap.add_argument("--leaf-id", type=int, default=0,
                    help="aggregator role: this leaf's id in the tree")
    ap.add_argument("--root-host", default="127.0.0.1",
                    help="aggregator role: root aggregator host")
    ap.add_argument("--root-port", type=int, default=0,
                    help="aggregator role: root aggregator port")
    ap.add_argument("--compression", default="none",
                    choices=("none", "int8", "topk"),
                    help="uplink delta compression, applied at the worker")
    ap.add_argument("--wire-version", type=int, default=None,
                    help="force wire protocol version (default: negotiate, "
                         "v2 preferred; FEDHC_WIRE_VERSION env also honored)")
    ap.add_argument("--device", default=None,
                    help="where the trainer and the workers run (default: the "
                         "CUDA card; 'cpu' for the host)")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke run: 4 clients x 2 rounds over loopback sockets")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="write a Perfetto/Chrome trace (wall clock) of the "
                         "server side — engine, trainer and socket events "
                         "on one timeline")
    args = ap.parse_args(argv)

    if args.smoke:
        args.clients, args.rounds, args.participants = 4, 2, 4
    spec = _spec_from_args(args)

    obs = None
    if args.trace:
        from repro_torch.obs import ObsPlane

        obs = ObsPlane(trace=True)

    if args.role == "worker":
        trained = run_worker(spec, args.client_id, args.host, args.port, args.device)
        print(f"worker {args.client_id}: trained {trained} rounds")
        return
    if args.role == "aggregator":
        print(f"leaf {args.leaf_id}: serving clients on "
              f"{spec.host}:{spec.port}, root at "
              f"{spec.root_host}:{spec.root_port}")
        run_aggregator(spec, args.leaf_id, obs=obs)
        print(f"leaf {args.leaf_id}: shutdown")
        return
    if args.role == "server":
        from repro_torch.fed.net import SocketServerTransport

        resolve_device(args.device)
        transport = SocketServerTransport(
            spec.host, spec.port, protocol_version=spec.wire_version,
            obs=obs,
        )
        print(f"server listening on {transport.host}:{transport.port}")
        try:
            trainer = run_server(spec, transport, obs=obs, device=args.device)
        finally:
            transport.close()
    else:
        trainer = run_multihost(spec, obs=obs, device=args.device)
    if obs is not None and args.trace:
        obs.save_trace(args.trace, clock="wall")
        print(f"trace: {len(obs.tracer)} events -> {args.trace}")
    for rec in trainer.history:
        print(
            f"round {rec['round']}: completed={rec['completed']} "
            f"sim_clock={rec['sim_clock']:.2f}s "
            f"test_acc={rec.get('test_acc', float('nan')):.3f} "
            f"wire_bytes={rec.get('wire_bytes', 0)}"
        )
    wire = trainer.history[-1].get("wire_bytes", 0) if trainer.history else 0
    print(f"campaign done: {len(trainer.history)} rounds, "
          f"{wire} bytes on the wire")


if __name__ == "__main__":
    main()
