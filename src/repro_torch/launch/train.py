"""Cross-silo federated LM pretraining — FedHC at pod scale.  The port
of ``repro.launch.train``, with the same flags and printed lines.

Silos (clients) hold disjoint token-stream shards and heterogeneous resource
budgets; each round the FedHC engine (double-pointer scheduler + dynamic
executor manager + sharing) packs silos onto the resource pool and produces
the round clock, while real local training steps run for every scheduled
silo.  Deltas aggregate with weighted FedAvg (optional int8 or top-k uplink
compression); checkpoints are atomic + resumable.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --reduced \\
        --rounds 3 --silos 4 --local-steps 4 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b

It runs on the CUDA card (and raises without one); ``train(cfg, ...,
device="cpu")`` runs it on the CPU.  A resume restores the parameters and
the round index from ``--ckpt-dir``, as the reference's does: the silos'
streams and the sampling RNG start again from their seeds.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.aggregation import apply_deltas, tree_nbytes, tree_sub
from repro_torch.core.budget import fedscale_budget_distribution
from repro_torch.core.runtime import MeasuredRuntime
from repro_torch.core.scheduler import FedHCScheduler
from repro_torch.core.simulator import RoundSimulator, SimClient
from repro_torch.data.pipeline import TokenDataset
from repro_torch.data.synthetic import make_lm_tokens
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fed.compression import compress, compressed_bytes, decompress
from repro_torch.models.registry import make_train_step, model_fns
from repro_torch.tree import tree_leaves, tree_map

#: the wall seconds of a round, by phase, in ``train``'s history
PHASES = ("probe", "simulate", "local", "aggregate", "checkpoint")


def build_silos(n: int, vocab: int, seq: int, batch: int, seed: int = 0) -> List[Dict[str, Any]]:
    budgets = fedscale_budget_distribution(max(n * 3, 30), seed=seed)[:n]
    silos = []
    for i in range(n):
        tokens = make_lm_tokens(200_000, vocab, seed=seed * 100 + i)
        silos.append({
            "id": i,
            "budget": budgets[i].budget,
            "data": TokenDataset(tokens, seq, batch, seed=seed + i),
        })
    return silos


def train_config(arch: str, reduced: bool = False) -> ModelConfig:
    """``--arch``'s config; ``qwen-100m`` is the ~100M-parameter
    pretraining config of the end-to-end example."""
    if arch == "qwen-100m":
        return get_config("qwen1.5-0.5b").replace(
            name="qwen-100m", d_model=512, n_heads=8, n_kv_heads=8, d_ff=1408,
            groups=(), n_layers=8, loss_chunk=64, remat="none",
        )
    return get_config(arch, reduced=reduced)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(
    cfg: ModelConfig,
    *,
    rounds: int = 3,
    silos: int = 4,
    participants: int = 0,
    local_steps: int = 4,
    batch: int = 8,
    seq: int = 128,
    theta: float = 100.0,
    compression: str = "none",
    ckpt_dir: Optional[str] = None,
    device: DeviceLike = None,
    init_params: Any = None,
    log=print,
) -> Dict[str, Any]:
    """The reference's ``main`` on ``device``: ``rounds`` federated rounds of
    ``silos`` silos (``participants`` of them a round, 0 = all), each
    chosen silo ``local_steps`` train steps from the global params, FedAvg of
    the deltas (through ``compression``), a checkpoint a round in
    ``ckpt_dir``.

    ``init_params`` (a tree of numpy arrays or tensors) replaces the init
    drawn from a ``torch.Generator`` seeded 0: a test injects the
    reference's ``PRNGKey(0)`` init, whose bits torch cannot draw.

    Returns the final ``params``, ``start_round`` and a ``history`` of one
    dict a round: ``round`` (1-based), ``loss`` (the last silo's last
    step), ``sim_round_s``, ``sim_clock_s``, ``wall_s``, ``comm_bytes``
    (cumulative uplink bytes) and ``phase_s`` (wall seconds by ``PHASES``;
    ``probe`` is the runtime's timing of the step)."""
    dev = resolve_device(device)
    fns = model_fns(cfg)
    train_step, opt = make_train_step(cfg)

    if init_params is None:
        params, _ = fns.init(torch.Generator(device=dev).manual_seed(0), dev)
    else:
        params = tree_map(lambda a: a.to(dev) if isinstance(a, torch.Tensor)
                          else params_from_numpy(a, dev), init_params)
    n_params = sum(p.numel() for p in tree_leaves(params))
    log(f"arch={cfg.name} params={n_params/1e6:.1f}M silos={silos}")

    world = build_silos(silos, cfg.vocab_size, seq, batch)
    runtime = MeasuredRuntime(dev)
    ckpt = CheckpointManager(ckpt_dir, keep=3) if ckpt_dir else None
    start_round = 0
    if ckpt:
        step0, params = ckpt.restore_latest(params)
        start_round = step0 or 0

    def on_device(b):
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    comm = 0
    clock = 0.0
    n_part = participants or silos
    rng = np.random.default_rng(0)
    history = []
    for rnd in range(start_round, start_round + rounds):
        t0 = time.time()
        walls = {}
        chosen = [world[i] for i in rng.choice(silos, size=n_part, replace=False)]
        # framework-provided runtime → round timing via the FedHC engine
        t = time.perf_counter()
        works = {}
        for s in chosen:
            b = on_device(s["data"].next_batch())
            opt_state = opt.init(params)
            works[s["id"]] = runtime.seconds_at_full(
                (cfg.name, batch, seq),
                lambda p, o, bb: train_step(p, o, bb)[0],
                (params, opt_state, b), n_steps=local_steps,
            )
        del opt_state
        walls["probe"] = time.perf_counter() - t
        t = time.perf_counter()
        sim, _ = RoundSimulator(FedHCScheduler, theta=theta).run(
            [SimClient(s["id"], s["budget"], works[s["id"]]) for s in chosen]
        )
        clock += sim.duration
        walls["simulate"] = time.perf_counter() - t

        # real local training
        walls["local"] = walls["aggregate"] = 0.0
        deltas = []
        last_loss = float("nan")
        for s in chosen:
            t = time.perf_counter()
            local = params
            opt_state = opt.init(local)
            for _ in range(local_steps):
                local, opt_state, metrics = train_step(local, opt_state,
                                                       on_device(s["data"].next_batch()))
            del opt_state
            _sync(dev)
            walls["local"] += time.perf_counter() - t
            t = time.perf_counter()
            delta = tree_sub(local, params)
            del local
            if compression != "none":
                c = compress(delta, compression, seed=rnd)
                comm += compressed_bytes(c)
                delta = params_from_numpy(decompress(c), dev)
            else:
                comm += tree_nbytes(delta)
            deltas.append((delta, float(local_steps * batch)))
            last_loss = float(metrics["loss"])
            walls["aggregate"] += time.perf_counter() - t
        t = time.perf_counter()
        params = apply_deltas(params, deltas)
        del deltas
        _sync(dev)
        walls["aggregate"] += time.perf_counter() - t
        wall = time.time() - t0
        log(
            f"round {rnd+1}: loss={last_loss:.4f} sim_round_s={sim.duration:.2f} "
            f"sim_clock_s={clock:.2f} wall_s={wall:.1f} comm_MB={comm/1e6:.1f}"
        )
        t = time.perf_counter()
        if ckpt:
            ckpt.save(rnd + 1, params, {"sim_clock": clock})
        walls["checkpoint"] = time.perf_counter() - t
        history.append({"round": rnd + 1, "loss": last_loss, "sim_round_s": sim.duration,
                        "sim_clock_s": clock, "wall_s": wall, "comm_bytes": comm,
                        "phase_s": walls})
    log("done.")
    return {"params": params, "start_round": start_round, "history": history}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-host scale)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--silos", type=int, default=4)
    ap.add_argument("--participants", type=int, default=0, help="0 = all silos")
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--theta", type=float, default=100.0)
    ap.add_argument("--compression", default="none", choices=["none", "int8", "topk"])
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args()
    train(train_config(args.arch, args.reduced), rounds=args.rounds, silos=args.silos,
          participants=args.participants, local_steps=args.local_steps, batch=args.batch,
          seq=args.seq, theta=args.theta, compression=args.compression,
          ckpt_dir=args.ckpt_dir)


if __name__ == "__main__":
    main()
