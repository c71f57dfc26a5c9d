"""What the trainer's control-plane mirror costs a round (on the card).

``FederatedTrainer``'s default engine mirrors every simulated SPAWN,
COMPLETE and FAIL through an in-process ``FLServer`` (``mirror=True``, as
the reference's trainer does): four request/reply round trips a client a
round, on the host, inside SIMULATE.  This runs ``chip_smoke.py`` phase 3's
world (128 FEMNIST-MLP clients, 32 a round, ragged waves) and phase 23's
first world (64 CIFAR-10 CNN clients, 16 a round, dense waves) for 3 rounds
each, on fresh trainers in the order mirror on, off, off, on, and prints
each round's wall by phase (the card synchronized after each phase) and the
monitor's log length.  The mirror is turned off by dropping it from the
trainer's engine (``engine.mirror = None``); nothing else differs.

    PYTHONPATH=src python tools/torch_mirror_cost.py

The last line of its output is one JSON object with every reading.
"""
from __future__ import annotations

import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 3
ORDER = (True, False, False, True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_mirror_cost: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.fed.trainer import FedConfig, FederatedTrainer
    from repro_torch.models.small import SmallModelConfig

    card = cs.smi_line()
    print(f"card: {card}", flush=True)
    name, fields, dataset, opt_name, lr = cs.CLIENT_MODELS[0]
    worlds = {
        "phase 3 (mlp, 32 a round)": (
            SmallModelConfig(kind="mlp", n_classes=62, hidden=128, n_layers=2,
                             image_size=28, channels=1),
            lambda mcfg: cs.build_world(mcfg),
            FedConfig(rounds=ROUNDS, participants_per_round=32, max_parallel=32,
                      local_steps=10, client_batching="wave")),
        f"phase 23 ({name}, {cs.CLIENTS_PARTICIPANTS} a round)": (
            SmallModelConfig(**fields),
            lambda mcfg: cs.client_world(mcfg, dataset),
            FedConfig(rounds=ROUNDS, participants_per_round=cs.CLIENTS_PARTICIPANTS,
                      max_parallel=cs.CLIENTS_PARTICIPANTS, local_steps=cs.CLIENTS_STEPS,
                      client_batching="wave", optimizer=opt_name, learning_rate=lr)),
    }
    out = {"card": card, "worlds": {}}
    for label, (mcfg, make, fed) in worlds.items():
        runs = []
        for mirror in ORDER:
            clients, test = make(mcfg)
            trainer = FederatedTrainer(mcfg, clients, fed, test_batch=test)
            if not mirror:
                trainer.engine.mirror = None
            rounds = cs.run_rounds(torch, trainer, fed.rounds)
            walls = [r["walls"] for r in rounds]
            server = trainer.engine.server if mirror else None
            log = len(server.monitor.log) if server is not None else 0
            runs.append({"mirror": mirror, "walls": walls, "monitor_log": log})
            print(f"{label}, mirror {mirror}: monitor log {log} entries", flush=True)
            for i, w in enumerate(walls, 1):
                print(f"  round {i} phase wall s: "
                      + ", ".join(f"{k} {v:.6f}" for k, v in w.items()), flush=True)
        summary = {}
        for mirror in (True, False):
            later = [w for r in runs if r["mirror"] is mirror for w in r["walls"][1:]]
            summary["on" if mirror else "off"] = {
                "simulate_s_median": statistics.median(w["simulate"] for w in later),
                "round_s_median": statistics.median(sum(w.values()) for w in later),
            }
        print(f"{label}: rounds 2-{ROUNDS}, median SIMULATE s on "
              f"{summary['on']['simulate_s_median']:.6f}, off "
              f"{summary['off']['simulate_s_median']:.6f}; median round s on "
              f"{summary['on']['round_s_median']:.6f}, off "
              f"{summary['off']['round_s_median']:.6f}", flush=True)
        out["worlds"][label] = {"runs": runs, "summary": summary}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
