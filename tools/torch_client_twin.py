"""Where a client model's card-against-CPU wave gap comes from (on the card).

``chip_smoke.py`` phase 23 holds 4 clients of each client model's wave on
the card against the same wave on the CPU, within its ``TWIN_REL_TOL``.
This reads the gap of one model (default: the residual CNN at FEMNIST
widths, hidden 128) from the same seeded parameters and data under each
optimizer, at 1, 3 and 10 local steps, with the three leaves that differ
most; and, at 10 steps under the first optimizer, the same with cuDNN off
on the card.  adam's first update is lr * sign(g) elementwise, so where a
gradient element is rounding noise the two devices move it by up to
2 lr; momentum and sgd move it by lr * g.

    PYTHONPATH=src python tools/torch_client_twin.py [--model resnet]

``--wave`` reads phase 23's own twin instead (default model: the CNN with
the local tower): the model's two rounds through the trainer, run twice
with cuDNN free and twice restricted to deterministic algorithms, say
whether round 2's wave and globals come out the same; the same wave from
the same globals twice on the card says whether cuDNN alone changes the
bits, and the wave's deltas summed in two orders whether the aggregation
order does.  Then every client of round 2's wave is held card against
CPU from round 2's globals after 1 to 10 local steps, each with its
three worst leaves and its leaves' delta norms.  With ``--f64`` each
step count also runs the wave on the CPU in float64 (params and batches
widened) and reads every client's CPU-f32 and card gaps against it: the
share of the card-against-CPU gap that f32 rounding alone accounts for,
and the card's wave with cuDNN off against it.

    PYTHONPATH=src python tools/torch_client_twin.py --wave [--f64] [--model "cnn + local model"]

The last line of its output is one JSON object with every reading.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_client_twin: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.models.small import SmallModelConfig, init_small
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.tree import tree_flatten_with_path

    models = {name: (fields, dataset) for name, fields, dataset, _, _ in cs.CLIENT_MODELS}
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default=None, choices=sorted(models))
    ap.add_argument("--wave", action="store_true",
                    help="phase 23's round-2 twin: run-to-run drift and every client of the wave")
    ap.add_argument("--f64", action="store_true",
                    help="with --wave: every step count also against a float64 CPU run")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.smi_line()
    print(f"card: {card}", flush=True)
    if args.wave:
        return wave_study(torch, cs, args.model or "cnn + local model", card, args.f64)
    args.model = args.model or "resnet"
    fields, dataset = models[args.model]
    mcfg = SmallModelConfig(**fields)
    params = init_small(0, mcfg, device="cpu")
    keys = [k for k, _ in tree_flatten_with_path(params)]
    cids = list(range(cs.TWIN_CLIENTS))

    def worst_leaves(got, want):
        rel = [(max(float((g[j] - w[j]).norm() / w[j].norm()) for g, w in zip(got, want)), k)
               for j, k in enumerate(keys)]
        return sorted(rel, reverse=True)[:3]

    readings = []
    for opt_name, lr in (("adamw", 1e-3), ("momentum", 0.05), ("sgd", 0.05)):
        opt = make_optimizer(opt_name, lr)
        for steps in (1, 3, 10):
            cs.CLIENTS_STEPS = steps
            want = cs.kind_wave(torch, mcfg, dataset, opt, cids, params, "cpu")
            got = cs.kind_wave(torch, mcfg, dataset, opt, cids, params, "cuda")
            row = {"optimizer": opt_name, "lr": lr, "steps": steps, "cudnn": True,
                   "gap": cs.wave_gap(got, want), "worst_leaves": worst_leaves(got, want)}
            readings.append(row)
            print(json.dumps(row), flush=True)
            if steps == 10 and opt_name == "adamw":
                torch.backends.cudnn.enabled = False
                got = cs.kind_wave(torch, mcfg, dataset, opt, cids, params, "cuda")
                torch.backends.cudnn.enabled = True
                row = dict(row, cudnn=False, gap=cs.wave_gap(got, want),
                           worst_leaves=worst_leaves(got, want))
                readings.append(row)
                print(json.dumps(row), flush=True)
    print(json.dumps({"card": card, "model": args.model, "clients": len(cids),
                      "limit": cs.TWIN_REL_TOL, "readings": readings}))
    return 0


def wave64(torch, cs, mcfg, dataset, opt, cids, params):
    """``cs.kind_wave`` on the CPU in float64: the params and every float
    batch widened before the wave (the deltas come back as float32)."""
    from unittest import mock

    from repro_torch.fed import batch_exec
    from repro_torch.tree import tree_map

    real = batch_exec.host_to

    def wide(arr, device):
        t = real(arr, device)
        return t.double() if t.is_floating_point() else t

    with mock.patch.object(batch_exec, "host_to", wide):
        return cs.kind_wave(torch, mcfg, dataset, opt, cids,
                            tree_map(lambda t: t.double().cpu(), params), "cpu")


def wave_study(torch, cs, model, card, f64=False):
    """Phase 23's twin of ``model`` taken apart (see the module docstring)."""
    import contextlib

    from repro_torch.tree import tree_flatten_with_path, tree_leaves

    _, fields, dataset, opt_name, lr = next(m for m in cs.CLIENT_MODELS if m[0] == model)
    out = {"card": card, "model": model, "limit": cs.TWIN_REL_TOL}

    def two_rounds(deterministic):
        mcfg, trainer, rounds, _ = cs.client_rounds(torch, fields, dataset, opt_name, lr,
                                                    deterministic=deterministic)
        return mcfg, trainer, rounds

    def cudnn(deterministic):
        return cs.cudnn_deterministic(torch) if deterministic else contextlib.nullcontext()

    drift = {}
    for det in (False, True):
        runs = [two_rounds(det) for _ in range(2)]
        (mcfg, trainer, r1), (_, _, r2) = runs
        starts = [tree_leaves(r[1]["start"]) for r in (r1, r2)]
        row = {"round1_finishers": [r1[0]["cids"], r2[0]["cids"]],
               "round2_finishers": [r1[1]["cids"], r2[1]["cids"]],
               "round1_same_set": sorted(r1[0]["cids"]) == sorted(r2[0]["cids"]),
               "round1_same_order": r1[0]["cids"] == r2[0]["cids"],
               "round2_globals_bit_equal": cs.same_bits(torch, *starts),
               "round2_globals_max_abs": max(float((a - b).abs().max())
                                             for a, b in zip(*starts))}
        # the same wave from the same globals twice on the card
        cids = cs.twin_clients(r1[1]["cids"])
        with cudnn(det):
            waves = [cs.kind_wave(torch, mcfg, dataset, trainer.opt, cids, r1[1]["start"], "cuda")
                     for _ in range(2)]
        row["same_wave_twice_bit_equal"] = all(cs.same_bits(torch, a, b) for a, b in zip(*waves))
        row["same_wave_twice_gap"] = cs.wave_gap(waves[0], waves[1])
        drift["deterministic" if det else "free"] = row
        print(json.dumps({"cudnn": "deterministic" if det else "free", **row}), flush=True)
    # the aggregation order: the wave's deltas summed forwards and backwards on the card
    leaves = [[t.cuda() for t in c] for c in waves[0]]
    fwd = [sum(c[j] for c in leaves) for j in range(len(leaves[0]))]
    bwd = [sum(c[j] for c in reversed(leaves)) for j in range(len(leaves[0]))]
    drift["sum_order_bit_equal"] = cs.same_bits(torch, fwd, bwd)
    drift["sum_order_max_abs"] = max(float((a - b).abs().max()) for a, b in zip(fwd, bwd))
    print(json.dumps({"sum_order_bit_equal": drift["sum_order_bit_equal"],
                      "sum_order_max_abs": drift["sum_order_max_abs"]}), flush=True)
    out["drift"] = drift

    # every client of round 2's wave (deterministic run), card against CPU, 1..10 steps
    mcfg, trainer, rounds = two_rounds(True)
    start, wave = rounds[1]["start"], sorted(rounds[1]["cids"])
    keys = [k for k, _ in tree_flatten_with_path(start)]
    per_step, steps_saved = {}, cs.CLIENTS_STEPS
    try:
        for steps in range(1, steps_saved + 1):
            cs.CLIENTS_STEPS = steps
            want = cs.kind_wave(torch, mcfg, dataset, trainer.opt, wave, start, "cpu")
            with cudnn(True):
                got = cs.kind_wave(torch, mcfg, dataset, trainer.opt, wave, start, "cuda")
            exact = (wave64(torch, cs, mcfg, dataset, trainer.opt, wave, start) if f64
                     else [None] * len(wave))
            if f64:   # the card without cuDNN (ATen's own convolutions)
                torch.backends.cudnn.enabled = False
                try:
                    plain = cs.kind_wave(torch, mcfg, dataset, trainer.opt, wave, start, "cuda")
                finally:
                    torch.backends.cudnn.enabled = True
            else:
                plain = [None] * len(wave)
            clients = {}
            for cid, g, w, x, n in zip(wave, got, want, exact, plain):
                rel = [(float((a - b).norm() / b.norm()) if float(b.norm()) else 0.0,
                        float(b.norm()), k) for a, b, k in zip(g, w, keys)]
                clients[cid] = {"gap": cs.wave_gap([g], [w]),
                                "worst_leaves": sorted(rel, reverse=True)[:3]}
                if x is not None:   # f32 rounding alone: the CPU's f32 wave against f64
                    clients[cid]["cpu_f32_vs_f64"] = cs.wave_gap([w], [x])
                    clients[cid]["card_vs_f64"] = cs.wave_gap([g], [x])
                    clients[cid]["card_no_cudnn_vs_f64"] = cs.wave_gap([n], [x])
            per_step[steps] = clients
            worst = max(clients.items(), key=lambda kv: kv[1]["gap"][0])
            print(json.dumps({"steps": steps, "worst_client": worst[0], **worst[1],
                              "over_limit": [c for c, v in clients.items()
                                             if v["gap"][0] >= cs.TWIN_REL_TOL]}), flush=True)
    finally:
        cs.CLIENTS_STEPS = steps_saved
    out["wave"] = wave
    out["twin_clients"] = cs.twin_clients(rounds[1]["cids"])
    out["per_step"] = per_step
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
