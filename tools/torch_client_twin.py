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

``--decisions CID`` takes one client of that wave (the CNN with the local
tower) apart step by step, in a plain loop of the client's step (its 10
batches of a fresh twin world, the gradient clipped, the trainer's
optimizer): on the card (deterministic cuDNN), on the CPU in float32, on
the CPU in float64 (params and images widened), and on the CPU in float64
with the card's decisions forced, every ReLU's mask and every 2x2
max-pool's argmax of both towers taken from the card's run of the same
step.  For each step it prints each run's gap to the float64 run, how
many decisions the card and the CPU's float32 run take otherwise than
float64, and at step 2 every gradient leaf card against float64, free and
forced.  The loop's card run is also held against the same client in the
whole wave on the card (``kind_wave``).  Then the same for the wave
itself: the client's decisions at every step of the card's wave and of
the CPU's float32 wave (``recorded_wave``: each wave's own vmapped
rounding), counted against float64's, and the float64 loop run again
with each wave's decisions forced, against that wave's client after its
10 steps.

    PYTHONPATH=src python tools/torch_client_twin.py --decisions 58

The last line of its output is one JSON object with every reading.
"""
from __future__ import annotations

import argparse
import json
import math
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
    ap.add_argument("--decisions", type=int, default=None, metavar="CID",
                    help="one client of the round-2 wave, decision by decision")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.smi_line()
    print(f"card: {card}", flush=True)
    if args.decisions is not None:
        return decisions_study(torch, cs, args.model or "cnn + local model", card,
                               args.decisions)
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


def cnn_logits(torch, small, p, x, forced=None, record=None):
    """``small._apply_single`` of the CNN with its decisions exposed: each
    ReLU's mask and each max-pool's argmax (flat within a channel's plane)
    in forward order, appended to ``record``, or taken from the iterator
    ``forced`` in place of the ones this run would take."""
    F = torch.nn.functional

    def relu(z):
        m = next(forced).to(z.device) if forced is not None else z > 0
        if record is not None:
            record.append(m)
        return torch.where(m, z, torch.zeros_like(z))

    def pool(a):
        out, idx = F.max_pool2d(a, 2, 2, return_indices=True)
        if forced is not None:
            idx = next(forced).to(a.device)
            out = a.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
        if record is not None:
            record.append(idx)
        return out

    h = x.permute(0, 3, 1, 2)
    for conv in p["convs"]:
        h = pool(relu(small._conv_nchw(conv, h)))
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = relu(h @ p["fc"]["w"] + p["fc"]["b"])
    return h @ p["head"]["w"] + p["head"]["b"]


def client_steps(torch, cs, mcfg, opt, batches, start, dev, dtype, forced_steps=None):
    """The client's local steps from ``start`` on ``dev`` in ``dtype``, as
    ``repro_torch.fed.client.build_step_fn`` takes them (main CE plus the
    local tower's CE, the gradient clipped to ``CLIP_NORM``, ``opt``'s
    update), through ``cnn_logits``.  Returns (each step's delta leaves,
    each step's decisions, each step's gradient leaves), on the host."""
    from repro_torch.fed.client import CLIP_NORM, batch_to
    from repro_torch.models import small
    from repro_torch.optim.optimizers import clip_by_global_norm
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    params = tree_map(lambda t: t.to(dev, dtype), start)
    base = [t.detach().clone() for t in tree_leaves(params)]
    state = opt.init(params)
    deltas, decisions, grads = [], [], []
    for s, b in enumerate(batches):
        bt = batch_to(b, torch.device(dev))
        x, y = bt["x"].to(dtype), bt["y"]
        live = [t.detach().requires_grad_() for t in tree_leaves(params)]
        p = tree_unflatten(params, live)
        forced = iter(forced_steps[s]) if forced_steps is not None else None
        record = []
        loss = 0.0
        for tower in ("main", "local"):
            logits = cnn_logits(torch, small, p[tower], x, forced, record)
            loss = loss + torch.mean(small.cross_entropy_rows(logits, y))
        g = torch.autograd.grad(loss, live)
        grads.append([t.detach().double().cpu() for t in g])
        decisions.append([r.cpu() for r in record])
        with torch.no_grad():
            gt, _ = clip_by_global_norm(tree_unflatten(params, list(g)), CLIP_NORM)
            params, state = opt.update(gt, state, tree_unflatten(params, [t.detach() for t in live]))
        deltas.append([(a - b0).float().cpu() for a, b0 in zip(tree_leaves(params), base)])
    return deltas, decisions, grads


def recorded_wave(torch, cs, mcfg, dataset, opt, cids, params, dev, cid):
    """``cs.kind_wave`` of the CNN with the local tower, its loss taken
    through ``cnn_logits`` (the values and gradients of
    ``small._apply_single``), with client ``cid``'s decisions at every step
    carried out of ``torch.func.vmap`` as an auxiliary metric.  Returns
    (the wave's deltas as ``kind_wave`` gives them, each step's decisions
    of ``cid`` on the host, in ``client_steps``' order)."""
    from unittest import mock

    from repro_torch.fed import client as fed_client
    from repro_torch.models import small

    at, steps, real_vmap = cids.index(cid), [], torch.func.vmap

    def loss(p, mcfg_, batch):
        record = []
        x, y = batch["x"], batch["y"]
        logits = cnn_logits(torch, small, p["main"], x, record=record)
        ce = torch.mean(small.cross_entropy_rows(logits, y))
        acc = torch.mean((torch.argmax(logits, -1) == y).float())
        local = cnn_logits(torch, small, p["local"], x, record=record)
        total = ce + torch.mean(small.cross_entropy_rows(local, y))
        return total, {"ce": ce, "acc": acc, "decisions": record}

    def vmap(fn, *a, **kw):
        mapped = real_vmap(fn, *a, **kw)

        def run(*args):
            out = mapped(*args)
            if isinstance(out, tuple) and len(out) == 3 and "decisions" in out[2]:
                steps.append([t[at].cpu() for t in out[2].pop("decisions")])
            return out

        return run

    with mock.patch.object(fed_client, "small_loss", loss), \
            mock.patch.object(torch.func, "vmap", vmap):
        deltas = cs.kind_wave(torch, mcfg, dataset, opt, cids, params, dev)
    return deltas, steps


def decisions_study(torch, cs, model, card, cid):
    """One client of phase 23's round-2 wave, decision by decision (see the
    module docstring)."""
    from repro_torch.tree import tree_flatten_with_path

    _, fields, dataset, opt_name, lr = next(m for m in cs.CLIENT_MODELS if m[0] == model)
    mcfg, trainer, rounds, _ = cs.client_rounds(torch, fields, dataset, opt_name, lr,
                                                deterministic=True)
    start, wave = rounds[1]["start"], sorted(rounds[1]["cids"])
    if cid not in wave:
        raise SystemExit(f"client {cid} is not in round 2's wave {wave}")
    keys = [k for k, _ in tree_flatten_with_path(start)]
    clients, _ = cs.client_world(mcfg, dataset)
    batches = list({c.client_id: c for c in clients}[cid].data.batches(cs.CLIENTS_STEPS))
    opt = trainer.opt
    with cs.cudnn_deterministic(torch):
        card_run = client_steps(torch, cs, mcfg, opt, batches, start, "cuda", torch.float32)
        in_wave = cs.kind_wave(torch, mcfg, dataset, opt, wave, start, "cuda")[wave.index(cid)]
    cpu32 = client_steps(torch, cs, mcfg, opt, batches, start, "cpu", torch.float32)
    f64 = client_steps(torch, cs, mcfg, opt, batches, start, "cpu", torch.float64)
    forced = client_steps(torch, cs, mcfg, opt, batches, start, "cpu", torch.float64,
                          forced_steps=card_run[1])
    cpu32_forced = client_steps(torch, cs, mcfg, opt, batches, start, "cpu", torch.float32,
                                forced_steps=card_run[1])
    # the wave itself: each wave's own decisions, and f64 forced by them
    with cs.cudnn_deterministic(torch):
        card_wave, card_wave_dec = recorded_wave(torch, cs, mcfg, dataset, opt, wave, start,
                                                 "cuda", cid)
    cpu_wave, cpu_wave_dec = recorded_wave(torch, cs, mcfg, dataset, opt, wave, start, "cpu", cid)
    card_wave, cpu_wave = card_wave[wave.index(cid)], cpu_wave[wave.index(cid)]
    f64_card_wave = client_steps(torch, cs, mcfg, opt, batches, start, "cpu", torch.float64,
                                 forced_steps=card_wave_dec)
    f64_cpu_wave = client_steps(torch, cs, mcfg, opt, batches, start, "cpu", torch.float64,
                                forced_steps=cpu_wave_dec)

    def differing(a, b):
        return int(sum(int((x != y).sum()) for x, y in zip(a, b)))

    def rel(a, b):
        d, n = float((a - b).norm()), float(b.norm())
        return d / n if n else (0.0 if d == 0 else math.inf)

    out = {"card": card, "model": model, "client": cid, "wave": wave,
           "decisions_a_step": int(sum(t.numel() for t in card_run[1][0])),
           "loop_vs_wave_on_card": cs.wave_gap([card_run[0][-1]], [in_wave]), "steps": []}
    for s in range(len(batches)):
        row = {"step": s + 1,
               "card_vs_f64": cs.wave_gap([card_run[0][s]], [f64[0][s]]),
               "cpu_f32_vs_f64": cs.wave_gap([cpu32[0][s]], [f64[0][s]]),
               "card_vs_f64_forced": cs.wave_gap([card_run[0][s]], [forced[0][s]]),
               "cpu_f32_forced_vs_f64_forced": cs.wave_gap([cpu32_forced[0][s]], [forced[0][s]]),
               "decisions_differing_card_vs_f64": differing(card_run[1][s], f64[1][s]),
               "decisions_differing_cpu_f32_vs_f64": differing(cpu32[1][s], f64[1][s]),
               "decisions_differing_card_vs_cpu_f32": differing(card_run[1][s], cpu32[1][s])}
        out["steps"].append(row)
        print(json.dumps(row), flush=True)
    last = len(batches) - 1
    out["wave"] = {
        "recorded_card_wave_vs_wave": cs.wave_gap([card_wave], [in_wave]),
        "recorded_card_wave_bit_equal": cs.same_bits(torch, card_wave, in_wave),
        "card_wave_vs_f64": cs.wave_gap([card_wave], [f64[0][last]]),
        "cpu_wave_vs_f64": cs.wave_gap([cpu_wave], [f64[0][last]]),
        "card_wave_vs_f64_forced_by_it": cs.wave_gap([card_wave], [f64_card_wave[0][last]]),
        "cpu_wave_vs_f64_forced_by_it": cs.wave_gap([cpu_wave], [f64_cpu_wave[0][last]]),
        "decisions_differing": [
            {"step": s + 1,
             "card_wave_vs_f64": differing(card_wave_dec[s], f64[1][s]),
             "cpu_wave_vs_f64": differing(cpu_wave_dec[s], f64[1][s]),
             "card_wave_vs_cpu_wave": differing(card_wave_dec[s], cpu_wave_dec[s]),
             "card_wave_vs_card_loop": differing(card_wave_dec[s], card_run[1][s])}
            for s in range(len(batches))]}
    for k, v in out["wave"].items():
        print(json.dumps({"wave " + k: v}), flush=True)
    s = 1   # local step 2
    out["step2_grads"] = {
        k: {"card_vs_f64": rel(card_run[2][s][j], f64[2][s][j]),
            "card_vs_f64_forced": rel(card_run[2][s][j], forced[2][s][j]),
            "cpu_f32_vs_f64": rel(cpu32[2][s][j], f64[2][s][j])}
        for j, k in enumerate(keys)}
    for k, v in out["step2_grads"].items():
        print(json.dumps({"step 2 gradient": k, **v}), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
