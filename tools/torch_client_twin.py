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
    ap.add_argument("--model", default="resnet", choices=sorted(models))
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.smi_line()
    print(f"card: {card}", flush=True)
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


if __name__ == "__main__":
    sys.exit(main())
