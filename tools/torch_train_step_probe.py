"""What one AdamW train step does to the loss on its own batch (on the card).

``chip_smoke.py`` phase 29 steps olmoe-1b-7b (full width, 4 of its 16
layers, bf16 compute, remat ``full``) twice on one batch and reads the
loss rising on the second step.  This separates the optimizer's first step
from the gradient: for olmoe and for qwen1.5-0.5b (dense, full width) it
takes one ``make_train_step`` step from the same seeded init and batch at
the config's learning rate and at 1/40 of it, then evaluates the loss of
the new parameters on the same batch (no grad).  AdamW's first step moves
every weight by about the learning rate whatever its gradient's size, so
a loss that rises at the config's rate and falls at the small one is the
step's size, not a wrong gradient; a loss that rises at both would point
at the gradient.

    PYTHONPATH=src python tools/torch_train_step_probe.py

The last line of its output is one JSON object with every reading.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE_LAYERS = 4
LR_DIVISOR = 40.0


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    from repro_torch.configs.base import LayerGroup
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenDataset
    from repro_torch.data.synthetic import make_lm_tokens
    from repro_torch.models.registry import make_train_step, model_fns

    if not torch.cuda.is_available():
        print("torch_train_step_probe: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    olmoe = get_config("olmoe-1b-7b")
    cfgs = {"qwen1.5-0.5b": get_config("qwen1.5-0.5b"),
            f"olmoe-1b-7b ({MOE_LAYERS} layers)": olmoe.replace(
                n_layers=MOE_LAYERS, groups=(LayerGroup(olmoe.groups[0].pattern, MOE_LAYERS),))}
    out = {"card": smi}
    for name, base in cfgs.items():
        data = TokenDataset(make_lm_tokens(200_000, base.vocab_size, seed=0), 128, 8, seed=0)
        batch = {"tokens": torch.from_numpy(data.next_batch()["tokens"]).cuda()}
        rows = {}
        for lr in (base.learning_rate, base.learning_rate / LR_DIVISOR):
            cfg = base.replace(learning_rate=lr)
            fns = model_fns(cfg)
            params, _ = fns.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
            step, opt = make_train_step(cfg)
            new, state, metrics = step(params, opt.init(params), batch)
            del params, state
            with torch.no_grad():
                after, _ = fns.loss(new, batch)
            rows[f"lr {lr:g}"] = {"before": float(metrics["loss"]), "after": float(after),
                                  "grad_norm": float(metrics["grad_norm"])}
            print(f"{name}, lr {lr:g}: loss {rows[f'lr {lr:g}']['before']:.6f} -> "
                  f"{rows[f'lr {lr:g}']['after']:.6f} on the same batch after one step "
                  f"(grad norm before clipping {rows[f'lr {lr:g}']['grad_norm']:.4f})", flush=True)
            del new
            torch.cuda.empty_cache()
        out[name] = rows
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
