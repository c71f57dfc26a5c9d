"""qwen1.5-0.5b's train step on the card, walls and host time, for comparing two trees.

Times whichever ``repro_torch`` is on ``PYTHONPATH``: run it once with this
tree's ``src`` and once with another checkout's (``git archive`` of the
parent into a git-ignored directory), in turns, inside one call on one card.
At full width and batch 8 x 128 (``chip_smoke.py`` phase 30's step: the
init and batch ``launch/train.py`` draws, AdamW, remat full, bf16 compute)
it runs the step on the flash route (``attn_impl="pallas"``) and on the
chunked route, in turns (flash, chunked, flash, chunked), each turn from
fresh optimizer state: 2 warm steps, then ``--steps`` steps timed one by one
(each ending in a synchronize).  Then one warm step of each route under
``torch.profiler``: its wall, the card's busy time, its kernel launches, the
host time of the flash backward (the ``FlashAttentionBackward`` node,
children included) and the ops with the most host self time.

    PYTHONPATH=src python tools/torch_flash_step_profile.py [--steps 12]

The last line of its output is one JSON object with every reading.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import TokenDataset
from repro_torch.data.synthetic import make_lm_tokens
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.registry import make_train_step, model_fns

ARCH, BATCH, SEQ = "qwen1.5-0.5b", 8, 128
ROUTES = ("pallas", "chunked")


def profiled_step(step, params, state, batch):
    """One warm step under the profiler: wall ms, busy ms, launches, the
    flash backward's host ms and count, and the top host self times."""
    step(params, state, batch)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(params, state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    bwd = [e for e in events if e.key == "FlashAttentionBackward"]
    top = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:10]
    return {"wall_ms": wall, "busy_ms": busy, "launches": launches,
            "flash_bwd_host_ms": sum(e.cpu_time_total for e in bwd) / 1e3,
            "flash_bwd_calls": sum(e.count for e in bwd),
            "host_self_ms": sum(e.self_cpu_time_total for e in events) / 1e3,
            "top_host_self_ms": {e.key: [e.self_cpu_time_total / 1e3, e.count] for e in top}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=12)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    fa_ops.library()
    cfg = get_config(ARCH)
    params0 = model_fns(cfg).init(torch.Generator(device="cuda").manual_seed(0), "cuda")[0]
    data = TokenDataset(make_lm_tokens(200_000, cfg.vocab_size, seed=0), SEQ, BATCH, seed=0)
    batch = {"tokens": torch.from_numpy(data.next_batch()["tokens"]).to("cuda")}
    steps = {impl: make_train_step(cfg.replace(attn_impl=impl)) for impl in ROUTES}
    walls = {impl: [] for impl in ROUTES}
    for impl in ROUTES * 2:
        step, opt = steps[impl]
        params, state = params0, opt.init(params0)
        for _ in range(2):
            params, state, _ = step(params, state, batch)
        torch.cuda.synchronize()
        for _ in range(args.steps):
            t0 = time.perf_counter()
            params, state, _ = step(params, state, batch)
            torch.cuda.synchronize()
            walls[impl].append((time.perf_counter() - t0) * 1e3)
        del params, state
    readings = {}
    for impl in ROUTES:
        step, opt = steps[impl]
        prof = profiled_step(step, params0, opt.init(params0), batch)
        readings[impl] = {"median_ms": statistics.median(walls[impl]), "walls_ms": walls[impl],
                          **prof}
        print(f"{impl:<8} median {readings[impl]['median_ms']:.1f} ms over {len(walls[impl])} "
              f"steps ({min(walls[impl]):.1f}-{max(walls[impl]):.1f}); profiled wall "
              f"{prof['wall_ms']:.1f} ms, busy {prof['busy_ms']:.2f} ms, flash backward host "
              f"{prof['flash_bwd_host_ms']:.2f} ms in {prof['flash_bwd_calls']} calls, host self "
              f"{prof['host_self_ms']:.1f} ms", flush=True)
    print(json.dumps({"card": card, "tree": fa_ops.__file__, "readings": readings}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
