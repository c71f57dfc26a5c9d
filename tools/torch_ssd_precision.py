"""What each path of the SSD-scan kernel costs mamba2-1.3b's served logits, on the card.

For each seed: mamba2-1.3b at its published width with random weights drawn
from the seed serves 4 prompts of 2048 tokens and 32 greedy decode steps
through ``serve``.  Then the same prefill and the decode steps fed the
served tokens (teacher-forced) run again in bf16 compute with the
prefill's scan through each of the kernel's paths (``ssd_scan.ops.PATHS``,
forced), and through the plain version at the model's ``ssm_chunk`` (the
reading every path is held against) and at half of it: two plain versions
that differ only in the order of their sums, the floor that no kernel can
move.  For each it prints ‖logits − plain‖ / ‖plain‖, the largest over the
prefill's last token and every decode step, and the share of those
positions whose argmax agrees with the plain version's.  Decode steps the
recurrence in plain torch on every path; only the state the prefill hands
it differs.

Then each path alone at the served scan shape (B = 4, L = 2048, H = 64,
P = 64, G = 1, N = 128, bf16) on inputs drawn from each seed: y's and the
final state's relative norms against the step recurrence, y's largest
|error| and its largest elementwise excess (|error| / (2e-2 + 2e-2 |want|),
above 1 an elementwise hold at 2e-2 fails), and the path's median time.

Run from the root of the repo on a machine with one CUDA card:

    PYTHONPATH=src python tools/torch_ssd_precision.py [--seeds 0 1]

The last line of its output is one JSON object with every reading.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from unittest import mock

import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels.ssd_scan import ops, ref
from repro_torch.launch.serve import serve
from repro_torch.models.registry import model_fns

ARCH = "mamba2-1.3b"
BATCH, PROMPT, STEPS = 4, 2048, 32
TOL = 2e-2


def teacher_forced(cfg, params, prompts, tokens):
    """Last-token logits of the prefill, then of each decode step fed ``tokens``."""
    fns = model_fns(cfg)
    s = prompts.shape[1]
    with torch.no_grad():
        logits, cache = fns.prefill(params, {"tokens": prompts, "cache_len": s + STEPS + 1})
        out = [logits]
        for i in range(STEPS):
            logits, cache = fns.decode(params, cache, {"token": tokens[:, i], "pos": s + i})
            out.append(logits)
    return out


def rel(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def against(got, want):
    """(largest relative norm over the positions, share of argmaxes agreeing)."""
    agree = torch.stack([g.argmax(-1) == w.argmax(-1) for g, w in zip(got, want)])
    return max(rel(g, w) for g, w in zip(got, want)), float(agree.float().mean())


def median_ms(fn, reps=30, warm=3):
    """Median CUDA-event time of one launch, launches queued behind a sleep."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(reps)]
    torch.cuda._sleep(reps * 1_000_000)
    for a, b in evs:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)


def served_logits(cfg, seed):
    """{reading: (largest relative norm, argmax agreement)} of one seed's served model."""
    res = serve(cfg, batch=BATCH, prompt_len=PROMPT, decode_steps=STEPS, seed=seed,
                log=lambda *a: None)
    kernel_cfg = cfg.replace(ssm_impl="pallas")
    args = (res["params"], res["prompts"], res["tokens"])
    plain = teacher_forced(cfg.replace(ssm_impl="chunked"), *args)
    out = {"plain, chunk halved (floor)": against(
        teacher_forced(cfg.replace(ssm_impl="chunked", ssm_chunk=cfg.ssm_chunk // 2), *args), plain)}
    real = ops.ssd
    for path in ops.PATHS:
        with mock.patch.object(ops, "ssd", lambda *a, _p=path, **kw: real(*a, **kw, path=_p)):
            out[path] = against(teacher_forced(kernel_cfg, *args), plain)
    return out


def scan_alone(seed):
    """{path: readings} of each path at the served scan shape on one seed's inputs."""
    b, l, h, p, g, n = BATCH, PROMPT, 64, 64, 1, 128
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    args = (rnd(b, l, h, p).bfloat16(), torch.nn.functional.softplus(rnd(b, l, h)),
            -torch.exp(rnd(h)), rnd(b, l, g, n).bfloat16(), rnd(b, l, g, n).bfloat16())
    want_y, want_s = ref.ssd_sequential(*args)
    out = {}
    for path in ops.PATHS:
        y, s = ops.ssd(*args, impl="pallas", path=path)
        err = (y.float() - want_y.float()).abs()
        out[path] = {"y_rel": rel(y, want_y), "state_rel": rel(s, want_s),
                     "y_max_abs_err": float(err.max()),
                     "y_elementwise": float((err / (TOL + TOL * want_y.float().abs())).max()),
                     "ms": median_ms(lambda: ops.ssd(*args, impl="pallas", path=path))}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    seeds = ap.parse_args().seeds
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi)
    cfg = get_config(ARCH)
    result = {"card": smi, "paths": list(ops.PATHS), "served": {}, "scan": {}}
    for seed in seeds:
        result["scan"][seed] = scan_alone(seed)
        for path, r in result["scan"][seed].items():
            print(f"seed {seed} scan {path:<14} y rel {r['y_rel']:.3e} max|err| "
                  f"{r['y_max_abs_err']:.3e} elementwise {r['y_elementwise']:.2f}, state rel "
                  f"{r['state_rel']:.3e}; {r['ms']:.4f} ms", flush=True)
        result["served"][seed] = served_logits(cfg, seed)
        for what, (worst, agree) in result["served"][seed].items():
            print(f"seed {seed} {ARCH} logits, {what:<28} against plain: {worst:.4e} (largest "
                  f"of {STEPS + 1} positions), argmax agreeing {100 * agree:.2f} %", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
