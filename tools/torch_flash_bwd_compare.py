"""The flash backward on the card, for comparing two trees in one call.

Times whichever ``repro_torch`` is on ``PYTHONPATH``: run it once with this
tree's ``src`` and once with another checkout's (``git archive`` of the
parent into a git-ignored directory), in turns, inside one call on one card.
At qwen1.5-0.5b's and recurrentgemma-9b's training shapes (8 x 128) and the
five serve shapes of ``chip_smoke.py`` phase 30, in bf16, it times
``flash_attention_bwd`` on the path the tree picks for aligned bf16 (a tree
without ``choose_bwd_path`` has one path), each output first held against
the plain backward in f32 (relative norm 2e-2): the median of CUDA events
behind a sleep kernel, the FLOPs of the four gradient products over the
live pairs (8 D a pair) a millisecond, and the wrapper's host time a call
(200 calls enqueued back to back, no synchronisation between them).

    PYTHONPATH=src python tools/torch_flash_bwd_compare.py

The last line of its output is one JSON object with every reading.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import time

import torch

from repro_torch.kernels.flash_attention import ops, ref

SHAPES = {   # name: (B, Sq, Skv, Hq, Hk, D, causal, window)
    "qwen train": (8, 128, 128, 16, 16, 64, True, None),
    "recurrentgemma train": (8, 128, 128, 16, 1, 256, True, 2048),
    "qwen serve": (4, 2048, 2048, 16, 16, 64, True, None),
    "recurrentgemma serve": (4, 2048, 2048, 16, 1, 256, True, 2048),
    "olmoe serve": (4, 2048, 2048, 16, 16, 128, True, None),
    "whisper encoder": (4, 2048, 2048, 8, 8, 64, False, None),
    "internvl2 serve": (4, 2304, 2304, 48, 8, 128, True, None),
}


def median_ms(fn, reps=20, warm=3):
    """Median per-call CUDA-event time, every call queued behind a sleep
    kernel so that host enqueue time stays out of the events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(reps)]
    torch.cuda._sleep(reps * 5_000_000)
    for a, b in evs:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)


def host_ms(fn, reps=200):
    """Host wall a call while the calls only enqueue work on the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def live_pairs(sq, skv, causal, window):
    n = 0
    for i in range(sq):
        p = i + skv - sq
        hi = min(skv - 1, p) if causal else skv - 1
        lo = max(0, p - window + 1) if window is not None else 0
        n += max(0, hi - lo + 1)
    return n


def main() -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    ops.library()
    readings = {}
    for name, shape in SHAPES.items():
        b, sq, skv, hq, hk, d, causal, window = shape
        gen = torch.Generator().manual_seed(3)
        q, k, v, do = (torch.randn(s, generator=gen).to("cuda", torch.bfloat16) for s in
                       ((b, sq, hq, d), (b, skv, hk, d), (b, skv, hk, d), (b, sq, hq, d)))
        mask = dict(causal=causal, window=window)
        o, lse = ops.flash_attention_fwd(q, k, v, **mask)
        chooser = getattr(ops, "choose_bwd_path", None)
        path = chooser(q, k, v, o, do) if chooser else "bwd_ffma"
        got = ops.flash_attention_bwd(q, k, v, o, lse, do, **mask)
        want = ref.attention_bwd_ref(q.float(), k.float(), v.float(), do.float(), **mask)
        rel = [float((a.float() - w).norm() / w.norm()) for a, w in zip(got, want)]
        assert max(rel) <= 2e-2, (name, rel)
        del got, want
        ms = median_ms(lambda: ops.flash_attention_bwd(q, k, v, o, lse, do, **mask))
        host = host_ms(lambda: ops.flash_attention_bwd(q, k, v, o, lse, do, **mask))
        flops = 8 * d * live_pairs(sq, skv, causal, window) * b * hq
        readings[name] = {"shape": list(shape), "path": path, "ms": ms, "host_ms": host,
                          "rel": rel, "tflops_8d": flops / ms / 1e9}
        print(f"{name:<22} {path:<9} {ms:.4f} ms  {flops / ms / 1e9:6.1f} TFLOP/s (8 D a live "
              f"pair), host {host:.4f} ms a call  dq/dk/dv relative "
              f"{' '.join(f'{e:.2e}' for e in rel)}", flush=True)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "tree": ops.__file__, "readings": readings}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
