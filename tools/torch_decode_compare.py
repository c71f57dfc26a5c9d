"""``flash_decode_int8`` on the card, for comparing two trees in one call.

Times whichever ``repro_torch`` is on ``PYTHONPATH``: run it once with this
tree's ``src`` and once with another checkout's (``git archive`` of the
parent into a git-ignored directory), in turns, inside one call on one card.

* the kernel at qwen1.5-0.5b's served decode shape (B = 4, Hq = Hk = 16,
  S = 2,081, kv_len = 2,080, D = 64, bf16 q and scales) on 8 random int8
  caches in the model's (B, S, Hk, D) layout, a launch on each in turn
  (141 MB, past the 50 MB L2), and at decode_32k's length (S = kv_len =
  32,768, the batch cut to 4) on 3 caches (831 MB): median of CUDA events
  behind a sleep kernel, the bytes' bound at 3.35 TB/s and the achieved
  TB/s, each output first held against ``decode_ref`` (1e-5);
* what the served time is made of: the same call with kv_len = 1 (one row
  read: the launch, the kernel's start-up and its merge), and the launch
  floor as this timing reads it: ``torch.cuda._sleep(0)`` and a
  one-element ``zero_``; and the wrapper's host time a call.

    PYTHONPATH=src python tools/torch_decode_compare.py

The last line of its output is one JSON object with every reading.
"""
from __future__ import annotations

import argparse
import itertools
import json
import statistics
import subprocess
import time

import torch

from repro_torch.kernels.flash_attention import decode_ops, decode_ref
from repro_torch.models.layers import quantize_kv

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
SHAPES = {   # name: (B, Hq, Hk, S, D, kv_len, caches)
    "served": (4, 16, 16, 2081, 64, 2080, 8),
    "served_kv_len_1": (4, 16, 16, 2081, 64, 1, 8),
    "decode_32k": (4, 16, 16, 32768, 64, 32768, 3),
}


def median_ms(fn, reps=50, warm=5):
    """Median per-launch CUDA-event time, every launch queued behind a sleep
    kernel so that host enqueue time stays out of the events."""
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


def cache(b, hq, hk, s, d, seed):
    """q (B, Hq, D) bf16 and an int8 cache of normal K/V in the model's
    layout, viewed as (B, Hk, S, D) and (B, Hk, S)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, hq, d), generator=gen, device="cuda").bfloat16()
    kq, ks = quantize_kv(torch.randn((b, s, hk, d), generator=gen, device="cuda"))
    vq, vs = quantize_kv(torch.randn((b, s, hk, d), generator=gen, device="cuda"))
    return q, kq.transpose(1, 2), vq.transpose(1, 2), ks.transpose(1, 2), vs.transpose(1, 2)


def io_bytes(b, hq, hk, kv_len, d):
    """int8 K and V and their bf16 scales up to kv_len, q in bf16, out in f32."""
    return 2 * b * hk * kv_len * d + 2 * 2 * b * hk * kv_len + 2 * b * hq * d + 4 * b * hq * d


def time_shape(name, reps):
    b, hq, hk, s, d, kv_len, n = SHAPES[name]
    caches = [cache(b, hq, hk, s, d, seed) for seed in range(n)]
    worst = 0.0
    for c in caches:
        got = decode_ops.flash_decode_int8(*c, kv_len=kv_len)
        want = decode_ref.flash_decode_int8_ref(*c, kv_len=kv_len)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        worst = max(worst, float((got - want).abs().max()))
        del want
    turn = itertools.cycle(caches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        decode_ops.flash_decode_int8(*next(turn), kv_len=kv_len)
    host_ms = (time.perf_counter() - t0) / n * 1e3
    ms = median_ms(lambda: decode_ops.flash_decode_int8(*next(turn), kv_len=kv_len),
                   reps=reps, warm=2 * n)
    nbytes = io_bytes(b, hq, hk, kv_len, d)
    row = {"shape": [b, hq, hk, s, d, kv_len], "ms": ms, "host_ms": host_ms,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "mbytes": nbytes / 1e6,
           "tb_per_s": nbytes / (ms * 1e-3) / 1e12, "max_abs_err": worst}
    print(f"  {name} {row['shape']}: {ms:.4f} ms, {row['tb_per_s']:.3f} TB/s; bound "
          f"{row['bound_ms']:.4f} ms ({row['mbytes']:.2f} MB at 3.35 TB/s); host "
          f"{host_ms:.4f} ms a call; max|err| {worst:.2e}", flush=True)
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_decode_compare: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}; repro_torch from {decode_ops.__file__}", flush=True)
    decode_ops.library()
    z = torch.zeros(1, device="cuda")
    out = {"card": smi, "source": decode_ops.__file__,
           "floor_sleep0_ms": median_ms(lambda: torch.cuda._sleep(0), reps=args.reps),
           "floor_zero_ms": median_ms(z.zero_, reps=args.reps)}
    print(f"  launch floor: _sleep(0) {out['floor_sleep0_ms']:.4f} ms, one-element zero_ "
          f"{out['floor_zero_ms']:.4f} ms", flush=True)
    for name in SHAPES:
        out[name] = time_shape(name, args.reps)
        torch.cuda.empty_cache()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
