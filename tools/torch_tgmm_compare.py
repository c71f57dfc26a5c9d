"""``tgmm`` and one FEMNIST wave on the card, for comparing two trees in one call.

Times whichever ``repro_torch`` is on ``PYTHONPATH``: run it once with this
tree's ``src`` and once with another checkout's (``git archive`` of the
parent into a git-ignored directory), in turns, inside one call on one card.

* ``tgmm`` at the FEMNIST MLP's three layers (784→128, 128→128, 128→62) on a
  wave of 32 clients with 16/32/48/64 rows each (1,280 rows), in f32 and
  bf16, and at olmoe-1b-7b's expert products (64 experts, 2,048 → 1,024 and
  1,024 → 2,048) on a routed-like split of 65,536 rows in bf16: the kernel's
  own launch on a schedule made beforehand, median of CUDA events behind a
  sleep kernel, on each path the tree has;
* one warm ragged wave (those 32 clients, 10 local steps) under
  ``torch.profiler``: kernel launches, card busy ms and wall ms;
* where the tree has ``tgmm``'s paths, what its ``ffma`` path's time at
  784→128 is made of: a one-element ``zero_`` (the least a launch reads in
  this timing), a ``fill_`` of dw's bytes, ``tgmm`` with every group
  empty (dw's stores alone) and with 20 groups of 64 rows; and each of
  the path's tiles forced at the three layers.

    PYTHONPATH=src python tools/torch_tgmm_compare.py [--olmoe-reps 10]

The last line of its output is one JSON object with every reading.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from repro_torch.kernels.grouped_matmul import ops

BATCHES = (16, 32, 48, 64)
LAYERS = ((784, 128), (128, 128), (128, 62))
OLMOE = ((2048, 1024), (1024, 2048))


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


def launchers(x, dy, gs, dw):
    """{path: one raw launch} for this tree: the path table where the tree
    has one, else its single kernel on its own offsets."""
    m, k = x.shape
    n, g = dy.shape[1], gs.shape[0]
    if hasattr(ops, "TGMM_PATHS"):
        bounds = ops.row_bounds(gs, m)
        vectors = x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
        paths = [p for p in ops.TGMM_PATHS
                 if p == "ffma" or ops.choose_tgmm_path(m, k, n, g, x.dtype, vectors) == p]
        return {p: (lambda p=p: ops.launch_tgmm(p, x, dy, bounds, dw)) for p in paths}
    offs = torch.nn.functional.pad(torch.cumsum(gs, 0, dtype=torch.int32), (1, 0))
    lib, code = ops.library(), 0 if x.dtype == torch.float32 else 1
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        assert lib.repro_tgmm(code, x.data_ptr(), dy.data_ptr(), offs.data_ptr(), dw.data_ptr(),
                              m, k, n, g, stream) == 0
    return {"tgmm": launch}


def time_tgmm(sizes, k, n, dtype, reps, gen):
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    m = int(sum(sizes))
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    dy = torch.randn((m, n), generator=gen, device="cuda").to(dtype)
    dw = torch.empty((len(sizes), k, n), device="cuda", dtype=dtype)
    want = ops.ref.tgmm_ref(x, dy, gs, len(sizes)).float()
    out = {}
    for path, fn in launchers(x, dy, gs, dw).items():
        fn()
        torch.cuda.synchronize()
        err = float((dw.float() - want).abs().max())
        out[path] = {"ms": median_ms(fn, reps=reps, warm=2 if reps < 50 else 5), "max_abs_err": err}
    return out


def ffma_anatomy(gen):
    """The floors of the ``ffma`` path at 784→128 (f32) and each of its
    tiles forced at the three layers."""
    lib, stream = ops.library(), torch.cuda.current_stream().cuda_stream
    one, dw_bytes = torch.zeros(1, device="cuda"), torch.empty(32 * 784 * 128, device="cuda")
    out = {"zero_ one element": median_ms(lambda: one.zero_()),
           "fill_ of dw (12.85 MB)": median_ms(lambda: dw_bytes.fill_(1.0))}

    def forced(sizes, k, n, tile):
        g, m = len(sizes), max(sum(sizes), 1)
        gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        bounds = ops.row_bounds(gs, m)
        x = torch.randn((m, k), generator=gen, device="cuda")
        dy = torch.randn((m, n), generator=gen, device="cuda")
        dw = torch.empty((g, k, n), device="cuda")
        vb = ops.tgmm_copy_bytes(k, n, 4, x.data_ptr(), dy.data_ptr())
        code = ops.TGMM_PATHS["ffma"][0]
        return median_ms(lambda: lib.repro_tgmm(code, tile, 0, vb, x.data_ptr(), dy.data_ptr(),
                                                bounds.data_ptr(), dw.data_ptr(), k, n, g, stream))

    chosen = ops.tgmm_tile("ffma", 784, 128, 32)
    out["tgmm 784->128, every group empty"] = forced([0] * 32, 784, 128, chosen)
    out["tgmm 784->128, 20 groups of 64 rows"] = forced([64] * 20, 784, 128, chosen)
    sizes = [BATCHES[i % 4] for i in range(32)]
    for k, n in LAYERS:
        for i, (tk, tn) in enumerate(ops.TGMM_PATHS["ffma"][1]):
            out[f"tgmm {k}->{n}, tile {tk} x {tn}"] = forced(sizes, k, n, i)
    return out


def wave_reading():
    from repro_torch.core.budget import fedscale_budget_distribution
    from repro_torch.fed.batch_exec import BatchedExecutor
    from repro_torch.fed.trainer import FedConfig, FederatedTrainer, build_fl_clients
    from repro_torch.models.small import SmallModelConfig

    mcfg = SmallModelConfig(kind="mlp", n_classes=62, hidden=128, n_layers=2, image_size=28,
                            channels=1)
    clients, test = build_fl_clients(mcfg, fedscale_budget_distribution(128, seed=0), "femnist",
                                     n_samples=16000, batch_size=32, n_batches=10, seed=0)
    for i, c in enumerate(clients):
        c.data.batch_size = BATCHES[i % len(BATCHES)]
    fed = FedConfig(rounds=1, participants_per_round=32, max_parallel=32, local_steps=10,
                    client_batching="wave")
    trainer = FederatedTrainer(mcfg, clients, fed, test_batch=test)
    ex = BatchedExecutor(mcfg, trainer.opt, device="cuda")
    wave = clients[:32]
    ex.run_wave(trainer.params, wave, 10)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        ex.run_wave(trainer.params, wave, 10)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in rows) / 1e3
    tg = sum(e.device_time_total for e in rows if "tgmm" in e.key) / 1e3
    return {"rows": sum(c.data.batch_size for c in wave), "launches": sum(e.count for e in rows),
            "busy_ms": busy, "wall_ms": wall_ms, "tgmm_ms": tg}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--olmoe-reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_tgmm_compare: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}; tree: {ops.__file__}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sizes = [BATCHES[i % 4] for i in range(32)]
    res = {"card": smi, "layers": {}, "olmoe": {}}
    for k, n in LAYERS:
        for dtype in (torch.float32, torch.bfloat16):
            r = time_tgmm(sizes, k, n, dtype, 50, gen)
            res["layers"][f"{k}->{n} {str(dtype)[6:]}"] = r
            print(f"tgmm {k}->{n} {str(dtype)[6:]:>8}: " + "; ".join(
                f"{p} {v['ms']:.4f} ms (max|err| {v['max_abs_err']:.2e})" for p, v in r.items()),
                flush=True)
    torch.manual_seed(0)
    split = torch.distributions.Multinomial(
        65536, probs=torch.distributions.Dirichlet(torch.ones(64) * 4).sample()).sample()
    for k, n in OLMOE:
        r = time_tgmm(split.int().tolist(), k, n, torch.bfloat16, args.olmoe_reps, gen)
        res["olmoe"][f"{k}->{n}"] = r
        print(f"tgmm olmoe 65536 rows {k}->{n} bfloat16: " + "; ".join(
            f"{p} {v['ms']:.4f} ms (max|err| {v['max_abs_err']:.2e})" for p, v in r.items()),
            flush=True)
    if hasattr(ops, "TGMM_PATHS"):
        res["ffma_anatomy"] = ffma_anatomy(gen)
        for key, ms in res["ffma_anatomy"].items():
            print(f"{key}: {ms:.4f} ms", flush=True)
    res["wave"] = wave_reading()
    w = res["wave"]
    print(f"one warm wave ({w['rows']} rows a step x 10 steps): {w['launches']} launches, card "
          f"busy {w['busy_ms']:.2f} ms (tgmm {w['tgmm_ms']:.3f}), wall {w['wall_ms']:.2f} ms",
          flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
