#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA H100.

    python3 chip_smoke.py          # from the root of a checkout, one CUDA card

Phases (any failure exits non-zero before the last line is printed):

1. setup   — TF32 off, build both kernel libraries from
             ``src/repro_torch/kernels/*/csrc`` with nvcc (sm_90a, one nvcc
             per library, side by side), print each one's build time and
             registers, spills and entry functions, and the card's name and
             power limit;
2. kernels — ``gmm`` and ``tgmm`` and the autograd Function's dx/dw against
             their plain PyTorch versions on the card: the three layer
             shapes of the FEMNIST MLP client and the ragged edge cases,
             f32 within 2e-5, bf16 within 2e-2, gradients within 1e-4;
3. main    — three federated rounds of 128 FEMNIST-MLP clients (784→128→
             128→62, the repo's default width), 32 participants per round
             with per-step batch sizes 16/32/48/64, so COLLECT trains every
             round's finishers as one ragged wave through the kernels;
             launch counts are read around that run;
4. split   — the kernels again at the main path's own row split (round 1's
             wave), then that whole wave trained on the card and on the CPU
             from the round-1 globals on twin worlds: each client's delta,
             leaf by leaf, within a relative norm of TWIN_REL_TOL; the same
             wave through a kernel that reads every group boundary one row
             late must fail that limit;
5. timings — each grouped-matmul kernel at the main path's shapes (median of
             50 launches) beside its plain version, one PyTorch library call
             and the least time the card could take; one profiled wave (card
             busy time against wall time); the wall seconds of each phase of
             a round;
6. flash   — the flash-attention kernel against its plain version on the
             card: the reference's sweep (GQA, window, MQA + window at
             S=384, non-causal), a suffix (Sq=128, Skv=512), a ragged length
             and the serve shape, f32 within 2e-5, bf16 within 2e-2;
7. serve   — the second path: ``repro_torch.launch.serve.serve`` on
             qwen1.5-0.5b at its published width (24 layers, d_model 1024,
             vocab 151,936), seeded random weights, batch 4, prompt 2048,
             32 greedy decode steps; the flash launches of that run (one per
             layer, all in the prefill), wall times, memory, and the card
             busy share of one prefill and one decode step (torch.profiler);
8. twin    — the same prefill and teacher-forced decode with attention
             through the plain version on the card: the logits of the
             prefill and of every decode step within a relative norm of
             SERVE_TWIN_REL_TOL (bf16 compute, the served model), the
             prefill's in f32 compute within SERVE_TWIN_F32_REL_TOL; the
             kernel fed K/V rolled by one position must fail each limit;
9. timings — the flash kernel at the serve shape (median of 50 launches)
             beside its plain version, scaled_dot_product_attention and the
             least time the card could take.

The last three lines are ``{"kernels": [...]}`` (``gmm`` and ``tgmm`` with
the launches of phase 3, ``flash_attention`` with those of phase 7), the
card's name and power limit as ``nvidia-smi`` prints them, and
``{"ok": true, "device": {...}}``.  The script uses one card: unless
``CUDA_VISIBLE_DEVICES`` names exactly one, it is set to the first.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, f32
# outside the tensor cores (the kernels accumulate with FFMA) and dense bf16
# on the tensor cores (the least time for bf16 work).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

CLIENT_BATCH_SIZES = (16, 32, 48, 64)
LAYERS = (("784->128", 784, 128), ("128->128", 128, 128), ("128->62", 128, 62))
GMM_SOURCE = "src/repro_torch/kernels/grouped_matmul/csrc/grouped_matmul.cu"
# ‖Δcuda − Δcpu‖ / ‖Δcpu‖ for each client and leaf of one 10-step wave
TWIN_REL_TOL = 2e-2

FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
SERVE_ARCH = "qwen1.5-0.5b"
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 2048, 32
# (B, Sq, Skv, Hq, Hk, D, causal, window)
SERVE_SHAPE = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 16, 16, 64, True, None)
FLASH_CASES = [            # tests/test_kernels.py:26-34, a suffix, a ragged length, the serve shape
    ("MHA", (1, 128, 128, 4, 4, 32, True, None)),
    ("GQA", (2, 256, 256, 8, 2, 64, True, None)),
    ("GQA + window", (2, 256, 256, 8, 2, 64, True, 64)),
    ("MQA + window, S=384", (1, 384, 384, 4, 1, 32, True, 128)),
    ("non-causal", (2, 128, 128, 4, 4, 64, False, None)),
    ("suffix Sq=128 Skv=512", (1, 128, 512, 4, 2, 64, True, None)),
    ("ragged S=200 + window", (2, 200, 200, 4, 2, 32, True, 48)),
    ("serve shape (qwen1.5-0.5b)", SERVE_SHAPE),
]
# ‖logits(kernel) − logits(plain)‖ / ‖logits(plain)‖ over the prefill and
# every decode step in bf16 compute (the served model), and over the prefill
# in f32 compute (the same weights, where bf16 rounding does not mask the kernel)
SERVE_TWIN_REL_TOL = 1e-1
SERVE_TWIN_F32_REL_TOL = 1e-3


def say(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 2


def edge_cases():
    """(name, K, N, group sizes, rows past the groups) beyond the layers."""
    return [
        ("empty groups", 128, 128, [0, 50, 0, 70, 0, 0, 13], 0),
        ("single group", 784, 62, [130], 0),
        ("zero-row first and last", 128, 62, [0, 40, 33, 0], 0),
        ("M off the tile, rows past the groups", 784, 128, [17, 0, 45, 61, 3], 5),
    ]


def check_kernels(torch, ops, ref, sizes, extra_cases=(), seed=0):
    """Each kernel and the autograd Function against the plain versions at
    the three layer shapes with ``sizes`` rows per group, plus
    ``extra_cases``; returns the largest f32 error of each kernel."""
    dev = "cuda"
    gen = torch.Generator().manual_seed(seed)
    cases = [(name, k, n, sizes, 0) for name, k, n in LAYERS] + list(extra_cases)
    worst = {"gmm": 0.0, "tgmm": 0.0}
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for name, k, n, sizes, extra in cases:
            g, m = len(sizes), sum(sizes) + extra
            x = torch.randn(m, k, generator=gen).to(dev, dtype)
            w = ((torch.rand(g, k, n, generator=gen) * 2 - 1) / math.sqrt(k)).to(dev, dtype)
            dy = torch.randn(m, n, generator=gen).to(dev, dtype)
            gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
            pairs = {
                "gmm": (ops.gmm(x, w, gs), ref.grouped_matmul_ref(x, w, gs)),
                "gmm dx (w transposed)": (ops.gmm(dy, w.transpose(1, 2), gs),
                                          ref.grouped_matmul_ref(dy, w.transpose(1, 2), gs)),
                "tgmm": (ops.tgmm(x, dy, gs, g), ref.tgmm_ref(x, dy, gs, g)),
            }
            torch.cuda.synchronize()
            errs = []
            for what, (got, want) in pairs.items():
                assert got.shape == want.shape and got.dtype == want.dtype, (name, what)
                assert torch.isfinite(got.float()).all(), (name, what)
                err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
                torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                                           msg=lambda m_, w_=what: f"{name} {w_} {dtype}: {m_}")
                errs.append(err)
                if dtype == torch.float32:
                    key = "tgmm" if what == "tgmm" else "gmm"
                    worst[key] = max(worst[key], err)
            for gi, size in enumerate(sizes):   # an empty group's dw is exact zeros
                assert size or not pairs["tgmm"][0][gi].any(), (name, gi)
            say(f"  {str(dtype)[6:]:>8} {name:<38} gmm {errs[0]:.2e}  dx {errs[1]:.2e}  "
                f"tgmm {errs[2]:.2e}  (tol {tol:g})")
    # the autograd Function against autograd through the plain versions
    for name, k, n in LAYERS:
        gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
        m = sum(sizes)
        x0 = torch.randn(m, k, generator=gen).to(dev)
        w0 = ((torch.rand(len(sizes), k, n, generator=gen) * 2 - 1) / math.sqrt(k)).to(dev)
        dy = torch.randn(m, n, generator=gen).to(dev)
        grads = []
        for fn in (ops.grouped_matmul, ref.grouped_matmul_ref):
            x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
            fn(x, w, gs).backward(dy)
            grads.append((x.grad, w.grad))
        torch.cuda.synchronize()
        for what, got, want in (("dx", grads[0][0], grads[1][0]), ("dw", grads[0][1], grads[1][1])):
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
            say(f"  autograd {name:<9} {what} max|err| {float((got - want).abs().max()):.2e} (tol 1e-4)")
    return worst


# ---------------------------------------------------------------- phase 3


def build_world(mcfg, seed=0):
    from repro_torch.core.budget import fedscale_budget_distribution
    from repro_torch.fed.trainer import build_fl_clients

    clients, test = build_fl_clients(
        mcfg, fedscale_budget_distribution(128, seed=seed), "femnist",
        n_samples=16000, batch_size=32, n_batches=10, seed=seed)
    for i, c in enumerate(clients):
        c.data.batch_size = CLIENT_BATCH_SIZES[i % len(CLIENT_BATCH_SIZES)]
    return clients, test


def run_main_path(torch, ops, mcfg):
    from repro_torch.fed.trainer import FedConfig, FederatedTrainer, RoundPhase

    clients, test = build_world(mcfg)
    fed = FedConfig(rounds=3, participants_per_round=32, max_parallel=32,
                    local_steps=10, client_batching="wave")
    trainer = FederatedTrainer(mcfg, clients, fed, test_batch=test)   # the card, MeasuredRuntime
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    phase_s, collect_launches, waves, globals_r1 = [], [], [], None
    t_run = time.perf_counter()
    for _ in range(fed.rounds):
        st = trainer.begin_round()
        walls = {}
        while st.phase is not RoundPhase.DONE:
            phase = st.phase
            before = dict(ops.LAUNCHES)
            t0 = time.perf_counter()
            trainer.step_round(st)
            torch.cuda.synchronize()
            walls[phase.value] = walls.get(phase.value, 0.0) + time.perf_counter() - t0
            if phase is RoundPhase.COLLECT:
                collect_launches.append({k: ops.LAUNCHES[k] - before[k] for k in before})
                waves.append([cid for cid, _ in st.finishers])
        phase_s.append(walls)
        if trainer.round == 1:
            globals_r1 = trainer.params   # AGGREGATE replaces params, never mutates them
        say("  round", json.dumps(st.rec))
    run_s = time.perf_counter() - t_run
    launches = dict(ops.LAUNCHES)
    hist = trainer.history
    stats = trainer.batch_exec.stats
    say(f"  wave stats {stats.as_dict()}; launches {launches}; "
        f"COLLECT launches per round {collect_launches}; run {run_s:.2f} s")
    assert stats.ragged_clients > 0, stats
    assert all(c["gmm"] > 0 and c["tgmm"] > 0 for c in collect_launches), collect_launches
    assert all(launches[k] > 0 for k in launches), launches
    for rec in hist:
        for k, v in rec.items():
            if "loss" in k or k.endswith("_ce"):
                assert math.isfinite(v), (k, v)
    assert hist[-1]["test_loss"] < hist[0]["test_loss"], [r["test_loss"] for r in hist]
    return trainer, launches, phase_s, waves, globals_r1, run_s


# ---------------------------------------------------------------- phase 4


def wave_deltas(torch, mcfg, opt, wave_cids, globals_r1, dev):
    """Each client's delta leaves (f32, on the host) after one 10-step
    ragged wave from ``globals_r1`` on a fresh twin world."""
    from repro_torch.fed.batch_exec import BatchedExecutor
    from repro_torch.tree import tree_leaves, tree_map

    clients, _ = build_world(mcfg)              # a fresh twin: identical shuffles
    by_id = {c.client_id: c for c in clients}
    params = tree_map(lambda t: t.to(dev), globals_r1)
    ex = BatchedExecutor(mcfg, opt, device=dev)
    res = ex.run_wave(params, [by_id[c] for c in wave_cids], 10, round_idx=1)
    assert ex.last_wave["mode"] == "ragged", ex.last_wave
    return [[t.float().cpu() for t in tree_leaves(d)] for d, _, _ in res]


def wave_gap(got, want):
    """(largest per-client, per-leaf ‖got − want‖ / ‖want‖, largest |got − want|)."""
    rel, absmax = 0.0, 0.0
    for cg, cw in zip(got, want):
        for a, b in zip(cg, cw):
            diff, norm = float((a - b).norm()), float(b.norm())
            rel = max(rel, diff / norm if norm else (0.0 if diff == 0 else math.inf))
            absmax = max(absmax, float((a - b).abs().max()))
    return rel, absmax


def twin_wave(torch, ops, mcfg, opt, wave_cids, globals_r1):
    """The wave on the card against the CPU, and the same wave through a
    wrong kernel (every group boundary one row late: each group's first row
    counted in the group before it) against the CPU: the first gap must be
    within TWIN_REL_TOL, the second outside."""
    from repro_torch.fed import batch_exec

    want = wave_deltas(torch, mcfg, opt, wave_cids, globals_r1, "cpu")
    sound = wave_gap(wave_deltas(torch, mcfg, opt, wave_cids, globals_r1, "cuda"), want)

    def misrouted(x, w, gs):
        shift = torch.zeros_like(gs)
        shift[0], shift[-1] = 1, -1
        return ops.grouped_matmul(x, w, gs + shift)

    with mock.patch.object(batch_exec, "grouped_matmul", misrouted):
        wrong = wave_gap(wave_deltas(torch, mcfg, opt, wave_cids, globals_r1, "cuda"), want)
    say(f"  {len(wave_cids)} clients x 10 steps, card against CPU: relative {sound[0]:.3e}, "
        f"max abs {sound[1]:.3e}; boundaries one row late: relative {wrong[0]:.3e}, "
        f"max abs {wrong[1]:.3e} (limit relative {TWIN_REL_TOL:g})")
    assert sound[0] < TWIN_REL_TOL, sound
    assert wrong[0] > TWIN_REL_TOL, wrong
    return sound


# ---------------------------------------------------------------- phase 5


def profile_wave(torch, mcfg, opt, wave_cids, params):
    """Wall time of one warm ragged wave on the card against the time the
    card spends in kernels: how far the host holds the card back in COLLECT."""
    from repro_torch.fed.batch_exec import BatchedExecutor

    clients, _ = build_world(mcfg)
    by_id = {c.client_id: c for c in clients}
    wave = [by_id[c] for c in wave_cids]
    ex = BatchedExecutor(mcfg, opt, device="cuda")
    profile_call(torch, f"one warm wave ({len(wave)} clients x 10 steps)",
                 lambda: ex.run_wave(params, wave, 10), share_of="gmm_kernel")


def median_ms(torch, fn, reps=50, warm=5):
    """Median of per-launch CUDA-event times.  All launches are enqueued
    before one synchronize, so the card runs them back to back and host
    enqueue time does not land between a launch's events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(reps)]
    for a, b in evs:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)


def time_kernels(torch, ops, ref, sizes):
    """Times at the main path's shapes: the first round's wave of ``sizes``
    rows per client.  Returns rows for each kernel and layer."""
    dev = "cuda"
    lib = ops.library()
    gen = torch.Generator().manual_seed(1)
    g, m = len(sizes), sum(sizes)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    offs = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                      torch.cumsum(gs, 0, dtype=torch.int32)])
    ends = offs[1:].contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    has_lib = hasattr(torch, "_grouped_mm")
    rows = []
    for layer, k, n in LAYERS:
        x = torch.randn(m, k, generator=gen).to(dev)
        w = ((torch.rand(g, k, n, generator=gen) * 2 - 1) / math.sqrt(k)).to(dev)
        dy = torch.randn(m, n, generator=gen).to(dev)
        y = torch.empty(m, n, device=dev)
        dw = torch.empty(g, k, n, device=dev)
        xb, wb, dyb = x.bfloat16(), w.bfloat16(), dy.bfloat16()
        yb, dwb = y.bfloat16(), dw.bfloat16()

        def gmm(x_=x, w_=w, y_=y, code=0):
            assert lib.repro_gmm(code, x_.data_ptr(), w_.data_ptr(), offs.data_ptr(), y_.data_ptr(),
                                 m, k, n, g, *w_.stride(), stream) == 0

        def tgmm(x_=x, dy_=dy, dw_=dw, code=0):
            assert lib.repro_tgmm(code, x_.data_ptr(), dy_.data_ptr(), offs.data_ptr(),
                                  dw_.data_ptr(), m, k, n, g, stream) == 0

        # the library call wants K and N multiples of 16: N = 62 is timed on
        # operands zero-padded to 64 (the padding is the library's cost, not ours)
        lib_gmm = lib_tgmm = None
        n_pad = -(-n // 16) * 16
        lib_note = f"operands zero-padded to N={n_pad}" if n_pad != n else ""
        if has_lib and k % 16 == 0:
            wb_p = torch.nn.functional.pad(wb, (0, n_pad - n))
            dyb_p = torch.nn.functional.pad(dyb, (0, n_pad - n))
            try:
                lib_gmm = median_ms(torch, lambda: torch._grouped_mm(xb, wb_p, offs=ends))
                lib_tgmm = median_ms(torch, lambda: torch._grouped_mm(xb.t(), dyb_p, offs=ends))
            except RuntimeError as e:   # the yardstick refused: say why, time nothing
                lib_gmm = lib_tgmm = None
                lib_note = f"library call refused ({lib_note or 'unpadded'}): {str(e)[:200]}"
        io_bytes = 4 * (m * k + g * k * n + m * n) + 4 * (g + 1)
        flops = 2 * m * k * n
        t_bytes, t_ops = io_bytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
        bound = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
        for name, fn, fn_bf16, plain, lib_ms in (
                ("gmm", gmm, lambda: gmm(xb, wb, yb, 1),
                 lambda: ref.grouped_matmul_ref(x, w, gs), lib_gmm),
                ("tgmm", tgmm, lambda: tgmm(xb, dyb, dwb, 1),
                 lambda: ref.tgmm_ref(x, dy, gs, g), lib_tgmm)):
            rows.append({
                "name": name, "layer": layer, "M": m, "K": k, "N": n, "G": g,
                "ms": median_ms(torch, fn), "bf16_ms": median_ms(torch, fn_bf16),
                "plain_ms": median_ms(torch, plain), "library_ms": lib_ms,
                "bound_ms": bound[0], "bound_by": bound[1], "bytes": io_bytes, "flops": flops,
            })
            r = rows[-1]
            say(f"  {name:<4} {layer:<8} M={m} G={g}: {r['ms']:.4f} ms f32, {r['bf16_ms']:.4f} ms bf16;"
                f" plain {r['plain_ms']:.4f} ms; library(bf16) "
                f"{'null' if lib_ms is None else f'{lib_ms:.4f} ms'}"
                f"{f' ({lib_note})' if lib_note else ''}; bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}, {io_bytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    return rows


# ---------------------------------------------------------------- phase 6


def flash_inputs(torch, case, dtype, seed=0):
    b, sq, skv, hq, hk, d = case[:6]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for shape in ((b, sq, hq, d), (b, skv, hk, d), (b, skv, hk, d))]


def check_flash(torch, fa_ops, fa_ref):
    """The flash kernel against its plain version on the card: the
    reference's sweep, a suffix, a ragged length and the serve shape, f32
    within 2e-5 and bf16 within 2e-2.  Returns the largest f32 error."""
    worst = 0.0
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for name, case in FLASH_CASES:
            causal, window = case[6:]
            q, k, v = flash_inputs(torch, case, dtype)
            got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
            want = fa_ref.attention_ref(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            assert got.shape == want.shape and got.dtype == want.dtype == dtype, name
            assert torch.isfinite(got.float()).all(), name
            err = float((got.float() - want.float()).abs().max())
            torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                                       msg=lambda m_: f"flash {name} {dtype}: {m_}")
            if dtype == torch.float32:
                worst = max(worst, err)
            say(f"  {str(dtype)[6:]:>8} {name:<30} {str(case):<40} max|err| {err:.2e} (tol {tol:g})")
    return worst


# ---------------------------------------------------------------- phase 7


def device_rows(torch, prof):
    """(ms, count, name) of each kernel the profiler saw on the card: device
    rows only (the kernels themselves), so nothing counts twice."""
    return sorted(((e.device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)


def profile_call(torch, what, fn, share_of=None):
    """Wall time of one warm call against the card's busy time in it (and
    the share of that time in kernels whose name holds ``share_of``)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(torch, prof)
    busy_ms = sum(r[0] for r in rows)
    if busy_ms == 0:
        say(f"  {what}: wall {wall_ms:.2f} ms; card busy time not measured "
            f"(the profiler saw no device time)")
        return
    share = ""
    if share_of:
        ms = sum(r[0] for r in rows if share_of in r[2])
        share = f"; {share_of} {ms:.2f} ms ({100 * ms / busy_ms:.1f} % of busy)"
    say(f"  {what}: wall {wall_ms:.2f} ms, card busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / wall_ms:.1f} %), {sum(r[1] for r in rows)} kernel launches{share}")
    for ms, count, key in rows[:8]:
        say(f"    {ms:8.3f} ms  x{count:<5} {key[:90]}")


def run_serve(torch, ops, fa_ops, cfg):
    """The serve path at full width: one short warm-up call, then the
    counted run of ``serve`` with its own printed lines."""
    from repro_torch.launch.serve import serve
    from repro_torch.tree import tree_leaves

    kw = dict(batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, seed=0)
    serve(cfg, decode_steps=1, log=lambda *a: None, **kw)   # warm: allocator, library handles
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for counts in (ops.LAUNCHES, fa_ops.LAUNCHES):
        for key in counts:
            counts[key] = 0
    res = serve(cfg, decode_steps=SERVE_STEPS,
                log=lambda *a: say("  " + " ".join(map(str, a))), **kw)
    launches = {**ops.LAUNCHES, **fa_ops.LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    b, s = SERVE_BATCH, SERVE_PROMPT
    param_gb = sum(t.numel() * t.element_size() for t in tree_leaves(res["params"])) / 1e9
    cache_gb = (cfg.total_layers * 2 * b * (s + SERVE_STEPS + 1) * cfg.n_kv_heads
                * cfg.resolved_head_dim * 2) / 1e9
    say(f"  prefill {res['prefill_s']:.4f} s ({b * s / res['prefill_s']:.0f} tok/s), decode "
        f"{res['decode_s']:.4f} s ({b * SERVE_STEPS / res['decode_s']:.1f} tok/s); launches "
        f"{launches}; weights {param_gb:.2f} GB, bf16 KV cache {cache_gb:.2f} GB, "
        f"peak allocated {peak_gb:.2f} GB")
    assert launches["flash_attention"] == cfg.total_layers, launches   # one per layer, prefill only
    tokens = res["tokens"]
    assert tokens.shape == (b, SERVE_STEPS + 1), tokens.shape
    assert int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab_size
    for lg in res["logits"]:
        assert lg.shape == (b, cfg.vocab_size) and torch.isfinite(lg.float()).all()
    return res, launches


def profile_serve(torch, cfg, res):
    """Card busy share of one prefill and of one decode step, with the
    kernels that take the time."""
    from repro_torch.models.registry import model_fns

    fns = model_fns(cfg.replace(attn_impl="pallas"))
    batch = {"tokens": res["prompts"], "cache_len": SERVE_PROMPT + SERVE_STEPS + 1}
    with torch.no_grad():
        profile_call(torch, "one prefill (4 x 2048 tokens)",
                     lambda: fns.prefill(res["params"], batch), share_of="flash_fwd_kernel")
        _, cache = fns.prefill(res["params"], batch)
        step = {"token": res["tokens"][:, 0], "pos": SERVE_PROMPT}
        profile_call(torch, "one decode step (batch 4)", lambda: fns.decode(res["params"], cache, step))


# ---------------------------------------------------------------- phase 8


def teacher_forced_logits(torch, cfg, params, prompts, tokens):
    """Last-token logits of the prefill, then of each decode step fed the
    served tokens."""
    from repro_torch.models.registry import model_fns

    fns = model_fns(cfg)
    s, steps = prompts.shape[1], tokens.shape[1] - 1
    with torch.no_grad():
        logits, cache = fns.prefill(params, {"tokens": prompts, "cache_len": s + steps + 1})
        out = [logits]
        for i in range(steps):
            logits, cache = fns.decode(params, cache, {"token": tokens[:, i], "pos": s + i})
            out.append(logits)
    return out


def serve_twin(torch, fa_ops, cfg, res):
    """The served logits against the same prefill and decode with attention
    through the plain version on the card, as ‖kernel − plain‖ / ‖plain‖;
    then the kernel with K/V rolled by one position (each query also sees
    the next key) must fail the same limit.  The prefill again in f32
    compute, held to a tighter limit, with the same control."""
    real = fa_ops.flash_attention

    def rolled(q, k, v, *a, **kw):
        return real(q, torch.roll(k, -1, dims=1), torch.roll(v, -1, dims=1), *a, **kw)

    def rel(got, want):
        return float((got.float() - want.float()).norm() / want.float().norm())

    def readings(cfg_, tokens):
        args = (res["params"], res["prompts"], tokens)
        plain = teacher_forced_logits(torch, cfg_.replace(attn_impl="reference"), *args)
        kernel = (res["logits"] if tokens is res["tokens"] else
                  teacher_forced_logits(torch, cfg_.replace(attn_impl="pallas"), *args))
        with mock.patch.object(fa_ops, "flash_attention", rolled):
            wrong = teacher_forced_logits(torch, cfg_.replace(attn_impl="pallas"), *args)
        return ([rel(a, b) for a, b in zip(kernel, plain)],
                [rel(a, b) for a, b in zip(wrong, plain)], plain)

    sound, control, plain = readings(cfg, res["tokens"])
    agree = float(torch.stack([torch.argmax(p, -1) == t for p, t in
                               zip(plain, res["tokens"].unbind(1))]).float().mean())
    say(f"  bf16 compute, kernel against plain: last-token logits {sound[0]:.3e}, decode "
        f"steps {min(sound[1:]):.3e} .. {max(sound[1:]):.3e} (max {max(sound):.3e}); "
        f"greedy tokens agreeing {100 * agree:.2f} %")
    say(f"  bf16 compute, K/V rolled by one: last-token logits {control[0]:.3e}, decode steps "
        f"{min(control[1:]):.3e} .. {max(control[1:]):.3e} (max {max(control):.3e}); "
        f"limit relative {SERVE_TWIN_REL_TOL:g}")
    sound32, control32, _ = readings(cfg.replace(compute_dtype="float32"), res["tokens"][:, :1])
    say(f"  f32 compute, prefill last-token logits: kernel against plain {sound32[0]:.3e}, "
        f"K/V rolled by one {control32[0]:.3e} (limit relative {SERVE_TWIN_F32_REL_TOL:g})")
    assert max(sound) < SERVE_TWIN_REL_TOL, sound
    assert max(control) > SERVE_TWIN_REL_TOL, control
    assert sound32[0] < SERVE_TWIN_F32_REL_TOL, sound32
    assert control32[0] > SERVE_TWIN_F32_REL_TOL, control32


# ---------------------------------------------------------------- phase 9


def live_pairs(sq, skv, causal, window):
    """(query, key) pairs the masks leave live: the work this input needs."""
    n = 0
    for i in range(sq):
        p = i + skv - sq
        hi = min(skv - 1, p) if causal else skv - 1
        lo = max(0, p - window + 1) if window is not None else 0
        n += max(0, hi - lo + 1)
    return n


def time_flash(torch, fa_ops, fa_ref):
    """The kernel at the serve shape beside its plain version, the library's
    attention and the least time the card could take."""
    b, sq, skv, hq, hk, d, causal, window = SERVE_SHAPE
    q, k, v = flash_inputs(torch, SERVE_SHAPE, torch.bfloat16, seed=3)
    q32, k32, v32 = (t.float() for t in (q, k, v))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))   # (B, H, S, D)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row = {
        "ms": median_ms(torch, lambda: fa_ops.flash_attention(q, k, v)),
        "f32_ms": median_ms(torch, lambda: fa_ops.flash_attention(q32, k32, v32)),
        "plain_ms": median_ms(torch, lambda: fa_ref.attention_ref(q, k, v), reps=10),
        "library_ms": median_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True)),
    }
    pairs = live_pairs(sq, skv, causal, window)
    flops = 4 * b * hq * d * pairs                     # q·k and p·v on each live pair
    io_bytes = 2 * (2 * b * sq * hq * d + 2 * b * skv * hk * d)   # q, o, k, v in bf16
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, io_bytes / HBM_BYTES_PER_S * 1e3
    row.update(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
               ffma_ms=flops / F32_FLOPS * 1e3)
    say(f"  flash_attention B={b} S={sq} H={hq} D={d} causal bf16: {row['ms']:.4f} ms "
        f"(f32 {row['f32_ms']:.4f} ms); plain {row['plain_ms']:.4f} ms; library "
        f"(scaled_dot_product_attention, bf16) {row['library_ms']:.4f} ms; bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {flops / 1e9:.2f} GFLOP at 989 TFLOP/s, "
        f"{io_bytes / 1e6:.1f} MB at 3.35 TB/s); at the f32 FFMA rate {row['ffma_ms']:.4f} ms; "
        f"kernel / bound {row['ms'] / row['bound_ms']:.1f}, kernel / library "
        f"{row['ms'] / row['library_ms']:.1f}")
    return row


# ---------------------------------------------------------------- main


def main() -> int:
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "")
    if not visible or "," in visible:
        os.environ["CUDA_VISIBLE_DEVICES"] = visible.split(",")[0] or "0"
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: the port's sources are not beside this script ({SRC})",
              file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.grouped_matmul import ops, ref
    from repro_torch.models.small import SmallModelConfig

    t_all = time.perf_counter()
    say("PHASE 1 setup")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"  torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    smi = smi_line()
    say(f"  card: {smi}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:   # one nvcc per library, side by side
        for fut in [pool.submit(ops.library), pool.submit(fa_ops.library)]:
            fut.result()
    say(f"  kernels built in {time.perf_counter() - t0:.2f} s")
    for name in ("grouped_matmul", "flash_attention"):
        say(f"  {name}: nvcc {build.BUILD_SECONDS[name]:.2f} s")
        for line in build.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                say("   ", line.strip())
    say("  flash_attention dynamic shared memory a block: " + ", ".join(
        f"D<={d} {fa_ops.library().repro_flash_attention_smem_bytes(d)} B" for d in (32, 64, 128, 256)))

    say("PHASE 2 kernels against their plain versions")
    worst = check_kernels(torch, ops, ref, list(CLIENT_BATCH_SIZES) * 8, edge_cases())

    say("PHASE 3 main path: 3 rounds, 128 FEMNIST-MLP clients, ragged waves")
    mcfg = SmallModelConfig(kind="mlp", n_classes=62, hidden=128, n_layers=2,
                            image_size=28, channels=1)
    trainer, launches, phase_s, waves, globals_r1, run_s = run_main_path(torch, ops, mcfg)

    say("PHASE 4 the main path's row split: kernels, then one wave on the card and the CPU")
    by_id = {c.client_id: c for c in trainer.clients}
    sizes = [by_id[c].data.batch_size for c in waves[0]]
    say(f"  round 1's wave: {len(sizes)} clients, {sum(sizes)} rows a step")
    for k, v in check_kernels(torch, ops, ref, sizes, seed=2).items():
        worst[k] = max(worst[k], v)
    twin_wave(torch, ops, mcfg, trainer.opt, waves[0], globals_r1)

    say("PHASE 5 timings")
    rows = time_kernels(torch, ops, ref, sizes)
    profile_wave(torch, mcfg, trainer.opt, waves[0], globals_r1)
    for i, walls in enumerate(phase_s, 1):
        say(f"  round {i} phase wall s: " + ", ".join(f"{k} {v:.4f}" for k, v in walls.items()))
    say(f"  main path {run_s:.2f} s; so far {time.perf_counter() - t_all:.1f} s")
    del trainer, globals_r1

    say("PHASE 6 flash attention against its plain version")
    worst["flash_attention"] = check_flash(torch, fa_ops, fa_ref)

    cfg = get_config(SERVE_ARCH)
    say(f"PHASE 7 serve path: {SERVE_ARCH} at its published width ({cfg.total_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), "
        f"batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, {SERVE_STEPS} greedy decode steps")
    res, serve_launches = run_serve(torch, ops, fa_ops, cfg)
    profile_serve(torch, cfg, res)

    say("PHASE 8 serve twin: the same prefill and decode with attention through the plain version")
    serve_twin(torch, fa_ops, cfg, res)
    del res

    say("PHASE 9 flash attention timings at the serve shape")
    flash_row = time_flash(torch, fa_ops, fa_ref)
    say(f"  whole script {time.perf_counter() - t_all:.1f} s")

    replaces = {"gmm": "src/repro/kernels/grouped_matmul/kernel.py:49",
                "tgmm": "src/repro/kernels/grouped_matmul/ops.py:45"}
    kernels = []
    for name in ("gmm", "tgmm"):
        r = next(r for r in rows if r["name"] == name and r["layer"] == "784->128")
        kernels.append({
            "name": name, "route": "cuda", "source": GMM_SOURCE,
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": worst[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": "src/repro/kernels/flash_attention/kernel.py:89",
        "launches": serve_launches["flash_attention"],
        "max_abs_err": worst["flash_attention"], "ms": flash_row["ms"],
        "plain_ms": flash_row["plain_ms"], "bound_ms": flash_row["bound_ms"],
        "bound_by": flash_row["bound_by"], "library_ms": flash_row["library_ms"],
    })
    say(json.dumps({"kernels": kernels}))
    say(smi_line())
    assert torch.cuda.device_count() == 1, torch.cuda.device_count()
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
