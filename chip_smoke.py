#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA H100.

    python3 chip_smoke.py          # from the root of a checkout, one CUDA card

Phases (any failure exits non-zero before the last line is printed):

1. setup   — TF32 off, build the five kernel libraries from
             ``src/repro_torch/kernels/*/csrc`` with nvcc (sm_90a, one nvcc
             per library, side by side), print each one's build time and
             registers, spills and entry functions, and the card's name and
             power limit;
2. kernels — ``gmm`` and ``tgmm`` and the autograd Function's dx/dw against
             their plain PyTorch versions on the card: the three layer
             shapes of the FEMNIST MLP client and the ragged edge cases,
             f32 within 2e-5, bf16 within 2e-2, gradients within 1e-4; then
             ``gmm`` on every path (stream, ffma, ffma_wide, wgmma), forward
             and transposed w, at groups ending at and one row past the tile
             edges, one expert taking every row, a 32-row split over 384
             experts and all groups empty with rows past them (exact zeros);
             then ``tgmm`` on each path that takes the operands
             (``ops.TGMM_PATHS``: wgmma takes bf16 with 16-byte rows, ffma f32
             and any bf16; forced with ``path=``) at the layer shapes, the
             edge cases, one group of 300 rows and K = 784 with N = 136 (an
             empty group's dw exact zeros);
3. main    — three federated rounds of 128 FEMNIST-MLP clients (784→128→
             128→62, the repo's default width), 32 participants per round
             with per-step batch sizes 16/32/48/64, so COLLECT trains every
             round's finishers as one ragged wave through the kernels;
             launch counts are read around that run, ``tgmm``'s by path (all
             on ffma: the FL path runs f32);
4. split   — the kernels again at the main path's own row split (round 1's
             wave), then that whole wave trained on the card and on the CPU
             from the round-1 globals on twin worlds: each client's delta,
             leaf by leaf, within a relative norm of TWIN_REL_TOL; the same
             wave through a kernel that reads every group boundary one row
             late must fail that limit;
5. timings — each grouped-matmul kernel at the main path's shapes (median of
             50 launches), in f32 and bf16 (``tgmm`` on each path that takes
             the dtype), beside its plain version,
             ``torch._grouped_mm`` on the same dtype and the least time the
             card could take; one profiled wave (card
             busy time against wall time); the wall seconds of each phase of
             a round;
6. flash   — the flash-attention kernel against its plain version on the
             card, every case on each path that takes it (``ops.PATHS``:
             wgmma takes bf16, ffma f32 and bf16; forced with ``path=``):
             the reference's sweep (GQA, window, MQA + window at S=384,
             non-causal), a suffix (Sq=128, Skv=512), a ragged length, the
             serve shapes (qwen1.5-0.5b: MHA, D=64; recurrentgemma-9b: MQA,
             D=256, window 2048; olmoe-1b-7b: MHA, D=128), MQA at D=256 with
             a window edge inside the tiles (S=2048, window 512) and a suffix
             at D=128 (Sq=128, Skv=2048), f32 within 2e-5, bf16 within 2e-2;
7. serve   — the second path: ``repro_torch.launch.serve.serve`` on
             qwen1.5-0.5b at its published width (24 layers, d_model 1024,
             vocab 151,936), seeded random weights, batch 4, prompt 2048,
             32 greedy decode steps; the launches of that run (one flash
             launch per layer, all in the prefill, every one on the wgmma
             path), wall times, memory, and
             the card busy share of one prefill and one decode step
             (torch.profiler);
8. twin    — the same prefill and teacher-forced decode with attention
             through the plain version on the card: the logits of the
             prefill and of every decode step within a relative norm of
             SERVE_TWIN_REL_TOL (bf16 compute, the served model), the
             prefill's in f32 compute within SERVE_TWIN_F32_REL_TOL; the
             kernel fed K/V rolled by one position must fail each limit;
9. timings — the flash kernel at the three serve shapes (median of 50 launches)
             on each path (wgmma and ffma in bf16, ffma in f32) with the
             achieved TFLOP/s, beside its plain version,
             scaled_dot_product_attention and the least time the card could
             take;
10. ssd    — the SSD-scan kernel against the step recurrence (its plain
             version) on the card, every case on each path that takes it
             (``ssd_ops.PATHS``: wgmma takes bf16 with 16-byte rows and
             N > 32, ffma f32 and bf16; forced with ``path=``): the
             reference's sweep, G > 1 with a ragged L, mamba2-1.3b's serve
             shape, served widths with L off the wgmma path's 64-row chunks,
             G = 2 at served widths, a narrow case (N = 64, padded to the
             block's 128 state columns) and a strong decay
             (a = -exp(normal + 2)), f32 within 2e-5 and bf16 within 2e-2:
             relative norms of y and of the final state, and below the
             serve shape the state elementwise and y elementwise where
             N <= 32;
11. rglru  — the RG-LRU-scan kernel against the step recurrence: the
             reference's sweep, a ragged L and recurrentgemma-9b's serve
             shape, y within 2e-5 (f32) or 2e-2 (bf16), the final state 1e-4;
12. serve  — the third path: ``serve`` on mamba2-1.3b at its published width
             (48 layers, d_model 2048, 64 SSD heads of 64, state 128, vocab
             50,280, f32 weights), batch 4, prompt 2048, 32 greedy steps: 48
             ssd_scan launches, all in the prefill and every one on the
             wgmma path (``run_serve`` asserts ``ssd_ops.PATH_LAUNCHES``);
             wall, memory, card busy;
13. twin   — phase 8's twin for it with the scan through its plain version
             (``ssd_chunked``) and the kernel's inputs rolled by one position
             along L as the control; the final SSM states of the f32 prefill
             held at SERVE_TWIN_F32_REL_TOL too.  The bf16 run is also read
             plain against plain (chunk 128 against 256): where that floor
             reaches SERVE_TWIN_REL_TOL the bf16 readings are reported as a
             miss and the limit is held layer by layer instead: every
             layer's scan on its own served inputs, kernel against plain, at
             phase 10's tolerances, with the rolled control;
14. serve  — the fourth path: ``serve`` on recurrentgemma-9b at its published
             width (38 layers: 12 x (RG-LRU, RG-LRU, local attention) + 2
             RG-LRU, d_model 4096, 16 heads of 256, MQA, window 2048, d_ff
             12,288, vocab 256,000, bf16 weights): 26 rglru_scan and 12 flash
             launches a prefill, a ring KV cache of 2,048 slots decoding past
             it;
15. twin   — phase 13's twin for it, every kernel through its plain version
             (``rglru_associative``, the full-score attention; the floor
             swaps in the chunked attention); the control rolls both
             kernels' inputs in bf16 and the RG-LRU's alone in f32; every
             layer's RG-LRU scan at phase 11's tolerances;
16. timings — ``ssd_scan`` and ``rglru_scan`` at their serve shapes (median of
             50 launches) beside their plain versions and their bounds;
             ``ssd_scan`` on each path (wgmma and ffma in bf16, ffma in
             f32) with achieved TFLOP/s and TB/s and kernel over bound;
17. gmm    — ``gmm`` at olmoe-1b-7b's expert shapes (64 experts, 2048 -> 1024
             and 1024 -> 2048) on the router's splits (a 4 x 2048-token
             prefill, the same with 16 experts empty, a 4-token decode step)
             against the plain loop, f32 within 2e-5, bf16 within 2e-2; the
             backward's transposed w in bf16 at the prefill split on the
             wgmma and stream paths; ``tgmm`` in bf16 on its wgmma path at
             the prefill split for both products (x (65,536, 2,048) with dy
             (65,536, 1,024), and the reverse) and at the split with 16
             experts empty, within 2e-2; one call of ``gmm`` and of ``tgmm``
             on each path under ``torch.cuda.set_sync_debug_mode("error")``
             (no group size read on the host); both timed beside the plain
             loop, torch._grouped_mm and the bound, with the decode split's
             achieved bandwidth;
18. serve  — the fifth path: ``serve`` on olmoe-1b-7b at its published width
             (16 layers, d_model 2048, 16 heads of 128, 64 experts of 1024,
             top-8, vocab 50,304, f32 weights): 16 flash launches a prefill
             and 48 gmm launches a prefill and a decode step;
19. twin   — against every expert product through the plain loop: f32 end to
             end (prefill and decode) within SERVE_TWIN_F32_REL_TOL, with the
             experts' weights shifted by one as the control; bf16 every
             layer's MoE FFN on its own served inputs with the routing shared,
             within MOE_LAYER_REL_TOL, with inputs rolled by one token as the
             control; the bf16 end-to-end reading and the share of top-8
             sets that differ, printed (a routing flip is no kernel fault);
20. decode — ``flash_decode_int8`` against its plain version: the reference's
             cases, the serve decode (S=2081), MQA at D=256, D=128, three,
             eight and 32 query heads a KV head, kv_len = 65 of 2,081 (the
             cluster's idle splits), kv_len = 1 with eight splits, qwen's
             heads at a short S with kv_len on the last split edge and one
             past it, kv_len 0 and -1 (the reference's uniform softmax over
             all S slots: the wrapper launches a zero query over them) and
             S + 5 (every slot live); f32 and bf16 q, bf16 and f32 scales,
             within 1e-5;
21. serve  — qwen1.5-0.5b with an int8 KV cache at full width, profiled as
             phase 7 is; at the first and last decode steps
             ``flash_decode_int8`` runs on every layer's served cache and is
             held against its plain version (1e-5) and
             the model's own plain decode attention (2e-2 relative, and
             bf16's rounding elementwise), with K rolled one slot against V
             as the control; the int8 run's logits against a bf16 cache's,
             printed;
22. timings — ``flash_decode_int8`` at that served decode shape beside its
             plain version, the bound and SDPA over a pre-dequantized cache;
             the launch floor as this timing reads it (``_sleep(0)``, a
             one-element ``zero_``) and the wrapper's host time a call; then
             at decode_32k's length (S = kv_len = 32,768, batch 4, qwen's
             heads) on three random caches (831 MB, past the L2), with the
             achieved TB/s beside the bound;
23. clients — the paper's other client models at its widths through
             ``FederatedTrainer`` on the card: Fig 8's CNN on CIFAR-10 (32 x 32
             x 3, hidden 64, 2 conv layers, 10 classes) with and without the
             personalization tower, Fig 9/10's residual CNN on FEMNIST (28 x
             28 x 1, hidden 128, 2 blocks, 62 classes), Fig 6/7's LSTM on SST-2
             (vocab 2,048, seq 64, hidden 64, 2 layers, 2 classes); 64 clients,
             16 participants, 10 local steps, batch 32, so COLLECT is one dense
             (vmapped) wave; momentum or adamw.  Two rounds each with walls by
             phase and peak memory, one warm wave profiled (launches, card
             busy share), and 4 clients of round 2's wave card against CPU
             within TWIN_REL_TOL (the control, the CNN's ``fc`` fed
             NCHW-flattened features, must fail it).  Then phase 3's ragged
             MLP world one round each under adamw (weight decay 0.01),
             adafactor, int8 and topk compression, ``gmm``/``tgmm`` launches
             counted; the adafactor wave against its clients trained one by
             one (TWIN_REL_TOL); the int8 payload made on the card equal to
             the CPU's from the same delta and noise; ``comm_bytes`` equal to
             the wire bytes uploaded.  Last, a CNN run checkpointed every
             round, resumed by a new trainer after round 2, equal to an
             uninterrupted 3-round run (params bit for bit).
24. fabric — two FL tenants share one pool: ``PoolFabric`` (16 slots,
             capacity 100, lease TTL 2 s, a traced ``ObsPlane``) drives two
             trainers of phase 3's world (A weight 3, B weight 1; 3 rounds,
             32 participants, 10 local steps) through ``run_trainers``.  A
             batches (``FixedRuntime(2.0, 0.0)``: every client the same work,
             so clients of one budget admitted together finish together and
             each eager wave is ragged, a single client, or of one batch
             size), so its eager waves run the grouped-matmul kernels; B trains
             client by client under ``AnalyticalRuntime``.  Gates: each
             tenant's history on the simulated clock equal to a CPU run of
             the same world, params card against CPU within TWIN_REL_TOL,
             ``exec.spawns``/``fed.comm_bytes``/``client.batch_waves`` equal
             to the CPU's; the Perfetto export on both clocks parses, each
             tenant's track holds its ``client.exec`` spans, A's its
             ``client.batch_wave`` and B's its ``client.train`` wall spans;
             the ``gmm``/``tgmm`` launches equal what A's ragged waves imply
             (``tgmm`` all on ffma); A alone on a 32-slot pool against
             ``run_round``: simulated fields equal, losses and params within
             the reference's f32 allclose (2e-5).  Then the world as first
             specified, A on ``FixedRuntime(2.0, 1.0)`` (the work differs by
             batch size, so eager waves are mostly single clients): the same
             CPU-twin gates and launches equal to what its ragged waves
             imply.  Printed only: waves per round and their sizes, COLLECT
             wall (both worlds), the run's wall traced and untraced and
             against the tenants one after the other, and the analytical
             against the measured seconds of one client step.

The last three lines are ``{"kernels": [...]}`` (``gmm`` with the launches
of phases 3, 18, 23 and 24, ``tgmm`` with those of phases 3, 23 and 24, by path too, with worst
errors and times by path and olmoe's wgmma times, ``flash_attention`` with
those of phases 7, 14, 18 and 21, ``ssd_scan`` with those of phase 12,
``rglru_scan`` with those of phase 14, ``flash_decode_int8`` with those of
phase 21 and its decode_32k-length reading; flash and ``ssd_scan`` also by kernel path, with worst errors and
times by path, their ``ms`` and ``max_abs_err`` the bf16 ``wgmma`` path's),
the card's name and power limit as ``nvidia-smi`` prints them, and
``{"ok": true, "device": {...}}``.  The script uses one card: unless
``CUDA_VISIBLE_DEVICES`` names exactly one, it is set to the first.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
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
RG_ATTN_SHAPE = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 16, 1, 256, True, 2048)
OLMOE_ARCH = "olmoe-1b-7b"
OLMOE_ATTN_SHAPE = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 16, 16, 128, True, None)
FLASH_CASES = [            # tests/test_kernels.py:26-34, a suffix, a ragged length, the serve shapes
    ("MHA", (1, 128, 128, 4, 4, 32, True, None)),
    ("GQA", (2, 256, 256, 8, 2, 64, True, None)),
    ("GQA + window", (2, 256, 256, 8, 2, 64, True, 64)),
    ("MQA + window, S=384", (1, 384, 384, 4, 1, 32, True, 128)),
    ("non-causal", (2, 128, 128, 4, 4, 64, False, None)),
    ("suffix Sq=128 Skv=512", (1, 128, 512, 4, 2, 64, True, None)),
    ("ragged S=200 + window", (2, 200, 200, 4, 2, 32, True, 48)),
    ("serve shape (qwen1.5-0.5b)", SERVE_SHAPE),
    ("serve shape (recurrentgemma-9b)", RG_ATTN_SHAPE),
    ("serve shape (olmoe-1b-7b)", OLMOE_ATTN_SHAPE),
    ("MQA, D=256, S=2048, window 512", (1, 2048, 2048, 16, 1, 256, True, 512)),
    ("suffix D=128, Sq=128 Skv=2048", (2, 128, 2048, 8, 2, 128, True, None)),
]

SSD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
RGLRU_SOURCE = "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu"
MAMBA_ARCH, RGEMMA_ARCH = "mamba2-1.3b", "recurrentgemma-9b"
# (B, L, H, P, G, N) of mamba2-1.3b's prefill; its config's ssm_chunk sizes the plain version
SSD_SERVE_SHAPE, SSD_CHUNK = (SERVE_BATCH, SERVE_PROMPT, 64, 64, 1, 128), 256
# tests/test_kernels.py:66-68, G > 1 with a ragged L, the serve shape; then
# where the wgmma path's 64-row chunks and N padding matter (a strong decay:
# a = -exp(normal + 2), exp(cs) underflows within a chunk and a seg factored
# as exp(cs_t) exp(-cs_s) would overflow)
SSD_CASES = [              # (name, (B, L, H, P, G, N), strong decay)
    ("sweep, G=1", (1, 64, 2, 8, 1, 8), False),
    ("sweep, G=2", (2, 128, 4, 16, 2, 16), False),
    ("sweep, L=96", (1, 96, 4, 8, 1, 16), False),
    ("G=2, ragged L=45", (2, 45, 4, 8, 2, 16), False),
    ("serve shape (mamba2-1.3b)", SSD_SERVE_SHAPE, False),
    ("served widths, L=1000", (2, 1000, 8, 64, 1, 128), False),
    ("served widths, G=2", (2, 512, 8, 64, 2, 128), False),
    ("narrow, N=64 padded to 128", (2, 256, 4, 32, 1, 64), False),
    ("served widths, strong decay", (2, 256, 8, 64, 1, 128), True),
]
# (B, L, W) of recurrentgemma-9b's prefill
RGLRU_SERVE_SHAPE = (SERVE_BATCH, SERVE_PROMPT, 4096)
RGLRU_CASES = [            # tests/test_kernels.py:111, a ragged L, the serve shape
    ("sweep", (1, 64, 32)),
    ("sweep", (2, 256, 128)),
    ("sweep", (2, 96, 64)),
    ("ragged L=37", (2, 37, 48)),
    ("serve shape (recurrentgemma-9b)", RGLRU_SERVE_SHAPE),
]
# ‖kernel − plain‖ / ‖plain‖ of one MoE FFN in bf16 compute, on its own inputs
MOE_LAYER_REL_TOL = 2e-2
DECODE_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_decode_int8.cu"
# (B, Hq, Hk, S, D, kv_len)
DECODE_CASES = [           # tests/test_kernels.py:166-168, the serve decode, MQA at D=256, D=128
    ("reference case 1", (1, 4, 4, 128, 32, 100)),
    ("reference case 2, GQA", (2, 8, 2, 256, 64, 200)),
    ("reference case 3, MQA", (1, 4, 1, 512, 64, 511)),
    ("ragged S=2081 (qwen decode)", (SERVE_BATCH, 16, 16, 2081, 64, 2080)),
    ("MQA, D=256, S=2081", (SERVE_BATCH, 16, 1, 2081, 256, 2049)),
    ("D=128, S=2081, kv_len 1500", (SERVE_BATCH, 16, 16, 2081, 128, 1500)),
    ("G=3 (a thread's 4th head idle)", (1, 6, 2, 200, 64, 150)),
    ("G=8 (two warp teams)", (1, 8, 1, 333, 128, 300)),
    ("G=32, D=128 (two passes a team)", (1, 32, 1, 100, 128, 97)),
    ("kv_len 65 of 2081 (idle splits)", (1, 4, 4, 2081, 64, 65)),
    ("kv_len 1, eight splits", (2, 8, 2, 1000, 64, 1)),
    ("kv_len 0: uniform over all S", (2, 8, 2, 261, 64, 0)),
    ("kv_len -1: uniform over all S", (1, 4, 1, 512, 64, -1)),
    ("kv_len S + 5: every slot live", (SERVE_BATCH, 16, 16, 2081, 64, 2086)),
]
# qwen's heads at a short S: kv_len on the last split edge on this card, and one past it
DECODE_EDGE = (2, 16, 16, 600, 64)
# decode_32k's length at qwen's heads, the batch cut from 128 to 4
DECODE_LONG = (SERVE_BATCH, 16, 16, 32768, 64, 32768)
KERNEL_ROUTES = dict(attn_impl="pallas", ssm_impl="pallas", rglru_impl="pallas",
                     moe_gmm_impl="pallas")
# ‖logits(kernel) − logits(plain)‖ / ‖logits(plain)‖ over the prefill and
# every decode step in bf16 compute (the served model), and over the prefill
# in f32 compute (the same weights, where bf16 rounding does not mask the
# kernel); the recurrent paths hold their f32 prefill's final states to the
# f32 limit as well
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


def path_cases():
    """(name, K, N, group sizes, rows past the groups) that every gmm path
    takes: groups ending at and one row past the tile edges (8 rows a
    stream pass, 32 and 64 ffma rows, 128 wgmma rows; N = 320 past a
    256-column tile), one expert taking every row, a 32-row decode split
    over 384 experts, and rows past a split whose groups are all empty."""
    decode = [0] * 384
    for i in range(24):
        decode[(37 * i) % 384] += 1 + (i % 3 == 0)
    one = [0] * 16
    one[11] = 700
    return [
        ("groups at / one past tile edges", 64, 320, [128, 129, 127, 32, 33, 8, 9, 64, 65, 0, 1], 3),
        ("one expert takes every row", 128, 128, one, 0),
        ("G=384 decode split", 64, 64, decode, 0),
        ("every group empty, rows past them", 64, 96, [0] * 8, 300),
    ]


def check_paths(torch, ops, ref, cases, seed=3):
    """``gmm`` on every path that takes the dtype (``ops.PATHS``), the
    forward's w and the backward's transposed view, against the plain
    version: f32 within 2e-5, bf16 within 2e-2; rows outside every group
    exact zeros.  Returns the largest f32 error."""
    gen = torch.Generator().manual_seed(seed)
    worst = 0.0
    for name, k, n, sizes, extra in cases:
        g, m = len(sizes), sum(sizes) + extra
        gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        x0, dy0 = torch.randn(m, k, generator=gen), torch.randn(m, n, generator=gen)
        w0 = (torch.rand(g, k, n, generator=gen) * 2 - 1) / math.sqrt(k)
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            x, dy, w = (t.to("cuda", dtype) for t in (x0, dy0, w0))
            errs = []
            for path in ops.PATHS:
                if path == "wgmma" and dtype != torch.bfloat16:
                    continue
                for lhs, rhs in ((x, w), (dy, w.transpose(1, 2))):
                    got, want = ops.gmm(lhs, rhs, gs, path=path), ref.grouped_matmul_ref(lhs, rhs, gs)
                    torch.cuda.synchronize()
                    assert got.shape == want.shape and got.dtype == dtype, (name, path)
                    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                                               msg=lambda m_, p_=path: f"{name} {p_} {dtype}: {m_}")
                    assert not got[sum(sizes):].any(), (name, path)   # past the groups: zeros
                    errs.append(float((got.float() - want.float()).abs().max()))
            if dtype == torch.float32:
                worst = max(worst, max(errs))
            say(f"  {str(dtype)[6:]:>8} {name:<36} M={m} K={k} N={n} G={g}: {len(errs)} path x "
                f"layout runs, max|err| {max(errs):.2e} (tol {tol:g})")
    return worst


def tgmm_cases(sizes):
    """(name, K, N, group sizes, rows past the groups) that ``tgmm`` takes on
    each path: the three layers at ``sizes``, the edge cases, one group of
    300 rows (several 64-row wgmma stages) and K = 784 with N = 136 (ragged
    edges on the 128-row wgmma tile, N into its 256-column tile)."""
    return ([(name, k, n, sizes, 0) for name, k, n in LAYERS] + edge_cases()
            + [("one group of 300 rows", 128, 128, [300], 0),
               ("K=784 ragged edge, N=136", 784, 136, [150, 0, 300, 150], 7)])


def check_tgmm_paths(torch, ops, ref, cases, seed=4):
    """``tgmm`` on each path that takes the operands (``ops.TGMM_PATHS``,
    forced): f32 on ffma within 2e-5, bf16 on ffma and wgmma within 2e-2; an
    empty group's dw exact zeros; wgmma refuses rows that are no 16-byte
    multiple.  Returns the largest error by dtype and path."""
    gen = torch.Generator().manual_seed(seed)
    worst = {}
    for name, k, n, sizes, extra in cases:
        g, m = len(sizes), sum(sizes) + extra
        gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        x0, dy0 = torch.randn(m, k, generator=gen), torch.randn(m, n, generator=gen)
        line = []
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            x, dy = x0.to("cuda", dtype), dy0.to("cuda", dtype)
            want = ref.tgmm_ref(x, dy, gs, g).float()
            for path in ops.TGMM_PATHS:
                if path == "wgmma" and dtype != torch.bfloat16:
                    continue
                if path == "wgmma" and (k % 8 or n % 8):
                    try:
                        ops.tgmm(x, dy, gs, g, path=path)
                    except ValueError:
                        line.append(f"{path} refuses N={n}")
                        continue
                    raise AssertionError(f"tgmm {name}: wgmma took rows of {k} and {n}")
                got = ops.tgmm(x, dy, gs, g, path=path)
                torch.cuda.synchronize()
                assert got.shape == (g, k, n) and got.dtype == dtype, (name, path)
                torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol,
                                           msg=lambda m_, p_=path: f"tgmm {name} {p_} {dtype}: {m_}")
                for gi, size in enumerate(sizes):   # an empty group's dw is exact zeros
                    assert size or not got[gi].any(), (name, path, gi)
                err = float((got.float() - want).abs().max())
                key = f"{str(dtype)[6:]} {path}"
                worst[key] = max(worst.get(key, 0.0), err)
                line.append(f"{key} {err:.2e}")
        say(f"  tgmm {name:<38} M={m} K={k} N={n} G={g}: " + ", ".join(line)
            + " (tol 2e-5 f32, 2e-2 bf16)")
    return worst


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


def run_rounds(torch, trainer, rounds, counts=None):
    """``rounds`` rounds through the phase machine, synchronized after each
    phase: per round its walls by phase, its record (losses finite), the
    COLLECT wave's cids, the globals it started from (AGGREGATE replaces
    params, never mutates them) and, given a launch-count dict ``counts``,
    the launches its COLLECT made."""
    from repro_torch.fed.trainer import RoundPhase

    out = []
    for _ in range(rounds):
        start, st, walls, collect = trainer.params, trainer.begin_round(), {}, None
        while st.phase is not RoundPhase.DONE:
            phase, before = st.phase, dict(counts or {})
            t0 = time.perf_counter()
            trainer.step_round(st)
            torch.cuda.synchronize()
            walls[phase.value] = walls.get(phase.value, 0.0) + time.perf_counter() - t0
            if phase is RoundPhase.COLLECT and counts is not None:
                collect = {k: counts[k] - before[k] for k in before}
        for k, v in st.rec.items():
            if "loss" in k or k.endswith("_ce"):
                assert math.isfinite(v), (k, v)
        out.append({"walls": walls, "rec": st.rec, "start": start, "collect_launches": collect,
                    "cids": [cid for cid, _ in st.finishers]})
    return out


def run_main_path(torch, ops, mcfg):
    from repro_torch.fed.trainer import FedConfig, FederatedTrainer

    clients, test = build_world(mcfg)
    fed = FedConfig(rounds=3, participants_per_round=32, max_parallel=32,
                    local_steps=10, client_batching="wave")
    trainer = FederatedTrainer(mcfg, clients, fed, test_batch=test)   # the card, MeasuredRuntime
    for counts in (ops.LAUNCHES, ops.TGMM_PATH_LAUNCHES):
        for k in counts:
            counts[k] = 0
    t_run = time.perf_counter()
    rounds = run_rounds(torch, trainer, fed.rounds, ops.LAUNCHES)
    run_s = time.perf_counter() - t_run
    for r in rounds:
        say("  round", json.dumps(r["rec"]))
    phase_s = [r["walls"] for r in rounds]
    collect_launches = [r["collect_launches"] for r in rounds]
    waves = [r["cids"] for r in rounds]
    globals_r1 = rounds[1]["start"]
    launches = dict(ops.LAUNCHES)
    tgmm_paths = dict(ops.TGMM_PATH_LAUNCHES)
    hist = trainer.history
    stats = trainer.batch_exec.stats
    say(f"  wave stats {stats.as_dict()}; launches {launches}; tgmm by path {tgmm_paths}; "
        f"COLLECT launches per round {collect_launches}; run {run_s:.2f} s")
    assert stats.ragged_clients > 0, stats
    # the FL path runs f32: every weight gradient on tgmm's ffma path
    assert tgmm_paths == {"ffma": launches["tgmm"], "wgmma": 0}, tgmm_paths
    assert all(c["gmm"] > 0 and c["tgmm"] > 0 for c in collect_launches), collect_launches
    assert all(launches[k] > 0 for k in launches), launches
    assert hist[-1]["test_loss"] < hist[0]["test_loss"], [r["test_loss"] for r in hist]
    return trainer, launches, tgmm_paths, phase_s, waves, globals_r1, run_s


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
                 lambda: ex.run_wave(params, wave, 10),
                 share_of=("gmm_ffma_kernel", "tgmm_ffma_kernel"))


def median_ms(torch, fn, reps=50, warm=5):
    """Median of per-launch CUDA-event times.  All launches are enqueued
    behind a sleep kernel (~0.5 ms of card time a launch, longer than any
    wrapper takes to enqueue one) before one synchronize, so the card runs
    them back to back and host enqueue time does not land between a
    launch's events."""
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


def grouped_mm_ms(torch, x, w, ends, note=""):
    """``torch._grouped_mm`` on the same operands, or None with the reason
    where this PyTorch lacks it or refuses them (the yardstick, never the
    port's path)."""
    if not hasattr(torch, "_grouped_mm"):
        return None, "torch._grouped_mm missing"
    try:
        return median_ms(torch, lambda: torch._grouped_mm(x, w, offs=ends)), note
    except RuntimeError as e:
        return None, f"torch._grouped_mm refused {str(x.dtype)[6:]}: {str(e)[:160]}"


def time_kernels(torch, ops, ref, sizes):
    """Times at the main path's shapes: the first round's wave of ``sizes``
    rows per client, f32 (the path's dtype) and bf16, each beside
    ``torch._grouped_mm`` on the same dtype and its own bound.  Each kernel
    is timed on a schedule made beforehand (``ops.launch_gmm``,
    ``ops.launch_tgmm``), ``gmm``'s wrapper whole beside it; ``tgmm`` on
    each path that takes the dtype (``by_path``), its ``ms`` the path the
    wrapper picks.  Returns rows for each kernel and layer."""
    dev = "cuda"
    gen = torch.Generator().manual_seed(1)
    g, m = len(sizes), sum(sizes)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    ends = torch.cumsum(gs, 0, dtype=torch.int32)
    bounds = ops.row_bounds(gs, m)
    rows = []
    for layer, k, n in LAYERS:
        x = torch.randn(m, k, generator=gen).to(dev)
        w = ((torch.rand(g, k, n, generator=gen) * 2 - 1) / math.sqrt(k)).to(dev)
        dy = torch.randn(m, n, generator=gen).to(dev)
        by_dtype = {}
        for dtype, peak in ((torch.float32, F32_FLOPS), (torch.bfloat16, BF16_FLOPS)):
            xd, wd, dyd = x.to(dtype), w.to(dtype), dy.to(dtype)
            y = torch.empty(m, n, device=dev, dtype=dtype)
            dw = torch.empty(g, k, n, device=dev, dtype=dtype)
            path = ops.choose_path(m, k, n, g, dtype)
            prefix = None if path == "stream" else ops.tile_prefix(bounds, ops.PATHS[path][1])
            tgmm_path = ops.choose_tgmm_path(m, k, n, g, dtype)
            tgmm_paths = [p for p in ops.TGMM_PATHS if p == "ffma" or p == tgmm_path]

            # the library call wants K and N multiples of 16: N = 62 is timed on
            # operands zero-padded to 64 (the padding is the library's cost, not ours)
            n_pad = -(-n // 16) * 16
            note = f"operands zero-padded to N={n_pad}" if n_pad != n else ""
            lib_gmm = lib_tgmm = (None, "K is no multiple of 16")
            if k % 16 == 0:
                w_p = torch.nn.functional.pad(wd, (0, n_pad - n))
                dy_p = torch.nn.functional.pad(dyd, (0, n_pad - n))
                lib_gmm = grouped_mm_ms(torch, xd, w_p, ends, note)
                lib_tgmm = grouped_mm_ms(torch, xd.t(), dy_p, ends, note)
            esize = xd.element_size()
            io_bytes = esize * (m * k + g * k * n + m * n) + 4 * (g + 1)
            flops = 2 * m * k * n
            t_bytes, t_ops = io_bytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
            bound = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
            for name, fn, wrapped, plain, (lib_ms, lib_note) in (
                    ("gmm", lambda: ops.launch_gmm(path, xd, wd, bounds, prefix, y),
                     lambda: ops.gmm(xd, wd, gs), lambda: ref.grouped_matmul_ref(xd, wd, gs),
                     lib_gmm),
                    ("tgmm", lambda: ops.launch_tgmm(tgmm_path, xd, dyd, bounds, dw),
                     lambda: ops.tgmm(xd, dyd, gs, g), lambda: ref.tgmm_ref(xd, dyd, gs, g),
                     lib_tgmm)):
                r = {"name": name, "layer": layer, "dtype": str(dtype)[6:], "M": m, "K": k, "N": n,
                     "G": g, "path": path if name == "gmm" else tgmm_path,
                     "ms": median_ms(torch, fn), "wrapper_ms": median_ms(torch, wrapped),
                     "plain_ms": median_ms(torch, plain), "library_ms": lib_ms,
                     "bound_ms": bound[0], "bound_by": bound[1], "bytes": io_bytes, "flops": flops}
                if name == "tgmm":
                    r["by_path"] = {p: median_ms(torch, lambda p=p: ops.launch_tgmm(
                        p, xd, dyd, bounds, dw)) for p in tgmm_paths}
                by_dtype.setdefault(name, {})[r["dtype"]] = r
                say(f"  {name:<4} {layer:<8} {r['dtype']:>8} M={m} G={g} ({r['path']}): {r['ms']:.4f} ms"
                    f" (wrapper with its schedule {r['wrapper_ms']:.4f} ms)"
                    + ("; by path " + ", ".join(f"{p} {v:.4f} ms" for p, v in r["by_path"].items())
                       if name == "tgmm" else "")
                    + f"; plain {r['plain_ms']:.4f} ms; library "
                    f"{'null' if lib_ms is None else f'{lib_ms:.4f} ms'}"
                    f"{f' ({lib_note})' if lib_note else ''}; bound {r['bound_ms']:.4f} ms "
                    f"({r['bound_by']}, {io_bytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP); "
                    f"kernel / bound {r['ms'] / r['bound_ms']:.2f}"
                    + (f"; kernel / library {r['ms'] / lib_ms:.2f}" if lib_ms else ""))
        for name, per in by_dtype.items():
            rows.append({**per["float32"], "bfloat16": {
                key: per["bfloat16"][key]
                for key in ("ms", "wrapper_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                            "path", "by_path") if key in per["bfloat16"]}})
    return rows


# ---------------------------------------------------------------- phase 6


def flash_inputs(torch, case, dtype, seed=0):
    b, sq, skv, hq, hk, d = case[:6]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for shape in ((b, sq, hq, d), (b, skv, hk, d), (b, skv, hk, d))]


def check_flash(torch, fa_ops, fa_ref):
    """The flash kernel against its plain version on the card, every case
    on each path that takes it (f32: ffma; bf16: wgmma and ffma), f32
    within 2e-5 and bf16 within 2e-2.  Returns the largest error of each
    dtype and path."""
    worst = {}
    for dtype, tol, paths in ((torch.float32, 2e-5, ("ffma",)),
                              (torch.bfloat16, 2e-2, ("wgmma", "ffma"))):
        for name, case in FLASH_CASES:
            causal, window = case[6:]
            q, k, v = flash_inputs(torch, case, dtype)
            assert fa_ops.choose_path(q, k, v) == paths[0], name
            want = fa_ref.attention_ref(q, k, v, causal=causal, window=window)
            for path in paths:
                before = dict(fa_ops.PATH_LAUNCHES)
                got = fa_ops.flash_attention(q, k, v, causal=causal, window=window, path=path)
                torch.cuda.synchronize()
                assert fa_ops.PATH_LAUNCHES == {**before, path: before[path] + 1}, name
                assert got.shape == want.shape and got.dtype == want.dtype == dtype, name
                assert torch.isfinite(got.float()).all(), name
                err = float((got.float() - want.float()).abs().max())
                torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                                           msg=lambda m_: f"flash {name} {dtype} {path}: {m_}")
                key = f"{str(dtype)[6:]} {path}"
                worst[key] = max(worst.get(key, 0.0), err)
                say(f"  {str(dtype)[6:]:>8} {path:<5} {name:<31} {str(case):<40} "
                    f"max|err| {err:.2e} (tol {tol:g})")
    return worst


# ---------------------------------------------------------------- phase 7


def device_rows(torch, prof):
    """(ms, count, name) of each kernel the profiler saw on the card: device
    rows only (the kernels themselves), so nothing counts twice."""
    return sorted(((e.device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)


def profile_call(torch, what, fn, share_of=()):
    """Wall time of one warm call against the card's busy time in it (and
    the share of that time in kernels whose name holds each of ``share_of``
    after no letter: ``gmm_ffma_kernel`` is not ``tgmm_ffma_kernel``).
    Returns the wall ms, busy ms and kernel launches."""
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
        return {"wall_ms": wall_ms, "busy_ms": None, "launches": None}
    share = ""
    for name in share_of:
        ms = sum(r[0] for r in rows if re.search(r"(?<![A-Za-z_])" + re.escape(name), r[2]))
        share += f"; {name} {ms:.2f} ms ({100 * ms / busy_ms:.1f} % of busy)"
    say(f"  {what}: wall {wall_ms:.2f} ms, card busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / wall_ms:.1f} %), {sum(r[1] for r in rows)} kernel launches{share}")
    for ms, count, key in rows[:8]:
        say(f"    {ms:8.3f} ms  x{count:<5} {key[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "launches": sum(r[1] for r in rows)}


def run_serve(torch, cfg, counters, expected):
    """The serve path at full width: one short warm-up call, then the
    counted run of ``serve`` with its own printed lines.  Every count in
    ``counters`` is set to 0 just before the run and read just after; the
    run must show ``expected`` launches of each kernel."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch.serve import serve
    from repro_torch.models.registry import model_fns
    from repro_torch.tree import tree_leaves

    kw = dict(batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, seed=0)
    serve(cfg, decode_steps=1, log=lambda *a: None, **kw)   # warm: allocator, library handles
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for counts in (*counters, fa_ops.PATH_LAUNCHES, ssd_ops.PATH_LAUNCHES):
        for key in counts:
            counts[key] = 0
    res = serve(cfg, decode_steps=SERVE_STEPS,
                log=lambda *a: say("  " + " ".join(map(str, a))), **kw)
    launches = {k: v for counts in counters for k, v in counts.items()}
    flash_paths, ssd_paths = dict(fa_ops.PATH_LAUNCHES), dict(ssd_ops.PATH_LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    b, s = SERVE_BATCH, SERVE_PROMPT
    param_gb = sum(t.numel() * t.element_size() for t in tree_leaves(res["params"])) / 1e9
    cache, _ = model_fns(cfg).make_cache(b, s + SERVE_STEPS + 1, device="meta")
    cache_gb = sum(t.numel() * t.element_size() for t in tree_leaves(cache)) / 1e9
    say(f"  prefill {res['prefill_s']:.4f} s ({b * s / res['prefill_s']:.0f} tok/s), decode "
        f"{res['decode_s']:.4f} s ({b * SERVE_STEPS / res['decode_s']:.1f} tok/s); launches "
        f"{launches}, flash by path {flash_paths}, ssd_scan by path {ssd_paths}; weights {param_gb:.2f} GB, decode cache "
        f"{cache_gb:.2f} GB, peak allocated {peak_gb:.2f} GB")
    assert launches == expected, (launches, expected)   # every launch in the prefill
    # every served prefill computes in bf16 with 16-byte rows: all on the tensor cores
    assert flash_paths == {"ffma": 0, "wgmma": launches["flash_attention"]}, flash_paths
    assert ssd_paths == {"ffma": 0, "wgmma": launches["ssd_scan"]}, ssd_paths
    launches["flash_attention_by_path"] = flash_paths
    launches["ssd_scan_by_path"] = ssd_paths
    tokens = res["tokens"]
    assert tokens.shape == (b, SERVE_STEPS + 1), tokens.shape
    assert int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab_size
    for lg in res["logits"]:
        assert lg.shape == (b, cfg.vocab_size) and torch.isfinite(lg.float()).all()
    return res, launches


def profile_serve(torch, cfg, res, kernels):
    """Card busy share of one prefill and of one decode step, with the
    kernels that take the time (and the share of each of ``kernels``)."""
    from repro_torch.models.registry import model_fns

    fns = model_fns(cfg.replace(**KERNEL_ROUTES))
    batch = {"tokens": res["prompts"], "cache_len": SERVE_PROMPT + SERVE_STEPS + 1}
    with torch.no_grad():
        profile_call(torch, "one prefill (4 x 2048 tokens)",
                     lambda: fns.prefill(res["params"], batch), share_of=kernels)
        _, cache = fns.prefill(res["params"], batch)
        step = {"token": res["tokens"][:, 0], "pos": SERVE_PROMPT}
        profile_call(torch, "one decode step (batch 4)", lambda: fns.decode(res["params"], cache, step),
                     share_of=kernels)


# ---------------------------------------------------------------- phase 8


def rel_norm(got, want):
    """‖got − want‖ / ‖want‖, in f32."""
    return float((got.float() - want.float()).norm() / want.float().norm())


def teacher_forced_logits(torch, cfg, params, prompts, tokens):
    """Last-token logits of the prefill, then of each decode step fed the
    served tokens; and the cache after the last of them."""
    from repro_torch.models.registry import model_fns

    fns = model_fns(cfg)
    s, steps = prompts.shape[1], tokens.shape[1] - 1
    with torch.no_grad():
        logits, cache = fns.prefill(params, {"tokens": prompts, "cache_len": s + steps + 1})
        out = [logits]
        for i in range(steps):
            logits, cache = fns.decode(params, cache, {"token": tokens[:, i], "pos": s + i})
            out.append(logits)
    return out, cache


def roll_kv(torch, real):
    """The flash kernel fed K/V rolled by one position: each query also sees the next key."""
    def rolled(q, k, v, *a, **kw):
        return real(q, torch.roll(k, -1, dims=1), torch.roll(v, -1, dims=1), *a, **kw)
    return rolled


def roll_ssd(torch, real):
    """The SSD scan fed x, dt, B and C rolled by one position along L."""
    def rolled(x, dt, a, b_mat, c_mat, **kw):
        x, dt, b_mat, c_mat = (torch.roll(t, -1, dims=1) for t in (x, dt, b_mat, c_mat))
        return real(x, dt, a, b_mat, c_mat, **kw)
    return rolled


def roll_rglru(torch, real):
    """The RG-LRU scan fed log_a and b rolled by one position along L."""
    def rolled(log_a, b, **kw):
        return real(torch.roll(log_a, -1, dims=1), torch.roll(b, -1, dims=1), **kw)
    return rolled


def final_states(cache):
    """The recurrent layers' final states in a prefill cache (SSM state, RG-LRU h)."""
    from repro_torch.tree import tree_flatten_with_path

    return [t for path, t in tree_flatten_with_path(cache)
            if path.endswith("ssm/ssm") or path.endswith("lru/h")]


def serve_twin(torch, cfg, res, plain_routes, control, control_f32=None, floor_routes=None):
    """The served logits against the same prefill and decode with
    ``plain_routes`` (the plain versions) on the card, as ‖kernel − plain‖ /
    ‖plain‖; then the kernels fed the ``control``'s rolled inputs must fail
    the same limit.  The prefill again in f32 compute, held to a tighter
    limit, with ``control_f32`` (default: the same control), and with it the
    final states of the recurrent layers as they enter the decode cache.
    A control is (what, [(module, attribute, roll), ...]).

    With ``floor_routes`` (plain versions that differ from ``plain_routes``
    only in the order of their sums) the bf16 run is also read plain
    against plain: the metric's floor, which no kernel can move.  Where
    the floor itself reaches the bf16 limit the model amplifies rounding
    past it, and the bf16 readings are reported as a miss, not asserted;
    the bf16 limit is then held layer by layer (``layer_twin``)."""
    kernel_cfg = cfg.replace(**KERNEL_ROUTES)
    plain_cfg = kernel_cfg.replace(**plain_routes)

    def rel_all(got, want):
        num = sum(float((a.float() - b.float()).norm()) ** 2 for a, b in zip(got, want))
        den = sum(float(b.float().norm()) ** 2 for b in want)
        return math.sqrt(num / den)

    def readings(over, tokens, patches):
        args = (res["params"], res["prompts"], tokens)
        plain, plain_cache = teacher_forced_logits(torch, plain_cfg.replace(**over), *args)
        kernel, kernel_cache = ((res["logits"], None) if tokens is res["tokens"] else
                                teacher_forced_logits(torch, kernel_cfg.replace(**over), *args))
        with contextlib.ExitStack() as stack:
            for module, attr, roll in patches:
                stack.enter_context(
                    mock.patch.object(module, attr, roll(torch, getattr(module, attr))))
            wrong, wrong_cache = teacher_forced_logits(torch, kernel_cfg.replace(**over), *args)
        states = ()
        if kernel_cache is not None and final_states(plain_cache):
            want = final_states(plain_cache)
            states = (rel_all(final_states(kernel_cache), want),
                      rel_all(final_states(wrong_cache), want))
        return ([rel_norm(a, b) for a, b in zip(kernel, plain)],
                [rel_norm(a, b) for a, b in zip(wrong, plain)], plain, states)

    what, patches = control
    what32, patches32 = control_f32 or control
    sound, control_r, plain, _ = readings({}, res["tokens"], patches)
    agree = float(torch.stack([torch.argmax(p, -1) == t for p, t in
                               zip(plain, res["tokens"].unbind(1))]).float().mean())
    say(f"  bf16 compute, kernel against plain: last-token logits {sound[0]:.3e}, decode "
        f"steps {min(sound[1:]):.3e} .. {max(sound[1:]):.3e} (max {max(sound):.3e}); "
        f"greedy tokens agreeing {100 * agree:.2f} %")
    say(f"  bf16 compute, {what}: last-token logits {control_r[0]:.3e}, decode steps "
        f"{min(control_r[1:]):.3e} .. {max(control_r[1:]):.3e} (max {max(control_r):.3e}); "
        f"limit relative {SERVE_TWIN_REL_TOL:g}")
    bf16_asserted = True
    if floor_routes:
        floor, _ = teacher_forced_logits(torch, plain_cfg.replace(**floor_routes),
                                         res["params"], res["prompts"], res["tokens"])
        floor = [rel_norm(a, b) for a, b in zip(floor, plain)]
        say(f"  bf16 compute, plain against plain ({floor_routes}, the metric's floor): "
            f"last-token logits {floor[0]:.3e}, decode steps {min(floor[1:]):.3e} .. "
            f"{max(floor[1:]):.3e} (max {max(floor):.3e})")
        if max(floor) >= SERVE_TWIN_REL_TOL:
            bf16_asserted = False
            say(f"  bf16 compute: end-to-end limit {SERVE_TWIN_REL_TOL:g} MISSED: kernel against "
                f"plain {max(sound):.3e}, {what} {max(control_r):.3e}, two plain versions "
                f"{max(floor):.3e}; not asserted end to end (held layer by layer below)")
    sound32, control32, _, states = readings({"compute_dtype": "float32"}, res["tokens"][:, :1],
                                             patches32)
    say(f"  f32 compute, prefill last-token logits: kernel against plain {sound32[0]:.3e}, "
        f"{what32} {control32[0]:.3e} (limit relative {SERVE_TWIN_F32_REL_TOL:g})")
    if states:
        say(f"  f32 compute, final states entering the decode cache: kernel against plain "
            f"{states[0]:.3e}, {what32} {states[1]:.3e} "
            f"(limit relative {SERVE_TWIN_F32_REL_TOL:g})")
    if bf16_asserted:
        assert max(sound) < SERVE_TWIN_REL_TOL, sound
        assert max(control_r) > SERVE_TWIN_REL_TOL, control_r
    assert sound32[0] < SERVE_TWIN_F32_REL_TOL, sound32
    assert control32[0] > SERVE_TWIN_F32_REL_TOL, control32
    if states:
        assert states[0] < SERVE_TWIN_F32_REL_TOL and states[1] > SERVE_TWIN_F32_REL_TOL, states


def layer_twin(torch, cfg, res, module, attr, plain, roll, tols, n_layers):
    """Every layer's scan in the served prefill through the kernel and
    through ``plain`` on the inputs the kernel saw there, so no layer's
    difference is carried into the next: relative norms of y and of the
    final state within ``tols[compute dtype]`` = (y, state), the kernel
    checks' own (phases 10 and 11); the kernel fed those inputs rolled by
    one position along L must exceed both, layer by layer."""
    from repro_torch.models.registry import model_fns

    real = getattr(module, attr)
    rolled = roll(torch, real)
    rows = []

    def compare(*args, **kw):
        got = real(*args, **kw)
        want, wrong = plain(*args), rolled(*args, **kw)
        rows.append([(rel_norm(g, w), rel_norm(r, w)) for g, r, w in zip(got, wrong, want)])
        return got

    for cd, (tol_y, tol_s) in tols.items():
        rows.clear()
        with torch.no_grad(), mock.patch.object(module, attr, compare):
            model_fns(cfg.replace(compute_dtype=cd, **KERNEL_ROUTES)).prefill(
                res["params"], {"tokens": res["prompts"]})
        (y_sound, y_wrong), (s_sound, s_wrong) = ([max(r[i][0] for r in rows), min(r[i][1] for r in rows)]
                                                  for i in (0, 1))
        say(f"  {cd} compute, each of {len(rows)} layers' scans on its own served inputs: kernel "
            f"against plain y {y_sound:.3e}, final state {s_sound:.3e} (largest); inputs rolled "
            f"by one y {y_wrong:.3e}, final state {s_wrong:.3e} (smallest); limits y {tol_y:g}, "
            f"state {tol_s:g}")
        assert len(rows) == n_layers, len(rows)
        assert y_sound < tol_y and s_sound < tol_s, (cd, y_sound, s_sound)
        assert y_wrong > tol_y and s_wrong > tol_s, (cd, y_wrong, s_wrong)


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


def time_flash(torch, fa_ops, fa_ref, shape):
    """The kernel at a serve shape on each path (wgmma and ffma in bf16,
    ffma in f32) beside its plain version, the library's attention and the
    least time the card could take."""
    b, sq, skv, hq, hk, d, causal, window = shape
    q, k, v = flash_inputs(torch, shape, torch.bfloat16, seed=3)
    q32, k32, v32 = (t.float() for t in (q, k, v))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))   # (B, H, S, D)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # at these shapes the window (if any) covers every causal key: the library's causal mask is the same
    assert window is None or window >= skv
    assert fa_ops.choose_path(q, k, v) == "wgmma"
    row = {
        "path": "wgmma",
        "ms": median_ms(torch, lambda: fa_ops.flash_attention(q, k, v, window=window)),
        "ffma_bf16_ms": median_ms(torch, lambda: fa_ops.flash_attention(q, k, v, window=window,
                                                                       path="ffma")),
        "f32_ms": median_ms(torch, lambda: fa_ops.flash_attention(q32, k32, v32, window=window)),
        "plain_ms": median_ms(torch, lambda: fa_ref.attention_ref(q, k, v, window=window), reps=10),
        "library_ms": median_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True,
                                                    enable_gqa=hq != hk)),
    }
    pairs = live_pairs(sq, skv, causal, window)
    tq, tk = fa_ops.tiles("wgmma", d)
    visited = sum(tq * tk * max(0, end - begin) for begin, end in (
        fa_ops.kv_tiles(qt, sq, skv, causal, window, tq, tk) for qt in range(-(-sq // tq))))
    flops = 4 * b * hq * d * pairs                     # q·k and p·v on each live pair
    io_bytes = 2 * (2 * b * sq * hq * d + 2 * b * skv * hk * d)   # q, o, k, v in bf16
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, io_bytes / HBM_BYTES_PER_S * 1e3
    row.update(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
               f32_bound_ms=flops / F32_FLOPS * 1e3, visited_over_live=visited / pairs,
               tflops={k: flops / row[k] / 1e9 for k in ("ms", "ffma_bf16_ms", "f32_ms", "library_ms")})
    tf = row["tflops"]
    say(f"  flash_attention B={b} S={sq} Hq={hq} Hk={hk} D={d} causal window={window}: bf16 wgmma "
        f"{row['ms']:.4f} ms ({tf['ms']:.1f} TFLOP/s), bf16 ffma {row['ffma_bf16_ms']:.4f} ms "
        f"({tf['ffma_bf16_ms']:.1f}), f32 ffma {row['f32_ms']:.4f} ms ({tf['f32_ms']:.1f}); plain "
        f"{row['plain_ms']:.4f} ms; library (scaled_dot_product_attention, bf16) "
        f"{row['library_ms']:.4f} ms ({tf['library_ms']:.1f}); bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}: {flops / 1e9:.2f} GFLOP at 989 TFLOP/s, {io_bytes / 1e6:.1f} MB at "
        f"3.35 TB/s); f32 at the FFMA rate {row['f32_bound_ms']:.4f} ms; the wgmma path's "
        f"{tq} x {tk} tiles visit {row['visited_over_live']:.3f} x the live pairs; wgmma / bound "
        f"{row['ms'] / row['bound_ms']:.2f}, wgmma / library {row['ms'] / row['library_ms']:.2f}")
    return row


# ---------------------------------------------------------------- phases 10, 11


def ssd_inputs(torch, case, dtype, seed=0, strong=False):
    """x, B, C in ``dtype``; dt = softplus(normal) and a = -exp(normal) in
    f32 (strong: a = -exp(normal + 2))."""
    b, l, h, p, g, n = case
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    return (rnd(b, l, h, p).to(dtype), torch.nn.functional.softplus(rnd(b, l, h)),
            -torch.exp(rnd(h) + (2.0 if strong else 0.0)), rnd(b, l, g, n).to(dtype),
            rnd(b, l, g, n).to(dtype))


def check_ssd(torch, ssd_ops, ssd_ref):
    """The SSD kernel against the step recurrence on the card, every case on
    each path that takes it (f32: ffma; bf16: wgmma where N > 32, and ffma), as
    tests/test_kernels.py holds the Pallas kernel: relative norms of y and
    of the final state within 2e-5 (f32) or 2e-2 (bf16); below the serve
    shape also the state elementwise and y elementwise where N <= 32 (above
    that one read-out sums N products, and an element that cancels carries
    the rounding of those terms).  Returns the largest error of y for each
    dtype and path."""
    worst = {}
    for dtype, tol, dtype_paths in ((torch.float32, 2e-5, ("ffma",)),
                                    (torch.bfloat16, 2e-2, ("wgmma", "ffma"))):
        for name, case, strong in SSD_CASES:
            paths = dtype_paths if case[-1] > 32 else ("ffma",)
            args = ssd_inputs(torch, case, dtype, strong=strong)
            assert ssd_ops.choose_path(args[0], args[3], args[4]) == paths[0], name
            want_y, want_st = ssd_ref.ssd_sequential(*args)
            for path in paths:
                before = dict(ssd_ops.PATH_LAUNCHES)
                y, st = ssd_ops.ssd(*args, chunk=SSD_CHUNK, impl="pallas", path=path)
                torch.cuda.synchronize()
                assert ssd_ops.PATH_LAUNCHES == {**before, path: before[path] + 1}, name
                assert y.shape == want_y.shape and y.dtype == want_y.dtype == dtype, name
                assert st.shape == want_st.shape and st.dtype == torch.float32, name
                assert torch.isfinite(y.float()).all() and torch.isfinite(st).all(), name
                ry, rs = rel_norm(y, want_y), rel_norm(st, want_st)
                err = float((y.float() - want_y.float()).abs().max())
                # max |got - want| / (tol + tol |want|): above 1 an elementwise hold fails
                ey, es = (float(((g_.float() - w_.float()).abs() / (tol + tol * w_.float().abs())).max())
                          for g_, w_ in ((y, want_y), (st, want_st)))
                say(f"  {str(dtype)[6:]:>8} {path:<5} {name:<28} {str(case):<28} y rel {ry:.2e} "
                    f"max|err| {err:.2e} elementwise {ey:.2f}, state rel {rs:.2e} elementwise "
                    f"{es:.2f} (tol {tol:g})")
                assert ry < tol and rs < tol, (name, dtype, path, ry, rs)
                if case != SSD_SERVE_SHAPE:
                    torch.testing.assert_close(st, want_st, rtol=tol, atol=tol)
                    if case[-1] <= 32:
                        torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
                key = f"{str(dtype)[6:]} {path}"
                worst[key] = max(worst.get(key, 0.0), err)
    return worst


def rglru_inputs(torch, case, dtype, seed=0):
    """log_a = -softplus(normal) in f32, b normal in ``dtype``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    log_a = -torch.nn.functional.softplus(torch.randn(case, generator=gen, device="cuda"))
    return log_a, torch.randn(case, generator=gen, device="cuda").to(dtype)


def check_rglru(torch, lru_ops, lru_ref):
    """The RG-LRU kernel against the step recurrence on the card, as
    tests/test_kernels.py holds the Pallas kernel: y within 2e-5 (f32) or
    2e-2 (bf16), the final state within 1e-4.  Returns the largest f32
    error of y."""
    worst = 0.0
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for name, case in RGLRU_CASES:
            log_a, b = rglru_inputs(torch, case, dtype)
            y, h = lru_ops.rglru_scan(log_a, b, impl="pallas")
            want_y, want_h = lru_ref.rglru_sequential(log_a, b)
            torch.cuda.synchronize()
            assert y.shape == want_y.shape and y.dtype == want_y.dtype == dtype, name
            assert h.dtype == torch.float32 and torch.isfinite(y.float()).all(), name
            err = float((y.float() - want_y.float()).abs().max())
            say(f"  {str(dtype)[6:]:>8} {name:<32} {str(case):<18} y rel {rel_norm(y, want_y):.2e} "
                f"max|err| {err:.2e}, h rel {rel_norm(h, want_h):.2e} (tol {tol:g}, h 1e-4)")
            torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
            torch.testing.assert_close(h, want_h, rtol=1e-4, atol=1e-4)
            if dtype == torch.float32:
                worst = max(worst, err)
    return worst


# ---------------------------------------------------------------- phase 16


def time_scans(torch, ssd_ops, ssd_ref, lru_ops, lru_ref):
    """Each scan kernel at its serve shape beside its plain version and the
    least time the card could take.  No single PyTorch call computes either
    scan, so neither has a library time."""
    rows = {}
    b, l, h, p, g, n = SSD_SERVE_SHAPE
    args = ssd_inputs(torch, SSD_SERVE_SHAPE, torch.bfloat16, seed=4)
    args32 = [t.float() for t in args]
    io_bytes = 2 * (2 * b * l * h * p + 2 * b * l * g * n) + 4 * (b * l * h + h + b * h * p * n)
    flops = 5 * b * l * h * p * n   # per step and head: decay, dt·x·Bᵀ into the state, S·C out
    assert ssd_ops.choose_path(args[0], args[3], args[4]) == "wgmma"
    rows["ssd_scan"] = {
        "path": "wgmma",
        "ms": median_ms(torch, lambda: ssd_ops.ssd(*args, impl="pallas")),
        "ffma_bf16_ms": median_ms(torch, lambda: ssd_ops.ssd(*args, impl="pallas", path="ffma")),
        "f32_ms": median_ms(torch, lambda: ssd_ops.ssd(*args32, impl="pallas")),
        "plain_ms": median_ms(torch, lambda: ssd_ref.ssd_chunked(*args, chunk=SSD_CHUNK), reps=10),
        "bytes": io_bytes, "flops": flops,
    }
    # the tensor-core work the wgmma path issues for each q-row chunk of each
    # (b, h), with P and N padded to the block's pm and nm (L·x twice: L
    # goes in as bf16 hi + lo)
    q, pm, nm = (ssd_ops.library().repro_ssd_scan_wgmma_tile(i) for i in range(3))
    per_chunk = 2 * (q * q * nm          # G = C·Bᵀ
                     + q * pm * nm       # C·S_inᵀ
                     + 2 * q * pm * q    # L·x
                     + pm * nm * q)      # (x∘w)ᵀ·B
    issued = b * h * -(-l // q) * per_chunk
    r = rows["ssd_scan"]
    bytes32 = io_bytes + 2 * (2 * b * l * h * p + 2 * b * l * g * n)   # x, B, C in and y out in f32
    by_path = {"bfloat16 wgmma": (r["ms"], io_bytes), "bfloat16 ffma": (r["ffma_bf16_ms"], io_bytes),
               "float32 ffma": (r["f32_ms"], bytes32)}
    t_bound = max(io_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    r["by_path"] = {k: {"ms": ms, "tflops": flops / ms / 1e9, "tb_per_s": nbytes / ms / 1e9,
                        "over_bound": ms / t_bound} for k, (ms, nbytes) in by_path.items()}
    for k, v in r["by_path"].items():
        say(f"  ssd_scan {SSD_SERVE_SHAPE} {k}: {v['ms']:.4f} ms, {v['tflops']:.2f} TFLOP/s of the "
            f"recurrence's {flops / 1e9:.2f} GFLOP, {v['tb_per_s']:.3f} TB/s, kernel / bound "
            f"{v['over_bound']:.2f}")
    say(f"  ssd_scan wgmma path: {issued / 1e9:.2f} GFLOP issued to the tensor cores "
        f"({issued / r['ms'] / 1e9:.1f} TFLOP/s)")
    log_a, bx = rglru_inputs(torch, RGLRU_SERVE_SHAPE, torch.float32, seed=5)
    io_bytes = 4 * 3 * log_a.numel() + 4 * b * RGLRU_SERVE_SHAPE[2]   # log_a, b in; y, h out (f32)
    rows["rglru_scan"] = {
        "ms": median_ms(torch, lambda: lru_ops.rglru_scan(log_a, bx, impl="pallas")),
        "plain_ms": median_ms(torch, lambda: lru_ref.rglru_associative(log_a, bx), reps=10),
        "bytes": io_bytes, "flops": 2 * log_a.numel(),
    }
    for name, r in rows.items():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["flops"] / BF16_FLOPS * 1e3 if name == "ssd_scan" else r["flops"] / F32_FLOPS * 1e3
        r.update(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                 ffma_ms=r["flops"] / F32_FLOPS * 1e3, library_ms=None)
        extra = (f" (bf16 ffma {r['ffma_bf16_ms']:.4f} ms, f32 ffma {r['f32_ms']:.4f} ms)"
                 if "f32_ms" in r else "")
        say(f"  {name} {SSD_SERVE_SHAPE if name == 'ssd_scan' else RGLRU_SERVE_SHAPE}: "
            f"{r['ms']:.4f} ms{extra}; plain {r['plain_ms']:.4f} ms; library null (no single "
            f"PyTorch call); bound {r['bound_ms']:.4f} ms ({r['bound_by']}: {r['bytes'] / 1e6:.1f} MB "
            f"at 3.35 TB/s, {r['flops'] / 1e9:.2f} GFLOP; at the f32 FFMA rate "
            f"{r['ffma_ms']:.4f} ms); kernel / bound {r['ms'] / r['bound_ms']:.1f}")
    return rows


# ---------------------------------------------------------------- phase 17


def moe_splits(torch, cfg, seed=0):
    """Row splits of the expert products at olmoe's width, from the port's
    router (``route``, top-8 of 64) on normal hidden states and a router
    drawn at init scale: a 4 x 2048-token prefill, the same split with
    every fourth expert emptied into the next, and one 4-token decode step."""
    from repro_torch.models import moe

    gen = torch.Generator(device="cuda").manual_seed(seed)
    d, e = cfg.d_model, cfg.n_experts
    router = torch.randn((d, e), generator=gen, device="cuda") * 0.02

    def routed(tokens):
        _, top_i, _ = moe.route(router, torch.randn((tokens, d), generator=gen, device="cuda"), cfg)
        return torch.bincount(top_i.reshape(-1), minlength=e).to(torch.int32)

    prefill = routed(SERVE_BATCH * SERVE_PROMPT)
    emptied = prefill.clone()
    emptied[1::4] += emptied[0::4]
    emptied[0::4] = 0
    return [("prefill, routed", prefill), ("prefill, 16 experts empty", emptied),
            ("decode step, routed", routed(SERVE_BATCH))]


def moe_products(cfg):
    """(name, K, N) of the expert products: gate/up, then down."""
    return [("wg/wu", cfg.d_model, cfg.d_ff_expert), ("wd", cfg.d_ff_expert, cfg.d_model)]


def check_moe_gmm(torch, ops, ref, cfg, splits):
    """``gmm`` against the plain per-group loop at olmoe's shapes and the
    router's splits, f32 within 2e-5 and bf16 within 2e-2.  Returns the
    largest f32 error."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = 0.0
    for name, sizes in splits:
        m, live = int(sizes.sum()), int((sizes > 0).sum())
        for prod, k, n in moe_products(cfg):
            x0 = torch.randn((m, k), generator=gen, device="cuda")
            w0 = torch.randn((cfg.n_experts, k, n), generator=gen, device="cuda") / math.sqrt(k)
            for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
                x, w = x0.to(dtype), w0.to(dtype)
                got, want = ops.gmm(x, w, sizes), ref.grouped_matmul_ref(x, w, sizes)
                torch.cuda.synchronize()
                assert got.shape == want.shape == (m, n) and got.dtype == dtype, name
                err = float((got.float() - want.float()).abs().max())
                torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                                           msg=lambda m_: f"gmm {name} {prod} {dtype}: {m_}")
                if dtype == torch.float32:
                    worst = max(worst, err)
                say(f"  {str(dtype)[6:]:>8} {name:<26} {prod:<5} M={m} K={k} N={n}, {live} of "
                    f"{cfg.n_experts} experts live ({ops.choose_path(m, k, n, cfg.n_experts, dtype)}): "
                    f"max|err| {err:.2e} (tol {tol:g})")
    # the backward's dx = dy @ wᵀ, bf16, wᵀ a view read in place (unit stride along K),
    # on both paths at the routed prefill split
    name, sizes = splits[0]
    m = int(sizes.sum())
    for prod, k, n in moe_products(cfg):
        dy = torch.randn((m, n), generator=gen, device="cuda").bfloat16()
        w = (torch.randn((cfg.n_experts, k, n), generator=gen, device="cuda") / math.sqrt(k)).bfloat16()
        want = ref.grouped_matmul_ref(dy, w.transpose(1, 2), sizes)
        for path in ("wgmma", "stream"):
            got = ops.gmm(dy, w.transpose(1, 2), sizes, path=path)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2,
                                       msg=lambda m_: f"gmm dx {name} {prod} {path}: {m_}")
            say(f"  bfloat16 {name:<26} {prod:<5} dx = dy @ wᵀ (M={m} K={n} N={k}) on {path}: "
                f"max|err| {float((got.float() - want.float()).abs().max()):.2e} (tol 0.02)")
    return worst


def check_no_host_sync(torch, ops, cfg, splits):
    """One ``gmm`` call on each path under ``torch.cuda.set_sync_debug_mode
    ("error")``: a group size read on the host would synchronize and raise."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    (_, prefill), (_, decode) = splits[0], splits[2]
    for path, sizes, dtype in (("wgmma", prefill, torch.bfloat16), ("ffma_wide", prefill, torch.float32),
                               ("ffma", decode, torch.float32), ("stream", decode, torch.bfloat16)):
        m, k, n = int(sizes.sum()), cfg.d_model, cfg.d_ff_expert
        x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
        w = torch.randn((cfg.n_experts, k, n), generator=gen, device="cuda").to(dtype)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ops.gmm(x, w, sizes, path=path)
            ops.gmm(x, w, sizes)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        say(f"  {path:<9} M={m}: no host synchronization under set_sync_debug_mode('error'), "
            f"nor on the path the wrapper picks ({ops.choose_path(m, k, n, cfg.n_experts, dtype)})")
    for path, sizes, dtype in (("wgmma", prefill, torch.bfloat16), ("ffma", prefill, torch.float32),
                               ("wgmma", decode, torch.bfloat16), ("ffma", decode, torch.bfloat16)):
        m, k, n = int(sizes.sum()), cfg.d_model, cfg.d_ff_expert
        x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
        dy = torch.randn((m, n), generator=gen, device="cuda").to(dtype)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ops.tgmm(x, dy, sizes, cfg.n_experts, path=path)
            ops.tgmm(x, dy, sizes, cfg.n_experts)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        say(f"  tgmm {path:<5} {str(dtype)[6:]:>8} M={m}: no host synchronization under "
            f"set_sync_debug_mode('error'), nor on the path the wrapper picks "
            f"({ops.choose_tgmm_path(m, k, n, cfg.n_experts, dtype)})")


def time_moe_gmm(torch, ops, ref, cfg, splits):
    """``gmm`` at olmoe's routed prefill and decode splits (median of CUDA
    events, on a schedule made beforehand; the wrapper with its schedule
    beside it) against the plain loop, ``torch._grouped_mm`` and the least
    time the card could take: the weights of the live experts only, since an
    empty expert's weights need not be read."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = {}
    for name, sizes in (splits[0], splits[2]):
        m, live, g = int(sizes.sum()), int((sizes > 0).sum()), cfg.n_experts
        ends = torch.cumsum(sizes, 0, dtype=torch.int32)
        bounds = ops.row_bounds(sizes, m)
        reps = 10 if m > 1024 else 50
        for prod, k, n in moe_products(cfg):
            x = torch.randn((m, k), generator=gen, device="cuda")
            w = torch.randn((g, k, n), generator=gen, device="cuda") / math.sqrt(k)
            xb, wb = x.bfloat16(), w.bfloat16()
            y, yb = torch.empty((m, n), device="cuda"), torch.empty((m, n), device="cuda").bfloat16()
            paths = {d: ops.choose_path(m, k, n, g, d) for d in (torch.bfloat16, torch.float32)}
            prefix = {d: None if p == "stream" else ops.tile_prefix(bounds, ops.PATHS[p][1])
                      for d, p in paths.items()}
            row = {
                "M": m, "K": k, "N": n, "G": g, "live_experts": live,
                "path": paths[torch.bfloat16], "f32_path": paths[torch.float32],
                "ms": median_ms(torch, lambda: ops.launch_gmm(
                    paths[torch.bfloat16], xb, wb, bounds, prefix[torch.bfloat16], yb), reps=reps, warm=2),
                "wrapper_ms": median_ms(torch, lambda: ops.gmm(xb, wb, sizes), reps=reps, warm=2),
                "f32_ms": median_ms(torch, lambda: ops.launch_gmm(
                    paths[torch.float32], x, w, bounds, prefix[torch.float32], y), reps=reps, warm=2),
                "plain_ms": median_ms(torch, lambda: ref.grouped_matmul_ref(xb, wb, sizes),
                                      reps=reps, warm=2),
                "library_ms": (median_ms(torch, lambda: torch._grouped_mm(xb, wb, offs=ends),
                                         reps=reps, warm=2)
                               if hasattr(torch, "_grouped_mm") else None),
            }
            flops = 2 * m * k * n
            io_bytes = 2 * (m * k + live * k * n + m * n) + 4 * (g + 1)
            t_ops, t_bytes = flops / BF16_FLOPS * 1e3, io_bytes / HBM_BYTES_PER_S * 1e3
            row.update(bound_ms=max(t_ops, t_bytes),
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       ffma_ms=flops / F32_FLOPS * 1e3,
                       gb_per_s=io_bytes / row["ms"] / 1e6, tflop_per_s=flops / row["ms"] / 1e9)
            rows[(name, prod)] = row
            lib_ms = row["library_ms"]
            say(f"  gmm {name:<20} {prod:<5} M={m} K={k} N={n} ({live} experts live): "
                f"{row['ms']:.4f} ms bf16 ({row['path']}; wrapper with its schedule "
                f"{row['wrapper_ms']:.4f} ms), {row['f32_ms']:.4f} ms f32 ({row['f32_path']}); plain "
                f"{row['plain_ms']:.4f} ms; library (torch._grouped_mm, bf16) "
                f"{'null' if lib_ms is None else f'{lib_ms:.4f} ms'}; bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}: {flops / 1e9:.2f} GFLOP at 989 TFLOP/s, {io_bytes / 1e6:.1f} MB "
                f"at 3.35 TB/s); at the f32 FFMA rate {row['ffma_ms']:.4f} ms; achieved "
                f"{row['gb_per_s']:.1f} GB/s, {row['tflop_per_s']:.1f} TFLOP/s; kernel / bound "
                f"{row['ms'] / row['bound_ms']:.2f}"
                + (f", kernel / library {row['ms'] / lib_ms:.2f}" if lib_ms else ""))
    return rows


def check_moe_tgmm(torch, ops, ref, cfg, splits):
    """``tgmm`` in bf16 on its ``wgmma`` path at olmoe's expert products on
    the routed prefill split and, for the gate/up product, the split with 16
    experts empty (their dw exact zeros), against the plain per-group loop
    within 2e-2.  Returns the largest error."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    worst, g = 0.0, cfg.n_experts
    for (name, sizes), products in ((splits[0], moe_products(cfg)),
                                    (splits[1], moe_products(cfg)[:1])):
        m = int(sizes.sum())
        for prod, k, n in products:
            x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
            dy = torch.randn((m, n), generator=gen, device="cuda").bfloat16()
            got = ops.tgmm(x, dy, sizes, g, path="wgmma")
            want = ref.tgmm_ref(x, dy, sizes, g).float()
            torch.cuda.synchronize()
            assert got.shape == (g, k, n) and got.dtype == torch.bfloat16, name
            torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2,
                                       msg=lambda m_: f"tgmm {name} {prod}: {m_}")
            for gi in (sizes == 0).nonzero().flatten().tolist():
                assert not got[gi].any(), (name, gi)
            err = float((got.float() - want).abs().max())
            worst = max(worst, err)
            say(f"  bfloat16 {name:<26} {prod:<5} tgmm x ({m}, {k}) dy ({m}, {n}) on wgmma: "
                f"max|err| {err:.2e} (tol 0.02), {int((sizes == 0).sum())} empty experts' dw zero")
            del x, dy, got, want
    return worst


def time_moe_tgmm(torch, ops, ref, cfg, splits):
    """``tgmm`` in bf16 at olmoe's routed prefill split on ``wgmma`` (on bounds
    made beforehand; the wrapper with its schedule beside it) against the
    plain loop, ``torch._grouped_mm`` and the least time the card could take
    (274.9 GFLOP a product at 989 TFLOP/s, against 671 MB at 3.35 TB/s)."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    name, sizes = splits[0]
    m, g = int(sizes.sum()), cfg.n_experts
    ends = torch.cumsum(sizes, 0, dtype=torch.int32)
    bounds = ops.row_bounds(sizes, m)
    rows = {}
    for prod, k, n in moe_products(cfg):
        x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        dy = torch.randn((m, n), generator=gen, device="cuda").bfloat16()
        dw = torch.empty((g, k, n), device="cuda", dtype=torch.bfloat16)
        path = ops.choose_tgmm_path(m, k, n, g, torch.bfloat16)
        assert path == "wgmma", path
        lib_ms, lib_note = grouped_mm_ms(torch, x.t(), dy, ends)
        row = {"M": m, "K": k, "N": n, "G": g, "path": path,
               "ms": median_ms(torch, lambda: ops.launch_tgmm(path, x, dy, bounds, dw),
                               reps=10, warm=2),
               "wrapper_ms": median_ms(torch, lambda: ops.tgmm(x, dy, sizes, g), reps=10, warm=2),
               "plain_ms": median_ms(torch, lambda: ref.tgmm_ref(x, dy, sizes, g), reps=5, warm=1),
               "library_ms": lib_ms}
        flops = 2 * m * k * n
        io_bytes = 2 * (m * k + m * n + g * k * n) + 4 * (g + 2)
        t_ops, t_bytes = flops / BF16_FLOPS * 1e3, io_bytes / HBM_BYTES_PER_S * 1e3
        row.update(bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   tflop_per_s=flops / row["ms"] / 1e9)
        rows[f"{name}, {prod}"] = row
        say(f"  tgmm {name:<16} {prod:<5} x ({m}, {k}) dy ({m}, {n}), {g} experts: "
            f"{row['ms']:.4f} ms ({path}; wrapper with its schedule {row['wrapper_ms']:.4f} ms); "
            f"plain {row['plain_ms']:.4f} ms; library (torch._grouped_mm, bf16) "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f} ms'}{f' ({lib_note})' if lib_note else ''}; "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}: {flops / 1e9:.2f} GFLOP at 989 "
            f"TFLOP/s, {io_bytes / 1e6:.1f} MB at 3.35 TB/s); achieved {row['tflop_per_s']:.1f} "
            f"TFLOP/s; kernel / bound {row['ms'] / row['bound_ms']:.2f}"
            + (f", kernel / library {row['ms'] / lib_ms:.2f}" if lib_ms else ""))
        del x, dy, dw
    return rows


# ---------------------------------------------------------------- phase 19


def routed_logits(torch, cfg, res):
    """Teacher-forced logits of ``cfg`` and the top-k experts of every
    (token, layer), in call order."""
    from repro_torch.models import moe

    tops, real = [], moe.route

    def spy(*a):
        out = real(*a)
        tops.append(out[1])
        return out

    with mock.patch.object(moe, "route", spy):
        logits, _ = teacher_forced_logits(torch, cfg, res["params"], res["prompts"], res["tokens"])
    return logits, tops


def moe_twin(torch, cfg, res):
    """The served olmoe against the same prefill and teacher-forced decode
    with every expert product through the plain loop (``moe_gmm_impl=
    "dense"``).  f32 compute, end to end, within SERVE_TWIN_F32_REL_TOL,
    and the kernel fed each expert's weights at the next expert's place must
    fail it at every step.  In bf16 a token whose 8th and 9th experts nearly
    tie can be routed differently by sums in another order, so the bf16
    end-to-end reading is printed with the share of (token, layer) top-8
    sets that differ, not asserted; bf16 is held layer by layer
    (``moe_layer_twin``)."""
    from repro_torch.kernels.grouped_matmul import ops

    kernel_cfg = cfg.replace(**KERNEL_ROUTES)
    plain = {"moe_gmm_impl": "dense"}
    kernel, k_tops = routed_logits(torch, kernel_cfg, res)
    want, p_tops = routed_logits(torch, kernel_cfg.replace(**plain), res)
    sound = [rel_norm(a, b) for a, b in zip(kernel, want)]
    assert len(k_tops) == len(p_tops) == cfg.total_layers * (1 + SERVE_STEPS)
    differ = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                 for a, b in zip(k_tops, p_tops))
    sets = sum(a.shape[0] for a in k_tops)
    say(f"  bf16 compute, kernel against plain (reported, not asserted): last-token logits "
        f"{sound[0]:.3e}, decode steps {min(sound[1:]):.3e} .. {max(sound[1:]):.3e} (max "
        f"{max(sound):.3e}); (token, layer) top-{cfg.top_k} sets that differ: {differ} of {sets} "
        f"({100 * differ / sets:.3f} %)")

    f32 = kernel_cfg.replace(compute_dtype="float32")
    args = (res["params"], res["prompts"], res["tokens"])
    got, _ = teacher_forced_logits(torch, f32, *args)
    want, _ = teacher_forced_logits(torch, f32.replace(**plain), *args)
    real = ops.grouped_matmul
    with mock.patch.object(ops, "grouped_matmul",
                           lambda x, w, gs: real(x, torch.roll(w, -1, dims=0), gs)):
        wrong, _ = teacher_forced_logits(torch, f32, *args)
    sound32 = [rel_norm(a, b) for a, b in zip(got, want)]
    wrong32 = [rel_norm(a, b) for a, b in zip(wrong, want)]
    say(f"  f32 compute, prefill and {SERVE_STEPS} decode steps: kernel against plain max "
        f"{max(sound32):.3e} (prefill {sound32[0]:.3e}); experts' weights shifted by one "
        f"(w[g] -> w[(g + 1) % E]) min {min(wrong32):.3e} (limit relative {SERVE_TWIN_F32_REL_TOL:g})")
    assert max(sound32) < SERVE_TWIN_F32_REL_TOL, sound32
    assert min(wrong32) > SERVE_TWIN_F32_REL_TOL, wrong32
    return {"bf16_e2e": max(sound), "topk_sets_differing": differ, "topk_sets": sets,
            "f32": max(sound32), "f32_control": min(wrong32)}


def moe_layer_twin(torch, cfg, res):
    """Every layer's MoE FFN in the served bf16 prefill through the kernel
    and through the plain loop on the inputs the kernel saw there, with the
    routing computed once and shared, so no layer's difference is carried
    into the next and no routing flip enters: ‖kernel − plain‖ / ‖plain‖
    within MOE_LAYER_REL_TOL; the kernel fed the inputs rolled by one token
    (routing kept) must exceed it, layer by layer."""
    from repro_torch.models import moe
    from repro_torch.models.registry import model_fns

    real_local, real_route = moe._moe_local, moe.route
    rows = []

    def compare(router_w, wg, wu, wd, x, c, gmm_impl="ragged"):
        routing = real_route(router_w, x.reshape(-1, x.shape[-1]), c)
        with mock.patch.object(moe, "route", lambda *a: routing):
            got, aux = real_local(router_w, wg, wu, wd, x, c, gmm_impl)
            want, _ = real_local(router_w, wg, wu, wd, x, c, "dense")
            wrong, _ = real_local(router_w, wg, wu, wd, torch.roll(x, -1, dims=1), c, gmm_impl)
        rows.append((rel_norm(got, want), rel_norm(wrong, want)))
        return got, aux

    with torch.no_grad(), mock.patch.object(moe, "_moe_local", compare):
        model_fns(cfg.replace(**KERNEL_ROUTES)).prefill(res["params"], {"tokens": res["prompts"]})
    sound, wrong = max(r[0] for r in rows), min(r[1] for r in rows)
    say(f"  bf16 compute, each of {len(rows)} layers' MoE FFN on its own served inputs, routing "
        f"shared: kernel against plain {sound:.3e} (largest); inputs rolled by one token "
        f"{wrong:.3e} (smallest); limit relative {MOE_LAYER_REL_TOL:g}")
    assert len(rows) == cfg.total_layers, len(rows)
    assert sound < MOE_LAYER_REL_TOL and wrong > MOE_LAYER_REL_TOL, (sound, wrong)
    return sound


# ---------------------------------------------------------------- phases 20-22


def decode_inputs(torch, case, qdtype, seed=0, sdtype=None):
    """q (B, Hq, D) and an int8 cache of normal K/V in the model's layout
    ((B, S, Hk, D) values, (B, S, Hk) bf16 scales, or widened to
    ``sdtype``), viewed as the kernel's (B, Hk, S, D) and (B, Hk, S)."""
    from repro_torch.models.layers import quantize_kv

    b, hq, hk, s, d, _ = case
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, hq, d), generator=gen, device="cuda").to(qdtype)
    kq, ks = quantize_kv(torch.randn((b, s, hk, d), generator=gen, device="cuda"))
    vq, vs = quantize_kv(torch.randn((b, s, hk, d), generator=gen, device="cuda"))
    ks, vs = (t.to(sdtype or t.dtype) for t in (ks, vs))
    return q, kq.transpose(1, 2), vq.transpose(1, 2), ks.transpose(1, 2), vs.transpose(1, 2)


def check_decode(torch, decode_ops, decode_ref):
    """The int8 decode kernel against its plain version on the card within
    1e-5, the reference's tolerance (tests/test_kernels.py:192), one launch
    a call.  Returns the largest error."""
    b, hq, hk, s, d = DECODE_EDGE
    chunk = decode_ops.split_len(b, hk, s, decode_ops.cluster_fit(0, hq // hk, d))
    edge = (-(-s // chunk) - 1) * chunk
    assert edge > 0, chunk
    cases = DECODE_CASES + [(f"qwen heads S={s}, kv_len {kv} (split edge{past})", (b, hq, hk, s, d, kv))
                            for kv, past in ((edge, ""), (edge + 1, " + 1"))]
    worst = 0.0
    for qdtype, sdtype in itertools.product((torch.float32, torch.bfloat16),
                                            (torch.bfloat16, torch.float32)):
        for name, case in cases:
            args = decode_inputs(torch, case, qdtype, sdtype=sdtype)
            before = decode_ops.LAUNCHES["flash_decode_int8"]
            got = decode_ops.flash_decode_int8(*args, kv_len=case[-1])
            assert decode_ops.LAUNCHES["flash_decode_int8"] == before + 1, name
            want = decode_ref.flash_decode_int8_ref(*args, kv_len=case[-1])
            torch.cuda.synchronize()
            assert got.shape == want.shape and got.dtype == torch.float32, name
            err = float((got - want).abs().max())
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                       msg=lambda m_: f"flash_decode_int8 {name} {qdtype}: {m_}")
            worst = max(worst, err)
            say(f"  q {str(qdtype)[6:]:>8} scales {str(sdtype)[6:]:>8} {name:<40} {str(case):<32} "
                f"max|err| {err:.2e} (tol 1e-5)")
    return worst


def capture_decode(torch, steps, caps):
    """Wrap ``blocks._attn_decode``: at the decode positions in ``steps``,
    launch the int8 decode kernel on the layer's served cache in place (just
    written with the step's K/V) with the layer's rotated query, and keep
    the query, a copy of the cache, the kernel's output and the model's own
    plain decode attention output (what ``attention_reference`` returned).
    The model goes on with its own output: no model of the reference calls
    this kernel."""
    from repro_torch.kernels.flash_attention import decode_ops
    from repro_torch.models import blocks
    from repro_torch.models import layers as L

    real_attn, real_ref = blocks._attn_decode, L.attention_reference

    def wrapped(params, x, cfg, spec, pos, cache):
        if pos not in steps:
            return real_attn(params, x, cfg, spec, pos, cache)
        seen = {}

        def spy(q, *a, **kw):
            seen["q"], seen["y"] = q, real_ref(q, *a, **kw)
            return seen["y"]

        with mock.patch.object(L, "attention_reference", spy):
            out, c = real_attn(params, x, cfg, spec, pos, cache)
        views = [c[key].transpose(1, 2) for key in ("k", "v", "k_scale", "v_scale")]
        q = seen["q"][:, 0]
        caps.append({"pos": pos, "q": q, "y": seen["y"][:, 0],
                     "kernel": decode_ops.flash_decode_int8(q, *views, kv_len=pos + 1),
                     "cache": [t.clone() for t in views]})
        return out, c

    return mock.patch.object(blocks, "_attn_decode", wrapped)


def check_served_decode(torch, decode_ops, decode_ref, caps):
    """Each captured layer's kernel output against ``decode_ref`` on the same
    cache within 1e-5 (elementwise), and against the model's own bf16 plain
    decode attention within 2e-2 (relative norm) and within bf16's rounding
    (elementwise, 2^-8 relative: the model's output is the same f32
    attention rounded to bf16).  Decode attention is invariant to a
    permutation of the cache's slots, so two controls misalign it by one
    slot: K and its scales rolled against V, and V's scales rolled against
    V.  Each must exceed 1e-5 and bf16's rounding in every layer.  Against
    the 2e-2 relative norm they are printed, not asserted: at random init
    the attention is near uniform and its output is mostly the part of V
    common to every position, which a one-slot misalignment moves by about
    as much as that limit.  Returns the largest error against
    ``decode_ref``."""
    bf16_round = dict(rtol=2.0 ** -8, atol=1e-6)
    worst = rel_max = 0.0
    controls = {
        "K and its scales rolled one slot against V":
            lambda k, v, ks, vs: (torch.roll(k, -1, dims=2), v, torch.roll(ks, -1, dims=2), vs),
        "V's scales rolled one slot against V":
            lambda k, v, ks, vs: (k, v, ks, torch.roll(vs, -1, dims=2)),
    }
    readings = {name: [math.inf, math.inf, 0.0] for name in controls}   # err, rel, sum sq
    den = 0.0
    for cap in caps:
        q, cache, kv_len = cap["q"], cap["cache"], cap["pos"] + 1
        y = cap["y"].float()
        want = decode_ref.flash_decode_int8_ref(q, *cache, kv_len=kv_len)
        torch.testing.assert_close(cap["kernel"], want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(cap["kernel"], y, **bf16_round)
        worst = max(worst, float((cap["kernel"] - want).abs().max()))
        rel_max = max(rel_max, rel_norm(cap["kernel"], y))
        den += float(y.norm()) ** 2
        for name, misalign in controls.items():
            wrong = decode_ops.flash_decode_int8(q, *misalign(*cache), kv_len=kv_len)
            assert not torch.allclose(wrong, y, **bf16_round), (name, cap["pos"])
            r = readings[name]
            r[0] = min(r[0], float((wrong - want).abs().max()))
            r[1] = min(r[1], rel_norm(wrong, y))
            r[2] += float((wrong - y).norm()) ** 2
    say(f"  {len(caps)} served caches (positions {sorted({c['pos'] for c in caps})}): kernel "
        f"against decode_ref max|err| {worst:.2e} (tol 1e-5); against the model's plain bf16 "
        f"attention {rel_max:.3e} relative (largest; limit 2e-2) and within bf16 rounding "
        f"(2^-8 relative) in every layer")
    for name, (err, rel, sq) in readings.items():
        say(f"  control, {name}: max|err| {err:.2e} (smallest layer; must exceed 1e-5), outside "
            f"bf16 rounding in every layer; relative {rel:.3e} (smallest layer), "
            f"{math.sqrt(sq / den):.3e} over all layers (printed)")
        assert err > 1e-5, (name, err)
    assert rel_max < 2e-2, rel_max
    return worst


def decode_bound(b, hq, hk, kv_len, d):
    """(bound ms, what bounds it, bytes): int8 K and V and their bf16 scales
    up to kv_len, q in bf16, out in f32 at 3.35 TB/s, against q.k and p.v
    with K and V dequantized at the f32 rate."""
    io_bytes = 2 * b * hk * kv_len * d + 2 * 2 * b * hk * kv_len + 2 * b * hq * d + 4 * b * hq * d
    flops = 4 * b * hq * kv_len * d + 2 * b * hk * kv_len * d
    t_bytes, t_ops = io_bytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", io_bytes


def time_decode_calls(torch, decode_ops, decode_ref, caches, kv_len, reps, plain_reps):
    """The kernel, its plain version and SDPA over the caches dequantized to
    bf16 beforehand (not the same function: no single PyTorch call
    dequantizes int8 and attends), each call on the next cache in turn, and
    the wrapper's host time a call."""
    (b, hq, d), hk = caches[0][0].shape, caches[0][1].shape[1]
    turn = itertools.cycle(caches)

    def kernel():
        decode_ops.flash_decode_int8(*next(turn), kv_len=kv_len)

    def plain():
        decode_ref.flash_decode_int8_ref(*next(turn), kv_len=kv_len)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(len(caches)):
        kernel()
    host_ms = (time.perf_counter() - t0) / len(caches) * 1e3
    row = {"ms": median_ms(torch, kernel, reps=reps, warm=2 * len(caches)), "host_ms": host_ms,
           "plain_ms": median_ms(torch, plain, reps=plain_reps, warm=1), "library_ms": None}
    deq = [(c[0][:, :, None, :],
            *((t[:, :, :kv_len].float() * sc[:, :, :kv_len, None].float()).bfloat16()
              for t, sc in ((c[1], c[3]), (c[2], c[4])))) for c in caches]
    dturn = itertools.cycle(deq)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row["sdpa_dequantized_ms"] = median_ms(torch, lambda: sdpa(*next(dturn), enable_gqa=hq != hk),
                                           reps=reps, warm=2 * len(caches))
    del deq
    row["bound_ms"], row["bound_by"], io_bytes = decode_bound(b, hq, hk, kv_len, d)
    row["tb_per_s"] = io_bytes / (row["ms"] * 1e-3) / 1e12
    row["mbytes"] = io_bytes / 1e6
    s = caches[0][1].shape[2]
    chunk = decode_ops.split_len(b, hk, s, decode_ops.cluster_fit(0, hq // hk, d))
    row["splits"] = -(-s // chunk)
    row["shape"] = {"B": b, "Hq": hq, "Hk": hk, "S": s, "kv_len": kv_len, "D": d}
    return row


def say_decode_row(name, row):
    sh = row["shape"]
    say(f"  flash_decode_int8 {name}: B={sh['B']} Hq={sh['Hq']} Hk={sh['Hk']} S={sh['S']} "
        f"kv_len={sh['kv_len']} D={sh['D']} (bf16 q and scales; {row['splits']} splits a cluster): "
        f"{row['ms']:.4f} ms, {row['tb_per_s']:.3f} TB/s; bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}: {row['mbytes']:.2f} MB at 3.35 TB/s), kernel / bound "
        f"{row['ms'] / row['bound_ms']:.2f}; plain {row['plain_ms']:.4f} ms; library null (no single "
        f"PyTorch call); SDPA over the cache dequantized to bf16 beforehand "
        f"{row['sdpa_dequantized_ms']:.4f} ms; the wrapper's host time a call {row['host_ms']:.4f} ms")


def time_decode(torch, decode_ops, decode_ref, caps):
    """The int8 decode kernel at qwen's last served decode step, each launch
    on the next layer's cache (24 x 17.6 MB, far past the 50 MB L2, as a
    decode step finds them), beside the launch floor as this timing reads it
    (an empty ``_sleep(0)`` and a one-element ``zero_``)."""
    last = max(c["pos"] for c in caps)
    layers = [(c["q"], *c["cache"]) for c in caps if c["pos"] == last]
    z = torch.zeros(1, device="cuda")
    floor = {"sleep0_ms": median_ms(torch, lambda: torch.cuda._sleep(0), reps=240, warm=24),
             "zero_ms": median_ms(torch, z.zero_, reps=240, warm=24)}
    row = time_decode_calls(torch, decode_ops, decode_ref, layers, last + 1, reps=240, plain_reps=24)
    row["launch_floor_ms"] = floor
    say(f"  launch floor in this timing: _sleep(0) {floor['sleep0_ms']:.4f} ms, one-element zero_ "
        f"{floor['zero_ms']:.4f} ms")
    say_decode_row("at the served decode", row)
    return row


def time_decode_long(torch, decode_ops, decode_ref):
    """The kernel at decode_32k's length (``DECODE_LONG``) on three random
    caches in the model's layout, each first held against ``decode_ref``
    (1e-5), then timed as ``time_decode`` times the served one."""
    caches = [decode_inputs(torch, DECODE_LONG, torch.bfloat16, seed=10 + i) for i in range(3)]
    kv_len = DECODE_LONG[-1]
    worst = 0.0
    for c in caches:
        got = decode_ops.flash_decode_int8(*c, kv_len=kv_len)
        want = decode_ref.flash_decode_int8_ref(*c, kv_len=kv_len)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        worst = max(worst, float((got - want).abs().max()))
        del got, want
    row = time_decode_calls(torch, decode_ops, decode_ref, caches, kv_len, reps=120, plain_reps=6)
    row["max_abs_err"] = worst
    say(f"  decode_32k length: three caches of {row['mbytes']:.1f} MB each held against decode_ref, "
        f"max|err| {worst:.2e} (tol 1e-5)")
    say_decode_row("at decode_32k's length", row)
    del caches
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------- phase 23

# the paper's other client models at its widths: (name, SmallModelConfig
# fields, dataset, optimizer, learning rate); Fig 8's CNN on CIFAR-10 with
# and without the personalization tower, Fig 9/10's residual CNN on FEMNIST,
# Fig 6/7's LSTM on SST-2 (its vocabulary, 2,048).  The residual CNN trains
# with momentum: adamw's first update is lr * sign(g), so an element whose
# gradient is rounding noise moves by 2 lr between two correct runs, and
# its cuDNN FFT / Winograd convolutions round coarser than the CPU's, so
# under adamw its twin can cross TWIN_REL_TOL (tools/torch_client_twin.py)
CLIENT_MODELS = (
    ("cnn", dict(kind="cnn", n_classes=10, hidden=64, n_layers=2, image_size=32, channels=3),
     "cifar10", "momentum", 0.05),
    ("cnn + local model", dict(kind="cnn", n_classes=10, hidden=64, n_layers=2, image_size=32,
                               channels=3, extra_local_model=True), "cifar10", "momentum", 0.05),
    ("resnet", dict(kind="resnet", n_classes=62, hidden=128, n_layers=2, image_size=28,
                    channels=1), "femnist", "momentum", 0.05),
    ("lstm", dict(kind="lstm", n_classes=2, hidden=64, n_layers=2, vocab_size=2048, seq_len=64,
                  embed_dim=64), "sst2", "adamw", 1e-3),
)
CLIENTS_N, CLIENTS_PARTICIPANTS, CLIENTS_BATCH, CLIENTS_STEPS = 64, 16, 32, 10
TWIN_CLIENTS = 4          # the clients of a round's wave held card against CPU
# phase 3's MLP world, one round under each (optimizer, weight decay, compression)
MLP_OPTIONS = (("adamw", 0.01, "none"), ("adafactor", 0.0, "none"), ("sgd", 0.0, "int8"),
               ("sgd", 0.0, "topk"))


def client_world(mcfg, dataset, n_clients=CLIENTS_N, seed=0):
    from repro_torch.core.budget import fedscale_budget_distribution
    from repro_torch.fed.trainer import build_fl_clients

    return build_fl_clients(mcfg, fedscale_budget_distribution(n_clients, seed=seed), dataset,
                            n_samples=4096, batch_size=CLIENTS_BATCH, n_batches=CLIENTS_STEPS,
                            seed=seed)


def use_optimizer(trainer, opt):
    """Swap a trainer's update rule (``FedConfig`` has no weight decay)."""
    from repro_torch.fed.client import make_small_step

    trainer.opt = trainer.batch_exec.opt = opt
    trainer.step_fn = make_small_step(trainer.mcfg, opt, trainer.fed.prox_mu)


def kind_wave(torch, mcfg, dataset, opt, cids, params, dev):
    """Each client's delta leaves (f32, on the host) after one dense wave of
    ``cids`` from ``params`` on ``dev``, on a fresh twin world."""
    from repro_torch.fed.batch_exec import BatchedExecutor
    from repro_torch.tree import tree_leaves, tree_map

    clients, _ = client_world(mcfg, dataset)
    by_id = {c.client_id: c for c in clients}
    ex = BatchedExecutor(mcfg, opt, device=dev)
    res = ex.run_wave(tree_map(lambda t: t.to(dev), params), [by_id[c] for c in cids],
                      CLIENTS_STEPS)
    assert ex.last_wave["mode"] == "dense", ex.last_wave
    return [[t.float().cpu() for t in tree_leaves(d)] for d, _, _ in res]


def nchw_flatten(torch):
    """The control: the CNN's ``fc`` fed features flattened in NCHW order
    (the reference flattens NHWC)."""
    from repro_torch.models import small

    real = small._apply_single

    def wrong(p, cfg, x):
        if cfg.kind != "cnn":
            return real(p, cfg, x)
        h = x.permute(0, 3, 1, 2)
        for conv in p["convs"]:
            h = torch.nn.functional.max_pool2d(torch.relu(small._conv_nchw(conv, h)), 2, 2)
        h = torch.relu(h.reshape(h.shape[0], -1) @ p["fc"]["w"] + p["fc"]["b"])
        return h @ p["head"]["w"] + p["head"]["b"]

    return mock.patch.object(small, "_apply_single", wrong)


def run_client_model(torch, name, fields, dataset, opt_name, lr):
    """Two rounds of ``name`` through the trainer on the card (MeasuredRuntime),
    one warm wave profiled, and the twin: TWIN_CLIENTS clients of round 2's
    wave on the card against the CPU from round 2's globals (the CNN with
    NCHW-flattened features as the control).  Returns the row PERF.md reads."""
    from repro_torch.fed.batch_exec import BatchedExecutor
    from repro_torch.fed.trainer import FedConfig, FederatedTrainer
    from repro_torch.models.small import SmallModelConfig

    mcfg = SmallModelConfig(**fields)
    clients, test = client_world(mcfg, dataset)
    fed = FedConfig(rounds=2, participants_per_round=CLIENTS_PARTICIPANTS,
                    max_parallel=CLIENTS_PARTICIPANTS, local_steps=CLIENTS_STEPS,
                    client_batching="wave", optimizer=opt_name, learning_rate=lr)
    trainer = FederatedTrainer(mcfg, clients, fed, test_batch=test)   # the card, MeasuredRuntime
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()     # what earlier phases still hold
    rounds = run_rounds(torch, trainer, fed.rounds)
    peak = torch.cuda.max_memory_allocated() - base
    stats = trainer.batch_exec.stats
    assert stats.dense_clients == stats.clients == fed.rounds * CLIENTS_PARTICIPANTS, stats
    for i, r in enumerate(rounds, 1):
        say(f"  {name} round {i}: " + json.dumps(r["rec"]))
        say(f"  {name} round {i} phase wall s: "
            + ", ".join(f"{k} {v:.4f}" for k, v in r["walls"].items()))
    last = rounds[-1]
    fresh, _ = client_world(mcfg, dataset)
    by_id = {c.client_id: c for c in fresh}
    ex = BatchedExecutor(mcfg, trainer.opt, device="cuda")
    prof = profile_call(torch, f"{name}: one warm dense wave ({len(last['cids'])} clients x "
                               f"{CLIENTS_STEPS} steps x batch {CLIENTS_BATCH})",
                        lambda: ex.run_wave(last["start"], [by_id[c] for c in last["cids"]],
                                            CLIENTS_STEPS))
    cids = last["cids"][:TWIN_CLIENTS]
    want = kind_wave(torch, mcfg, dataset, trainer.opt, cids, last["start"], "cpu")
    sound = wave_gap(kind_wave(torch, mcfg, dataset, trainer.opt, cids, last["start"], "cuda"), want)
    line = (f"  {name} twin, {len(cids)} clients x {CLIENTS_STEPS} steps, card against CPU: "
            f"relative {sound[0]:.3e}, max abs {sound[1]:.3e}")
    wrong = None
    if mcfg.kind == "cnn" and not mcfg.extra_local_model:
        with nchw_flatten(torch):
            wrong = wave_gap(kind_wave(torch, mcfg, dataset, trainer.opt, cids, last["start"],
                                       "cuda"), want)
        line += f"; fc fed NCHW-flattened features: relative {wrong[0]:.3e}"
    say(line + f" (limit relative {TWIN_REL_TOL:g})")
    assert sound[0] < TWIN_REL_TOL, sound
    assert wrong is None or wrong[0] > TWIN_REL_TOL, wrong
    say(f"  {name}: peak memory of the rounds {peak / 1e9:.2f} GB; test loss {rounds[0]['rec']['test_loss']:.4f}"
        f" -> {last['rec']['test_loss']:.4f}")
    return {"walls": [r["walls"] for r in rounds], "profile": prof, "peak_gb": peak / 1e9,
            "twin": sound, "control": wrong}


def uniform_noise(seed, index, shape):
    """int8 rounding noise from numpy, the same on the card and the CPU."""
    import numpy as np

    return np.random.default_rng((seed, index)).random(shape, dtype=np.float32)


def check_int8_on_card(torch, mcfg, opt, cids, params):
    """The int8 payload of every client's delta from one ragged wave, made
    on the card and on the CPU from the same delta and noise: q and scale
    equal bit for bit.  Returns the leaves compared."""
    import numpy as np

    from repro_torch.fed.batch_exec import BatchedExecutor
    from repro_torch.fed.compression import compress_tree
    from repro_torch.tree import tree_leaves, tree_map

    clients, _ = build_world(mcfg)
    by_id = {c.client_id: c for c in clients}
    res = BatchedExecutor(mcfg, opt, device="cuda").run_wave(
        params, [by_id[c] for c in cids], 10, round_idx=0)
    leaves = 0
    for cid, (delta, _, _) in zip(cids, res):
        on_card = tree_leaves(compress_tree(delta, "int8", seed=cid, noise=uniform_noise))
        on_cpu = tree_leaves(compress_tree(tree_map(lambda t: t.cpu(), delta), "int8", seed=cid,
                                           noise=uniform_noise))
        for a, b in zip(on_card, on_cpu):
            assert np.array_equal(a.q, b.q) and a.scale == b.scale, cid
            leaves += 1
    return leaves


def run_mlp_options(torch, ops, mcfg):
    """Phase 3's MLP world, one round under each of MLP_OPTIONS, with the
    counts zeroed before each round and read after it; the adafactor wave
    against its clients trained one by one; int8 on the card against the
    CPU; comm_bytes against the wire bytes of what was uploaded."""
    from repro_torch.fed.client import make_small_step
    from repro_torch.fed.compression import compress_tree, tree_wire_bytes
    from repro_torch.fed.trainer import FedConfig, FederatedTrainer
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.tree import tree_leaves, tree_map

    launches, rows = {"gmm": 0, "tgmm": 0, "tgmm_by_path": dict.fromkeys(ops.TGMM_PATHS, 0)}, {}
    for opt_name, wd, comp in MLP_OPTIONS:
        key = f"{opt_name}{f' (weight decay {wd:g})' if wd else ''}, compression {comp}"
        clients, test = build_world(mcfg)
        fed = FedConfig(rounds=1, participants_per_round=32, max_parallel=32, local_steps=10,
                        client_batching="wave", optimizer=opt_name, compression=comp)
        trainer = FederatedTrainer(mcfg, clients, fed, test_batch=test)
        if wd:
            use_optimizer(trainer, make_optimizer(opt_name, fed.learning_rate, wd))
        for counts in (ops.LAUNCHES, ops.TGMM_PATH_LAUNCHES):
            for k in counts:
                counts[k] = 0
        [r] = run_rounds(torch, trainer, 1)
        got = dict(ops.LAUNCHES)
        assert got["gmm"] > 0 and got["tgmm"] > 0, (key, got)
        # the FL path runs f32: every weight gradient on tgmm's ffma path
        assert ops.TGMM_PATH_LAUNCHES["ffma"] == got["tgmm"], ops.TGMM_PATH_LAUNCHES
        assert trainer.batch_exec.stats.ragged_clients == len(r["cids"]) > 0, key
        for k in ("gmm", "tgmm"):
            launches[k] += got[k]
        for k, v in ops.TGMM_PATH_LAUNCHES.items():
            launches["tgmm_by_path"][k] += v
        row = {"walls": r["walls"], "launches": got, "completed": r["rec"]["completed"]}
        if comp != "none":
            per_client = tree_wire_bytes(compress_tree(tree_map(torch.zeros_like, trainer.params),
                                                       comp))
            assert trainer.comm_bytes == per_client * r["rec"]["completed"], (
                trainer.comm_bytes, per_client)
            row["comm_bytes"] = trainer.comm_bytes
        if opt_name == "adafactor":
            wave = wave_deltas(torch, mcfg, trainer.opt, r["cids"], r["start"], "cuda")
            seq_clients, _ = build_world(mcfg)
            by_id = {c.client_id: c for c in seq_clients}
            step = make_small_step(mcfg, trainer.opt)
            seq = [[t.float().cpu() for t in tree_leaves(by_id[c].train_local(
                r["start"], step, trainer.opt, n_steps=10)[0])] for c in r["cids"]]
            row["wave_vs_seq"] = wave_gap(wave, seq)
            say(f"  adafactor wave against its {len(seq)} clients trained one by one on the card: "
                f"relative {row['wave_vs_seq'][0]:.3e}, max abs {row['wave_vs_seq'][1]:.3e} "
                f"(limit relative {TWIN_REL_TOL:g})")
            assert row["wave_vs_seq"][0] < TWIN_REL_TOL, row["wave_vs_seq"]
        if comp == "int8":
            row["int8_leaves_equal"] = check_int8_on_card(torch, mcfg, trainer.opt, r["cids"],
                                                          r["start"])
            say(f"  int8 payload made on the card equals the CPU's, bit for bit: "
                f"{row['int8_leaves_equal']} leaves of {len(r['cids'])} clients")
        say(f"  MLP round, {key}: launches {got}; " + json.dumps(r["rec"]))
        say("    phase wall s: " + ", ".join(f"{k} {v:.4f}" for k, v in r["walls"].items()))
        rows[key] = row
    return launches, rows


def check_resume(torch, directory):
    """Two CNN rounds checkpointed every round, then a new trainer over the
    same clients restores them and runs round 3, against an uninterrupted
    3-round run: params bit for bit after the restore and after round 3,
    round, sim_clock, comm_bytes and history equal.  All 16 clients take part
    in every round and none fails (the sampling RNG is not checkpointed, as
    in the reference); FixedRuntime makes the timeline reproducible."""
    import dataclasses

    from repro_torch.core.runtime import FixedRuntime
    from repro_torch.fed.trainer import FedConfig, FederatedTrainer
    from repro_torch.models.small import SmallModelConfig
    from repro_torch.tree import tree_leaves

    _, fields, dataset, opt_name, lr = CLIENT_MODELS[0]
    mcfg = SmallModelConfig(**fields)
    fed = FedConfig(rounds=3, participants_per_round=16, max_parallel=16,
                    local_steps=CLIENTS_STEPS, client_batching="wave", optimizer=opt_name,
                    learning_rate=lr, compression="int8")
    ckpt_fed = dataclasses.replace(fed, ckpt_dir=directory, ckpt_every=1)

    def trainer(clients, test, cfg):
        return FederatedTrainer(mcfg, clients, cfg, test_batch=test, runtime=FixedRuntime(2.0, 1.0))

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True   # one convolution algorithm in both runs
    try:
        full = trainer(*client_world(mcfg, dataset, n_clients=16), fed)
        full.run_round()
        full.run_round()
        after_two = full.params
        full.run_round()
        clients, test = client_world(mcfg, dataset, n_clients=16)
        trainer(clients, test, ckpt_fed).run(2)
        saved = sorted(os.listdir(directory))
        resumed = trainer(clients, test, ckpt_fed)
        assert resumed.maybe_restore() and resumed.round == 2
        assert same(resumed.params, after_two), "restored params differ from the run's"
        resumed.run_round()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert (resumed.round, resumed.sim_clock, resumed.comm_bytes) == (
        full.round, full.sim_clock, full.comm_bytes)
    assert resumed.history == full.history
    assert same(resumed.params, full.params), "round 3 after the restore differs"
    say(f"  resumed at round 2 from {saved[-2:]}: round 3's params, "
        f"round, sim_clock {resumed.sim_clock:.4f}, comm_bytes {resumed.comm_bytes} and the "
        f"{len(resumed.history)} history records equal the uninterrupted run's (params bit for bit)")


# ---------------------------------------------------------------- phase 24

FABRIC_SLOTS = 16
FABRIC_TTL = 2.0
FABRIC_ROUNDS = 3
FABRIC_STEPS = 10
#: (tenant, weight, client_batching, world seed): A collects its eager waves
#: through the grouped-matmul kernels, B trains its clients one at a time
#: under the analytical runtime
FABRIC_TENANTS = (("A", 3.0, "wave", 0), ("B", 1.0, "off", 1))
FABRIC_ENGINE_KW = dict(record_campaign_timeline=False, record_events=False)
#: the history's fields on the simulated clock
SIM_FIELDS = ("round", "duration", "sim_clock", "completed", "mode", "failed",
              "avg_parallelism", "utilization", "comm_bytes")
FABRIC_COUNTERS = ("exec.spawns", "fed.comm_bytes", "client.batch_waves")
#: the reference's f32 tolerance (allclose: rtol and atol), for the single
#: tenant's parameters and losses against run_round's
SINGLE_TENANT_TOL = 2e-5
#: tenant A's FixedRuntime spread: 0 in the gated world (every client the
#: same work), 1 in the world as first specified (the work differs by batch
#: size)
FABRIC_SPREADS = (0.0, 1.0)


def sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def fabric_trainer(mcfg, tid, batching, seed, device, engine=None, obs=None, spread=0.0):
    """Phase 3's FEMNIST-MLP world (world seed ``seed``) as tenant ``tid``:
    B on the port's AnalyticalRuntime, A on FixedRuntime(2.0, spread).  At
    spread 0 every client has the same work: clients of one budget admitted
    together then finish together and are collected as one ragged wave.
    With a spread the work differs by batch size, so clients that finish
    together share one: an eager wave is one client (the sequential step)
    or one batch size (bmm), and seldom reaches gmm."""
    from repro_torch.core.runtime import AnalyticalRuntime, FixedRuntime
    from repro_torch.fed.trainer import FedConfig, FederatedTrainer

    clients, test = build_world(mcfg, seed=seed)
    fed = FedConfig(rounds=FABRIC_ROUNDS, participants_per_round=32, max_parallel=32,
                    local_steps=FABRIC_STEPS, client_batching=batching, seed=seed)
    runtime = FixedRuntime(2.0, spread) if tid == "A" else AnalyticalRuntime()
    return FederatedTrainer(mcfg, clients, fed, test_batch=test, engine=engine, obs=obs,
                            runtime=runtime, device=device)


def run_fabric(torch, ops, mcfg, device, tenants=FABRIC_TENANTS, trace=True,
               slots=FABRIC_SLOTS, spread=FABRIC_SPREADS[0]):
    """One ``PoolFabric`` over ``tenants`` driven by ``run_trainers``: the
    trainers, histories, obs plane, wall seconds, the simulated makespan,
    and the ``gmm``/``tgmm`` launches (``tgmm``'s by path) of the run."""
    from repro_torch.core.fabric import PoolFabric
    from repro_torch.obs import ObsPlane

    obs = ObsPlane(trace=trace)
    fab = PoolFabric(total_slots=slots, capacity=100.0, lease_ttl=FABRIC_TTL, obs=obs)
    trainers = {tid: fabric_trainer(mcfg, tid, batching, seed, device, obs=obs, spread=spread,
                                    engine=fab.add_tenant(tid, weight=w, **FABRIC_ENGINE_KW))
                for tid, w, batching, seed in tenants}
    for counts in (ops.LAUNCHES, ops.TGMM_PATH_LAUNCHES):
        for k in counts:
            counts[k] = 0
    sync(torch, device)
    t0 = time.perf_counter()
    hists = fab.run_trainers(trainers)
    sync(torch, device)
    wall = time.perf_counter() - t0
    for tid, hist in hists.items():
        assert len(hist) == FABRIC_ROUNDS, (tid, len(hist))
        for rec in hist:
            for k, v in rec.items():
                if "loss" in k or k.endswith("_ce"):
                    assert math.isfinite(v), (tid, k, v)
    return {"trainers": trainers, "hists": hists, "obs": obs, "wall": wall,
            "makespan": max(t.engine.now for t in trainers.values()),
            "launches": dict(ops.LAUNCHES), "tgmm_paths": dict(ops.TGMM_PATH_LAUNCHES)}


def wall_spans(obs, tid, name):
    """``name``'s wall spans on tenant ``tid``'s track: (seconds, args)."""
    from repro_torch.obs.trace import resolve_args

    obs.tracer.flush()
    return [(ev[8], resolve_args(ev[1], ev[9])) for ev in obs.tracer.events
            if ev[1] == name and ev[3] == tid and ev[7] is not None]


def fabric_waves(res, tid):
    """Tenant ``tid``'s collection by round: the waves (clients, mode) and
    the COLLECT wall (the sum of its wall spans, eager and after the close)."""
    out = {}
    for name in ("client.batch_wave", "client.train"):
        for dur, args in wall_spans(res["obs"], tid, name):
            r = out.setdefault(args["round"], {"waves": [], "wall_s": 0.0})
            r["waves"].append((args.get("clients", 1), args.get("mode", "one")))
            r["wall_s"] += dur
    return out


def params_gap(torch, a, b):
    """Largest per-leaf ‖a − b‖ / ‖b‖ over two parameter trees (b's device)."""
    from repro_torch.tree import tree_leaves

    return max(float((x.to(y.device) - y).norm() / y.norm())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def check_fabric_trace(res, directory):
    """The traced run exported on both clocks must parse and validate; each
    tenant's track holds its ``client.exec`` sim spans, A's its
    ``client.batch_wave`` wall spans, B's its ``client.train``."""
    from repro_torch.obs.export import validate_chrome_trace

    tracks = {}
    for clock in ("sim", "wall"):
        path = os.path.join(directory, f"fabric_{clock}.json")
        res["obs"].save_trace(path, clock=clock)
        with open(path) as f:
            chrome = json.load(f)
        assert validate_chrome_trace(chrome) == [], (clock, validate_chrome_trace(chrome)[:5])
        pids = {e["pid"]: e["args"]["name"] for e in chrome["traceEvents"]
                if e["ph"] == "M" and e["name"] == "process_name"}
        for e in chrome["traceEvents"]:
            if e["ph"] != "M":
                key = (clock, pids[e["pid"]], e["name"])
                tracks[key] = tracks.get(key, 0) + 1
        say(f"  {clock}-clock trace: {len(chrome['traceEvents'])} events, "
            f"{os.path.getsize(path)} bytes, tracks {sorted(set(pids.values()))}")
    for tid, _, batching, _ in FABRIC_TENANTS:
        assert tracks.get(("sim", tid, "client.exec"), 0) > 0, (tid, tracks)
        wall_name = "client.batch_wave" if batching == "wave" else "client.train"
        assert tracks.get(("wall", tid, wall_name), 0) > 0, (tid, wall_name, tracks)
    say("  events by (clock, tenant, name): " + json.dumps(
        {f"{c} {t} {n}": v for (c, t, n), v in sorted(tracks.items())}))


def runtime_rows(torch, trainer):
    """Seconds at full capacity of one client step at each batch size:
    the port's AnalyticalRuntime (the card's roofline, counted on meta
    tensors) against MeasuredRuntime (the step timed on the card)."""
    from repro_torch.core.runtime import AnalyticalRuntime, MeasuredRuntime
    from repro_torch.fed.client import batch_to

    dev = trainer.device
    opt_state = trainer.opt.init(trainer.params)
    fn = lambda p, o, b: trainer.step_fn(p, o, batch_to(b, dev), p)[0]   # noqa: E731
    rows = {}
    for bs in CLIENT_BATCH_SIZES:
        client = next(c for c in trainer.clients if c.data.batch_size == bs)
        batch = client.data.next_batch()
        args = (trainer.params, opt_state, batch)
        rows[bs] = {"analytical": AnalyticalRuntime().seconds_at_full(("mlp", bs), fn, args),
                    "measured": MeasuredRuntime(dev).seconds_at_full(("mlp", bs), fn, args,
                                                                     repeats=20)}
        say(f"  batch {bs}: analytical {rows[bs]['analytical'] * 1e6:.3f} us, measured "
            f"{rows[bs]['measured'] * 1e6:.3f} us a step")
    return rows


def offset_bits(torch, ops):
    """Does a group's result depend on where its rows sit in a wave?  At each
    FEMNIST-MLP layer shape, every client's rows (batch sizes 16/32/48/64) as
    the only group of a call, against the same rows among the others: gmm's
    output rows and tgmm's dw, compared bit for bit (measured, f32, ffma)."""
    g = torch.Generator(device="cuda").manual_seed(24)
    sizes = list(CLIENT_BATCH_SIZES)
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    one = torch.empty(1, dtype=torch.int32, device="cuda")
    out = {}
    for name, k, n in LAYERS:
        x = torch.randn(sum(sizes), k, device="cuda", generator=g)
        dy = torch.randn(sum(sizes), n, device="cuda", generator=g)
        w = torch.randn(len(sizes), k, n, device="cuda", generator=g)
        y_all, dw_all = ops.gmm(x, w, gs), ops.tgmm(x, dy, gs, len(sizes))
        same, worst, start = True, 0.0, 0
        for i, rows in enumerate(sizes):
            one.fill_(rows)
            sl = slice(start, start + rows)
            y1 = ops.gmm(x[sl].contiguous(), w[i:i + 1].contiguous(), one)
            dw1 = ops.tgmm(x[sl].contiguous(), dy[sl].contiguous(), one, 1)[0]
            same = same and torch.equal(y1, y_all[sl]) and torch.equal(dw1, dw_all[i])
            worst = max(worst, float((y1 - y_all[sl]).abs().max()),
                        float((dw1 - dw_all[i]).abs().max()))
            start += rows
        out[name] = {"bit_identical": same, "max_abs": worst}
    say("  a client's rows alone against the same rows inside a 4-client call: " + "; ".join(
        f"{name} " + ("bit-identical" if r["bit_identical"] else f"differ, max |Δ| {r['max_abs']:.3e}")
        for name, r in out.items()))
    return out


def fabric_wave_launches(res, mcfg, label):
    """Prints each tenant's waves by round and returns (waves by tenant,
    ragged waves of A, the gmm/tgmm launches they imply).  Every ragged wave
    of A runs each local step's layers through the kernels: 2L + 1 gmm
    (L + 1 forward, L dx past the first layer) and L + 1 tgmm."""
    waves = {tid: fabric_waves(res, tid) for tid, *_ in FABRIC_TENANTS}
    for tid, by_round in waves.items():
        for r, w in sorted(by_round.items()):
            sizes = [c for c, _ in w["waves"]]
            say(f"  {label} {tid} round {r}: {len(sizes)} waves, clients a wave {sizes}, modes "
                f"{sorted(set(m for _, m in w['waves']))}, COLLECT wall {w['wall_s']:.4f} s")
    ragged = sum(1 for w in waves["A"].values() for _, m in w["waves"] if m == "ragged")
    layers = mcfg.n_layers
    implied = {"gmm": ragged * FABRIC_STEPS * (2 * layers + 1),
               "tgmm": ragged * FABRIC_STEPS * (layers + 1)}
    say(f"  {label} A: {ragged} ragged waves imply {implied}; counted {res['launches']}, "
        f"tgmm by path {res['tgmm_paths']}")
    assert res["launches"] == implied, (res["launches"], implied)
    assert res["tgmm_paths"] == {"ffma": implied["tgmm"], "wgmma": 0}, res["tgmm_paths"]
    return waves, ragged


def fabric_twin_gates(torch, ops, mcfg, res, spread):
    """The same two tenants on the CPU: per tenant, the history's simulated
    fields equal, the counters equal and the params within TWIN_REL_TOL.
    Returns the params gaps."""
    t0 = time.perf_counter()
    cpu = run_fabric(torch, ops, mcfg, "cpu", trace=False, spread=spread)
    say(f"  CPU run {time.perf_counter() - t0:.2f} s")
    gaps = {}
    for tid, *_ in FABRIC_TENANTS:
        for got, want in zip(res["hists"][tid], cpu["hists"][tid]):
            diff = {k: (got[k], want[k]) for k in SIM_FIELDS if got[k] != want[k]}
            assert not diff, (tid, diff)
        gaps[tid] = params_gap(torch, res["trainers"][tid].params, cpu["trainers"][tid].params)
        card_c = {k: res["obs"].registry.counters_snapshot().get(k, {}).get(tid)
                  for k in FABRIC_COUNTERS}
        cpu_c = {k: cpu["obs"].registry.counters_snapshot().get(k, {}).get(tid)
                 for k in FABRIC_COUNTERS}
        say(f"  {tid}: simulated fields equal the CPU's over {FABRIC_ROUNDS} rounds "
            f"(sim_clock {res['hists'][tid][-1]['sim_clock']!r}, utilization "
            f"{[h['utilization'] for h in res['hists'][tid]]}); params card against CPU "
            f"{gaps[tid]:.3e} (limit {TWIN_REL_TOL:g}); counters {card_c}")
        assert gaps[tid] < TWIN_REL_TOL, (tid, gaps[tid])
        assert card_c == cpu_c, (tid, card_c, cpu_c)
    for tid, hist in res["hists"].items():
        say(f"  {tid} history: " + json.dumps(hist))
    return gaps


def run_fabric_phase(torch, ops, mcfg, smi):
    """Phase 24: two FL tenants share one pool through ``PoolFabric``."""
    from repro_torch.tree import tree_leaves

    say(f"  card: {smi}")
    gated, issued = FABRIC_SPREADS
    res = run_fabric(torch, ops, mcfg, "cuda", spread=gated)
    launches, tgmm_paths = res["launches"], res["tgmm_paths"]
    say(f"  two tenants, A at spread {gated:g}, traced: wall {res['wall']:.3f} s, simulated "
        f"makespan {res['makespan']:.4f} s")
    waves, ragged = fabric_wave_launches(res, mcfg, f"spread {gated:g}:")
    assert ragged > 0, waves["A"]

    with tempfile.TemporaryDirectory() as directory:
        check_fabric_trace(res, directory)
    aggregate_s = {tid: [dur for dur, _ in wall_spans(res["obs"], tid, "round.aggregate")]
                   for tid, *_ in FABRIC_TENANTS}
    say("  round.aggregate wall spans (the card synchronized before each closes): " +
        "; ".join(f"{tid} {[round(d * 1e3, 4) for d in ds]} ms" for tid, ds in aggregate_s.items()))

    say("  the same two tenants on the CPU (the twin):")
    gaps = fabric_twin_gates(torch, ops, mcfg, res, gated)

    say(f"  the world as first specified, A on FixedRuntime(2.0, {issued:g}), traced, then its "
        "CPU twin:")
    spread_res = run_fabric(torch, ops, mcfg, "cuda", spread=issued)
    say(f"  two tenants, A at spread {issued:g}: wall {spread_res['wall']:.3f} s, simulated "
        f"makespan {spread_res['makespan']:.4f} s")
    spread_waves, _ = fabric_wave_launches(spread_res, mcfg, f"spread {issued:g}:")
    spread_gaps = fabric_twin_gates(torch, ops, mcfg, spread_res, issued)
    for r in sorted(waves["A"]):
        a, b = waves["A"][r], spread_waves["A"].get(r, {"waves": [], "wall_s": 0.0})
        say(f"  A round {r}: spread {gated:g} {len(a['waves'])} waves, COLLECT "
            f"{a['wall_s']:.4f} s; spread {issued:g} {len(b['waves'])} waves, COLLECT "
            f"{b['wall_s']:.4f} s")

    say("  the fabric untraced (obs without a tracer) and traced in turns, then each tenant "
        "alone on the pool:")
    turns = [run_fabric(torch, ops, mcfg, "cuda", trace=t) for t in (False, True, True, False)]
    walls = {t: sorted(r["wall"] for r in turns if r["obs"].tracing == t) for t in (False, True)}
    off = turns[0]
    alone = {t[0]: run_fabric(torch, ops, mcfg, "cuda", tenants=(t,), trace=False)
             for t in FABRIC_TENANTS}
    serial_wall = sum(r["wall"] for r in alone.values())
    serial_makespan = sum(r["makespan"] for r in alone.values())
    off_s, on_s = statistics.mean(walls[False]), statistics.mean(walls[True])
    say(f"  wall: two tenants untraced {walls[False]} s, traced {walls[True]} s (trace "
        f"{100 * (on_s / off_s - 1):+.1f} % on the means; the gated traced run, the first, "
        f"{res['wall']:.3f} s); one after the other {serial_wall:.3f} s ("
        f"{', '.join(f'{t} {r['wall']:.3f}' for t, r in alone.items())}): serial / shared "
        f"{serial_wall / off_s:.3f}x")
    say(f"  simulated makespan: shared {off['makespan']:.4f} s, one after the other "
        f"{serial_makespan:.4f} s: {serial_makespan / off['makespan']:.3f}x")

    say("  A's world as the only tenant of a 32-slot pool against run_round on the card:")
    solo = run_fabric(torch, ops, mcfg, "cuda", tenants=FABRIC_TENANTS[:1], trace=False,
                      slots=32)
    tid, _, batching, seed = FABRIC_TENANTS[0]
    plain = fabric_trainer(mcfg, tid, batching, seed, "cuda")
    plain.run()
    torch.cuda.synchronize()
    fab_hist, run_hist = solo["hists"]["A"], plain.history
    tol = SINGLE_TENANT_TOL
    for got, want in zip(fab_hist, run_hist):
        diff = {k: (got[k], want[k]) for k in SIM_FIELDS if got[k] != want[k]}
        assert not diff, diff
        for k in want:
            if k not in SIM_FIELDS:
                assert abs(got[k] - want[k]) <= tol + tol * abs(want[k]), (k, got[k], want[k])
    pairs = list(zip(tree_leaves(solo["trainers"]["A"].params), tree_leaves(plain.params)))
    gap = params_gap(torch, solo["trainers"]["A"].params, plain.params)
    max_abs = max(float((x - y).abs().max()) for x, y in pairs)
    same = all(torch.equal(x, y) for x, y in pairs)
    say(f"  history's simulated fields equal, losses within {tol:g}; params max |Δ| "
        f"{max_abs:.3e} (allclose rtol = atol = {tol:g}), largest per-leaf relative norm "
        f"{gap:.3e}; bit-identical: {same and fab_hist == run_hist} (params {same}, history "
        f"{fab_hist == run_hist}); waves {solo['trainers']['A'].batch_exec.stats.as_dict()} "
        f"against run_round's {plain.batch_exec.stats.as_dict()}")
    assert all(torch.allclose(x, y, rtol=tol, atol=tol) for x, y in pairs), max_abs

    offsets = offset_bits(torch, ops)
    say("  seconds at full capacity of one client step, B's analytical runtime against the "
        "measured one:")
    rt_rows = runtime_rows(torch, res["trainers"]["B"])
    return launches, tgmm_paths, {
        "card": smi, "wall_s": {"first_traced": res["wall"], "traced": walls[True],
                                "untraced": walls[False], "serial": serial_wall},
        "makespan_s": {"shared": off["makespan"], "serial": serial_makespan},
        "waves": {tid: {r: w["waves"] for r, w in by.items()} for tid, by in waves.items()},
        "collect_wall_s": {tid: {r: w["wall_s"] for r, w in by.items()}
                           for tid, by in waves.items()},
        "params_gap_card_cpu": gaps, "aggregate_wall_s": aggregate_s,
        "as_specified": {"wall_s": spread_res["wall"], "launches": spread_res["launches"],
                     "waves": {r: w["waves"] for r, w in spread_waves["A"].items()},
                     "collect_wall_s": {tid: {r: w["wall_s"] for r, w in by.items()}
                                        for tid, by in spread_waves.items()},
                     "params_gap_card_cpu": spread_gaps},
        "single_tenant_params_max_abs": max_abs,
        "single_tenant_params_gap": gap,
        "single_tenant_bit_identical": same and fab_hist == run_hist,
        "group_offset_bits": offsets,
        "step_seconds": rt_rows}


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
    from repro_torch.kernels.flash_attention import decode_ops, decode_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.grouped_matmul import ops, ref
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.kernels.rglru_scan import ref as lru_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
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
    libraries = {"grouped_matmul": ops, "flash_attention": fa_ops, "ssd_scan": ssd_ops,
                 "rglru_scan": lru_ops, "flash_decode_int8": decode_ops}
    with ThreadPoolExecutor(len(libraries)) as pool:   # one nvcc per library, side by side
        for fut in [pool.submit(m.library) for m in libraries.values()]:
            fut.result()
    say(f"  kernels built in {time.perf_counter() - t0:.2f} s")
    for name in libraries:
        say(f"  {name}: nvcc {build.BUILD_SECONDS[name]:.2f} s")
        for line in build.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                say("   ", line.strip())
    say("  flash_attention dynamic shared memory a block: " + "; ".join(
        f"{path}: " + ", ".join(f"D<={d} {fa_ops.library().repro_flash_attention_smem_bytes(code, d)} B"
                                for d in (32, 64, 128, 256))
        for path, code in fa_ops.PATHS.items()))
    say("  ssd_scan dynamic shared memory a block: " + "; ".join(
        f"{path}: " + ", ".join(f"P<={p} N<={n} {ssd_ops.library().repro_ssd_scan_smem_bytes(code, p, n)} B"
                                for p, n in ((16, 32), (16, 128), (64, 32), (64, 64), (64, 128)))
        for path, code in ssd_ops.PATHS.items()))
    say("  flash_decode_int8 a block: " + "; ".join(
        f"G={g} D={d} {decode_ops.library().repro_flash_decode_int8_smem_bytes(g, d)} B dynamic "
        f"shared memory, clusters that fit at once by size {decode_ops.cluster_fit(0, g, d)}"
        for g, d in ((1, 64), (1, 128), (16, 256))))
    counters = (ops.LAUNCHES, fa_ops.LAUNCHES, ssd_ops.LAUNCHES, lru_ops.LAUNCHES,
                decode_ops.LAUNCHES)
    no_launches = {k: 0 for counts in counters for k in counts}

    say("PHASE 2 kernels against their plain versions")
    worst = check_kernels(torch, ops, ref, list(CLIENT_BATCH_SIZES) * 8, edge_cases())
    say("  gmm on every path at the split edge cases:")
    worst["gmm"] = max(worst["gmm"], check_paths(torch, ops, ref, path_cases()))
    say("  tgmm on each path at the layer shapes and the edge cases:")
    tgmm_errs = check_tgmm_paths(torch, ops, ref, tgmm_cases(list(CLIENT_BATCH_SIZES) * 8))
    worst["tgmm"] = max(worst["tgmm"], tgmm_errs["float32 ffma"])   # the FL path's dtype

    say("PHASE 3 main path: 3 rounds, 128 FEMNIST-MLP clients, ragged waves")
    mcfg = SmallModelConfig(kind="mlp", n_classes=62, hidden=128, n_layers=2,
                            image_size=28, channels=1)
    trainer, launches, tgmm_paths, phase_s, waves, globals_r1, run_s = run_main_path(
        torch, ops, mcfg)

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
    flash_errs = check_flash(torch, fa_ops, fa_ref)
    worst["flash_attention"] = flash_errs["bfloat16 wgmma"]   # the path the entry times

    cfg = get_config(SERVE_ARCH)
    say(f"PHASE 7 serve path: {SERVE_ARCH} at its published width ({cfg.total_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), "
        f"batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, {SERVE_STEPS} greedy decode steps")
    res, qwen_launches = run_serve(torch, cfg, counters,
                                   {**no_launches, "flash_attention": cfg.total_layers})
    profile_serve(torch, cfg, res, ("flash_fwd",))

    say("PHASE 8 serve twin: the same prefill and decode with attention through the plain version")
    serve_twin(torch, cfg, res, {"attn_impl": "reference"},
               ("K/V rolled by one", [(fa_ops, "flash_attention", roll_kv)]))
    del res

    say("PHASE 9 flash attention timings at the serve shapes")
    flash_rows = {shape: time_flash(torch, fa_ops, fa_ref, shape)
                  for shape in (SERVE_SHAPE, RG_ATTN_SHAPE, OLMOE_ATTN_SHAPE)}
    say(f"  so far {time.perf_counter() - t_all:.1f} s")

    say("PHASE 10 ssd_scan against its plain version")
    ssd_errs = check_ssd(torch, ssd_ops, ssd_ref)
    worst["ssd_scan"] = ssd_errs["bfloat16 wgmma"]   # the path the entry times

    say("PHASE 11 rglru_scan against its plain version")
    worst["rglru_scan"] = check_rglru(torch, lru_ops, lru_ref)

    cfg = get_config(MAMBA_ARCH)
    say(f"PHASE 12 serve path: {MAMBA_ARCH} at its published width ({cfg.total_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_ssm_heads} SSD heads of {cfg.ssm_head_dim}, state "
        f"{cfg.ssm_state}, vocab {cfg.vocab_size}, {cfg.param_dtype} weights, "
        f"{cfg.compute_dtype} compute), batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, "
        f"{SERVE_STEPS} greedy decode steps")
    res, mamba_launches = run_serve(torch, cfg, counters,
                                    {**no_launches, "ssd_scan": cfg.total_layers})
    profile_serve(torch, cfg, res, ("ssd_wgmma_kernel", "ssd_kernel"))

    say("PHASE 13 serve twin: the same prefill and decode with the SSD scan through its plain version")
    serve_twin(torch, cfg, res, {"ssm_impl": "chunked"},
               ("scan inputs rolled by one", [(ssd_ops, "ssd", roll_ssd)]),
               floor_routes={"ssm_impl": "chunked", "ssm_chunk": SSD_CHUNK // 2})
    layer_twin(torch, cfg, res, ssd_ops, "ssd",
               lambda *a: ssd_ref.ssd_chunked(*a, chunk=cfg.ssm_chunk), roll_ssd,
               {"bfloat16": (2e-2, 2e-2), "float32": (2e-5, 2e-5)}, cfg.total_layers)
    del res
    say(f"  so far {time.perf_counter() - t_all:.1f} s")

    cfg = get_config(RGEMMA_ARCH)
    n_lru = sum(g.repeat for g in cfg.groups for spec in g.pattern if spec.mixer == "rglru")
    n_attn = cfg.total_layers - n_lru
    say(f"PHASE 14 serve path: {RGEMMA_ARCH} at its published width ({cfg.total_layers} layers: "
        f"{n_lru} RG-LRU, {n_attn} local attention, d_model {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.resolved_head_dim}, {cfg.n_kv_heads} KV head, window {cfg.groups[0].pattern[-1].window}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.param_dtype} weights), batch "
        f"{SERVE_BATCH}, prompt {SERVE_PROMPT}, {SERVE_STEPS} greedy decode steps")
    res, rgemma_launches = run_serve(torch, cfg, counters, {
        **no_launches, "rglru_scan": n_lru, "flash_attention": n_attn})
    profile_serve(torch, cfg, res, ("rglru_kernel", "flash_fwd"))

    say("PHASE 15 serve twin: the same prefill and decode with every kernel through its plain version")
    # the RG-LRU's long memory (per-step decay 0.95 to 0.9995 at init) makes a
    # one-step roll of its inputs a change of a few percent in h, too close
    # to the bf16 limit for a control: the bf16 control rolls the inputs of
    # both kernels of the path; the f32 control, 100x finer, rolls the
    # RG-LRU's alone
    serve_twin(torch, cfg, res, {"rglru_impl": "associative", "attn_impl": "reference"},
               ("RG-LRU inputs and K/V rolled by one", [(lru_ops, "rglru_scan", roll_rglru),
                                                        (fa_ops, "flash_attention", roll_kv)]),
               ("RG-LRU inputs rolled by one", [(lru_ops, "rglru_scan", roll_rglru)]),
               floor_routes={"rglru_impl": "associative", "attn_impl": "chunked"})
    layer_twin(torch, cfg, res, lru_ops, "rglru_scan", lru_ref.rglru_associative, roll_rglru,
               {"bfloat16": (2e-2, 1e-4), "float32": (2e-5, 1e-4)}, n_lru)
    del res

    say("PHASE 16 scan timings at the serve shapes")
    scan_rows = time_scans(torch, ssd_ops, ssd_ref, lru_ops, lru_ref)
    say(f"  so far {time.perf_counter() - t_all:.1f} s")
    torch.cuda.empty_cache()     # recurrentgemma's tensors are gone; olmoe's f32 weights are 27 GB

    cfg = get_config(OLMOE_ARCH)
    say(f"PHASE 17 gmm at {OLMOE_ARCH}'s expert shapes against its plain version")
    splits = moe_splits(torch, cfg)
    worst["gmm"] = max(worst["gmm"], check_moe_gmm(torch, ops, ref, cfg, splits))
    tgmm_errs["bfloat16 wgmma"] = max(tgmm_errs["bfloat16 wgmma"],
                                      check_moe_tgmm(torch, ops, ref, cfg, splits))
    check_no_host_sync(torch, ops, cfg, splits)
    moe_rows = time_moe_gmm(torch, ops, ref, cfg, splits)
    moe_tgmm_rows = time_moe_tgmm(torch, ops, ref, cfg, splits)

    n_moe = sum(g.repeat for g in cfg.groups for spec in g.pattern if spec.ffn == "moe")
    say(f"PHASE 18 serve path: {OLMOE_ARCH} at its published width ({cfg.total_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.resolved_head_dim}, {cfg.n_experts} "
        f"experts of d_ff {cfg.d_ff_expert}, top-{cfg.top_k}, vocab {cfg.vocab_size}, "
        f"{cfg.param_dtype} weights), batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, {SERVE_STEPS} "
        f"greedy decode steps")
    res, olmoe_launches = run_serve(torch, cfg, counters, {
        **no_launches, "flash_attention": cfg.total_layers, "gmm": 3 * n_moe * (1 + SERVE_STEPS)})
    profile_serve(torch, cfg, res, ("gmm_wgmma_kernel", "gmm_stream_kernel", "flash_fwd"))

    say("PHASE 19 serve twin: the same prefill and decode with every expert product through the "
        "plain loop")
    moe_twin(torch, cfg, res)
    moe_layer_twin(torch, cfg, res)
    del res
    torch.cuda.empty_cache()
    say(f"  so far {time.perf_counter() - t_all:.1f} s")

    say("PHASE 20 flash_decode_int8 against its plain version")
    worst["flash_decode_int8"] = check_decode(torch, decode_ops, decode_ref)

    cfg = get_config(SERVE_ARCH).replace(kv_cache_quant=True)
    steps = (SERVE_PROMPT, SERVE_PROMPT + SERVE_STEPS - 1)
    say(f"PHASE 21 serve path: {SERVE_ARCH} with an int8 KV cache at its published width, batch "
        f"{SERVE_BATCH}, prompt {SERVE_PROMPT}, {SERVE_STEPS} greedy decode steps; at positions "
        f"{steps} every layer's served cache also goes through flash_decode_int8")
    say("  the served walls, with nothing wrapped:")
    res, _ = run_serve(torch, cfg, counters, {**no_launches, "flash_attention": cfg.total_layers})
    del res
    say("  the checked run, with the decode kernel beside the model's attention at two steps:")
    caps = []
    with capture_decode(torch, steps, caps):
        res, int8_launches = run_serve(torch, cfg, counters, {
            **no_launches, "flash_attention": cfg.total_layers,
            "flash_decode_int8": len(steps) * cfg.total_layers})
    caps = caps[-len(steps) * cfg.total_layers:]     # the counted run's (the warm-up's come first)
    assert [c["pos"] for c in caps] == [p for p in steps for _ in range(cfg.total_layers)]
    profile_serve(torch, cfg, res, ("flash_fwd",))
    worst["flash_decode_int8"] = max(worst["flash_decode_int8"],
                                     check_served_decode(torch, decode_ops, decode_ref, caps))
    fp, _ = teacher_forced_logits(torch, cfg.replace(kv_cache_quant=False, **KERNEL_ROUTES),
                                  res["params"], res["prompts"], res["tokens"])
    gap = [float((a.float() - b.float()).abs().max() / a.float().abs().max())
           for a, b in zip(fp, res["logits"])]
    say(f"  int8 cache against a bf16 cache, teacher-forced logits max|Δ| / max|bf16|: prefill "
        f"{gap[0]:.3e}, decode steps {min(gap[1:]):.3e} .. {max(gap[1:]):.3e} (the reference's "
        f"tests/test_elastic_kvquant.py holds 0.02 at reduced size in f32; not asserted here)")
    del res

    say("PHASE 22 flash_decode_int8 timings at the served decode shape and decode_32k's length")
    decode_row = time_decode(torch, decode_ops, decode_ref, caps)
    del caps
    decode_long = time_decode_long(torch, decode_ops, decode_ref)
    say(f"  so far {time.perf_counter() - t_all:.1f} s")

    say(f"PHASE 23 clients: the paper's other client models at its widths, {CLIENTS_N} clients, "
        f"{CLIENTS_PARTICIPANTS} participants, {CLIENTS_STEPS} local steps, batch {CLIENTS_BATCH} "
        f"(one dense wave a round); then the MLP world under other optimizers and compression; "
        f"then a checkpointed run resumed")
    say(f"  card: {smi}")
    client_rows = {name: run_client_model(torch, name, fields, dataset, opt_name, lr)
                   for name, fields, dataset, opt_name, lr in CLIENT_MODELS}
    option_launches, option_rows = run_mlp_options(torch, ops, mcfg)
    with tempfile.TemporaryDirectory() as directory:
        check_resume(torch, directory)
    say(json.dumps({"clients": {"card": smi, "models": client_rows, "mlp options": option_rows,
                                "mlp options launches": option_launches}}))
    say(f"  so far {time.perf_counter() - t_all:.1f} s")

    say(f"PHASE 24 fabric: two tenants of phase 3's world share a {FABRIC_SLOTS}-slot pool through "
        f"PoolFabric (weights 3:1, lease TTL {FABRIC_TTL:g} s), {FABRIC_ROUNDS} rounds each through "
        f"run_trainers, every round traced; A collects eagerly in ragged waves, B client by client "
        f"under the analytical runtime")
    fabric_launches, fabric_tgmm_paths, fabric_row = run_fabric_phase(torch, ops, mcfg, smi)
    say(json.dumps({"fabric": fabric_row}))
    say(f"  whole script {time.perf_counter() - t_all:.1f} s")

    replaces = {"gmm": "src/repro/kernels/grouped_matmul/kernel.py:49",
                "tgmm": "src/repro/kernels/grouped_matmul/ops.py:45"}
    timing_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for name in ("gmm", "tgmm"):
        r = next(r for r in rows if r["name"] == name and r["layer"] == "784->128")
        kernels.append({
            "name": name, "route": "cuda", "source": GMM_SOURCE,
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": worst[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "dtype": "float32", "bfloat16": r["bfloat16"],
        })
    kernels[1].update({
        "launches": launches["tgmm"] + option_launches["tgmm"] + fabric_launches["tgmm"],
        "launches_by_path": {"femnist-mlp rounds": launches["tgmm"],
                             "femnist-mlp rounds, other options": option_launches["tgmm"],
                             "femnist-mlp fabric, tenant A": fabric_launches["tgmm"]},
        "path": rows[1]["path"], "wrapper_ms": rows[1]["wrapper_ms"],
        "launches_by_kernel_path": {p: tgmm_paths[p] + option_launches["tgmm_by_path"][p]
                                    + fabric_tgmm_paths[p] for p in tgmm_paths},
        "max_abs_err_by_path": tgmm_errs,
        "by_path": {r["layer"]: {"float32": r["by_path"], "bfloat16": r["bfloat16"]["by_path"]}
                    for r in rows if r["name"] == "tgmm"},
        "layers": {r["layer"]: {**{k: r[k] for k in (*timing_keys, "path", "wrapper_ms")},
                                "bfloat16": r["bfloat16"]}
                   for r in rows if r["name"] == "tgmm"},
        OLMOE_ARCH: {key: {k: r[k] for k in (*timing_keys, "path", "wrapper_ms", "tflop_per_s")}
                     for key, r in moe_tgmm_rows.items()},
    })
    kernels[0].update({
        "launches": (launches["gmm"] + olmoe_launches["gmm"] + option_launches["gmm"]
                     + fabric_launches["gmm"]),
        "launches_by_path": {"femnist-mlp rounds": launches["gmm"],
                             OLMOE_ARCH: olmoe_launches["gmm"],
                             "femnist-mlp rounds, other options": option_launches["gmm"],
                             "femnist-mlp fabric, tenant A": fabric_launches["gmm"]},
        "path": rows[0]["path"], "wrapper_ms": rows[0]["wrapper_ms"],
        OLMOE_ARCH: {f"{name}, {prod}": {k: r[k] for k in (*timing_keys, "path", "wrapper_ms")}
                     for (name, prod), r in moe_rows.items()},
    })
    flash_row = flash_rows[SERVE_SHAPE]
    flash_paths = {SERVE_ARCH: qwen_launches, RGEMMA_ARCH: rgemma_launches,
                   OLMOE_ARCH: olmoe_launches, f"{SERVE_ARCH} (int8 KV cache)": int8_launches}
    flash_keys = (*timing_keys, "path", "ffma_bf16_ms", "f32_ms", "tflops")
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": "src/repro/kernels/flash_attention/kernel.py:89",
        "launches": sum(p["flash_attention"] for p in flash_paths.values()),
        "launches_by_path": {k: p["flash_attention"] for k, p in flash_paths.items()},
        "launches_by_kernel_path": {path: sum(p["flash_attention_by_path"][path]
                                              for p in flash_paths.values())
                                    for path in fa_ops.PATHS},
        "max_abs_err": worst["flash_attention"], "max_abs_err_by_path": flash_errs,
        **{k: flash_row[k] for k in flash_keys},
        RGEMMA_ARCH: {k: flash_rows[RG_ATTN_SHAPE][k] for k in flash_keys},
        OLMOE_ARCH: {k: flash_rows[OLMOE_ATTN_SHAPE][k] for k in flash_keys},
    })
    for name, source, replaces_at, path_launches in (
            ("ssd_scan", SSD_SOURCE, "src/repro/kernels/ssd_scan/kernel.py:63", mamba_launches),
            ("rglru_scan", RGLRU_SOURCE, "src/repro/kernels/rglru_scan/kernel.py:44",
             rgemma_launches)):
        r = scan_rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces_at,
            "launches": path_launches[name], "max_abs_err": worst[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    kernels[-2].update({
        "path": scan_rows["ssd_scan"]["path"], "dtype": "bfloat16",
        "launches_by_kernel_path": mamba_launches["ssd_scan_by_path"],
        "max_abs_err_by_path": ssd_errs,
        "by_path": scan_rows["ssd_scan"]["by_path"],
    })
    kernels.append({
        "name": "flash_decode_int8", "route": "cuda", "source": DECODE_SOURCE,
        "replaces": "src/repro/kernels/flash_attention/decode_kernel.py:70",
        "launches": int8_launches["flash_decode_int8"],
        "launches_note": "phase 21: on every layer's served int8 cache at the first and last "
                         "decode steps; the served decode attends through the plain attention, "
                         "as the reference's does",
        "max_abs_err": worst["flash_decode_int8"],
        **{k: decode_row[k] for k in timing_keys},
        **{k: decode_row[k] for k in ("sdpa_dequantized_ms", "tb_per_s", "host_ms", "splits",
                                      "launch_floor_ms", "shape")},
        "decode_32k": {k: decode_long[k] for k in (*timing_keys, "sdpa_dequantized_ms", "tb_per_s",
                                                   "host_ms", "splits", "shape", "max_abs_err")},
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
