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
             D=256, window 2048; olmoe-1b-7b: MHA, D=128; whisper-base's
             encoder: H=8, D=64, bidirectional; internvl2-26b: GQA 48/8,
             D=128, S=2304), MQA at D=256 with
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
9. timings — the flash kernel at the five serve shapes (median of 50 launches)
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
             phase and peak memory, one warm wave of CLIENTS_PROFILE_STEPS
             (2) steps profiled (launches, card busy share), and 4 clients
             of round 2's wave card against CPU within TWIN_REL_TOL (the
             control, the CNN's ``fc`` fed NCHW-flattened features, must
             fail it).  Then phase 3's ragged
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
             wall (both worlds), the run's wall untraced and traced (one
             run each) and against the tenants one after the other, and the
             analytical against the measured seconds of one client step.
25. multihost — the flat deployment of ``repro_torch.launch.multihost``:
             its world (8 clients, 3 rounds, 8 participants, 2 local steps of
             batch 8) at the repo's MLP width (hidden 128), every process on
             the card.  Gates: (a) ``run_multihost`` — the FLServer here and 8
             spawned worker processes over loopback TCP, codec v2 — against
             ``run_local_inline`` (the same workers in this process over a
             LocalTransport): params bit for bit, 8 completed every round,
             ``wire_bytes`` above 0 and monotone; (b) the same with int8
             uplink compression (``QuantizedTensor`` as a native v2 segment):
             params bit for bit, every upload the server received int8
             ``QuantizedTensor`` leaves and ``comm_bytes`` equal to their
             ``tree_wire_bytes``, fewer payload bytes on the wire than (a);
             (c) 4 clients × 2 rounds through a ``ChaosProxy`` that kills
             every worker's connection once and sends every third client
             frame twice: each worker killed once and resumed, ``completed``
             [4, 4], params bit for bit against the fault-free inline run;
             (d) (a)'s history on the simulated clock equal to a CPU inline
             run of the same world, the params' change over the campaign
             (final less initial) within MH_UPDATE_REL_TOL of the CPU's, leaf
             by leaf, and the control (the card's inline run with one
             client's delta zeroed each round) outside it.  No kernel is
             on this path (a worker trains client by client): every count is
             0 around each run of this process.  Printed only: each round's
             wall by phase on the server (DISPATCH holds the broadcast, the
             workers' steps and the uploads), the workers' ``train_s`` from
             their stats blobs, the time from the spawn to the first
             REGISTER, the wire bytes by share per round, inline against
             socket wall.
26. hier   — the hierarchical tree of ``repro_torch.fed.hier``: a
             ``RootAggregator`` in this process, each leaf a process spawned
             with ``run_leaf``.  Gates: (a) examples/hier_tree.py's world,
             cut to HIER_CLIENTS (500) ``SimWorker``s (1,000 there) on
             driver threads over 2 leaves (pods
             ``cid % 2``), 2 rounds, template w 16x16 + b 16 — under none,
             int8 and topk: the root's params digest equal to
             ``run_flat_campaign``'s, and the ``none`` digest equal to
             HIER_FLAT_DIGEST (the reference's; a CPU test holds it); then
             HIER_MLP_CLIENTS (128) clients with the main path's client
             (784→128→128→62, f32) as template; (b) examples/hier_tree.py's pinned chaos at 200
             clients (leaf 0's uplink through a proxy corrupting two frames,
             leaf 1's pod through a FaultSchedule killing every connection
             at its frame 3 and blackholing its first client for 4 frames):
             digest equal to flat, at least one frame corrupted and one
             connection killed; (c) tests/test_faults.py:376 — a journaling
             leaf (checkpoint every 2 folds) SIGKILLed once 3 uploads of round
             0 are journaled and restarted on its port and journal: digest
             equal to flat, both rounds closed FULL with their full count,
             no (client, round) journaled twice; (d) tests/test_hier.py:358 —
             100,000 clients over 8 leaf accumulators in this process, every
             partial through the codec: equal to flat; (e) phase 25's world
             through the tree — 8 ``run_worker`` processes on the card dial 2
             leaves, the root's one ``train_round`` from the world's initial
             params against every client trained here on the card as
             ``ClientWorker`` does and folded into one ``ExactAccumulator``:
             the means' digests equal, count 8, weight the sum of ``n``.  No
             kernel is on this path: every count is 0 around the phase.
             Printed only: each round's ``train_round`` wall, spawn to each
             leaf's ``ready_queue`` report, each leaf's PARTIAL_SUM bytes a
             round against the bytes of the uploads it took in, the
             ``hier.*`` and ``fault.*`` counters, fold ms a client at both
             template widths, the 100,000-client wall;
27. whisper — ``serve`` on whisper-base at its published width (6 encoder
             + 6 decoder layers, d_model 512, 8 heads, vocab 51,865),
             frames 4 × 2048 × 512 and prompt 2048 drawn from the seed, 32
             greedy steps: 12 flash launches a prefill (6 bidirectional),
             all on wgmma; cross-attention runs ``attention_chunked``, as
             the reference's.  Its twin as phase 8's with K rolled alone as
             the control (K and V rolled together only permute an unmasked
             attention's keys); the logits barely see attention at random
             init, so the controls are printed, and every self-attention
             launch of the prefill is held on its own served inputs, kernel
             against plain: bf16 within 2e-2, f32 within 2e-5 with the
             K-rolled kernel outside it at every layer;
28. internvl2 — with every earlier model freed, ``serve`` on internvl2-26b
             at its published width (48 layers, d_model 6144, 48 heads over
             8 KV heads of 128, d_ff 16,384, vocab 92,553, bf16 weights), 256
             patch embeddings and prompt 2048, 32 greedy steps from position
             2304: 48 flash launches a prefill, all on wgmma; its twin with
             attention through ``attention_chunked`` and K rolled alone as
             the control (with K and V rolled together the last causal row
             sees every pair); the peak memory of the serve and the twin;
29. train  — LM training: (a) ``repro_torch.launch.train.train`` on
             qwen1.5-0.5b at its published width (24 layers, d_model 1024,
             vocab 151,936, f32 parameters, bf16 compute, remat ``full``,
             AdamW with clip 1.0), 4 silos x 4 local steps of batch 8 x 128:
             3 rounds under ``none`` checkpointed every round, 2
             (TRAIN_INT8_ROUNDS) under ``int8``; the loss finite every round
             and lower in the last round than in the first, ``comm_bytes``
             under ``none`` = 4 x 3 x the f32 parameter bytes (int8: 4 x 2 x
             a byte a parameter + 4 a leaf), the last checkpoint restoring
             the run's parameters bit for bit, a run resumed from it (one round) against the same
             round run from the parameters in memory: ``comm_bytes`` equal,
             loss within TRAIN_RESUME_REL_TOL (the embedding's backward sums
             with atomics); each round's wall by phase, one train step's
             median wall, tokens/s, peak memory and card busy share; (b)
             one step of qwen-100m in f32 (TF32 off) on the card and on the
             CPU from the same parameters and batch: loss within 1e-5
             relative, the gradients' global relative L2 within 1e-4, and
             the card's with the tokens rolled by one outside it; (c)
             olmoe-1b-7b at full width cut to 4 of its 16 layers (AdamW
             state fits one card), two train steps of batch 8 x 128 (8,192
             routed rows a layer over 64 experts), counted: 36 ``gmm``
             launches a step (forward, remat recompute, dx; every one on
             wgmma) and 12 ``tgmm`` (wgmma), a finite loss; layer 0's
             captured expert products, dx and dw of the kernel route
             against autograd through the plain loop in f32 (1e-4) and
             bf16 (2e-2) relative norms, group sizes rolled by one as the
             control; ``gmm`` (forward and dx on wᵀ as a view) and ``tgmm``
             timed at those shapes beside the plain loop,
             ``torch._grouped_mm`` and the bound; (d) two train steps each
             of whisper-base (``encdec_loss``, frames drawn from the seed)
             and mamba2-1.3b at full width: a finite loss, every parameter
             leaf changed, walls and peak memory.  Every other kernel reads
             0 launches in the phase, ``flash_attention_bwd`` too;
30. train through flash — the backward of ``flash_attention``
             (``csrc/flash_attention_bwd.cu``: delta, dK/dV, dQ; FFMA) and
             training on it under ``attn_impl="pallas"``: (a) on every
             FLASH_CASES case in f32 and bf16 (the forward on the path its
             dtype takes), the forward's lse within 1e-5 of
             ``attention_lse_ref`` and dq, dk, dv against
             ``attention_bwd_ref`` (f32 allclose 1e-4; bf16 relative norms
             2e-2 against the plain version in f32 on the same inputs), K
             rolled by one position failing every limit (the lse's only
             where a mask makes the roll visible); (b) the backward timed
             at the training shape (8 x 128, qwen's heads; f32 too) and the
             five serve shapes beside its plain version, the library
             (``torch.autograd.grad`` over one SDPA output) and its bound,
             with the FLOPs it issues; (c) phase 29's qwen-100m twin on the
             flash route (card: the ffma forward and the backward; CPU: the
             plain versions), 24 forward and 24 backward launches;
             qwen1.5-0.5b at full width, 4 steps on the chunked route and 4
             on the flash route from the same parameters and batch: 48
             forward launches a step (24 layers, 24 remat recomputes, all
             wgmma) and 24 backward calls (three launches each), finite and
             falling losses, the first within 2e-2 of the chunked route's,
             layers 0 and 23's backward on their captured inputs within
             bf16's 2e-2 with K rolled outside it, each route's walls,
             launches, busy share and peak memory; one whisper-base step:
             12 self-attentions on the kernels (6 bidirectional; twice each
             forward under remat), cross-attention on
             ``attention_chunked``, every leaf changed.  Every other kernel
             reads 0 launches.  No earlier phase launches a backward
             kernel (``ops.BWD_LAUNCHES`` is 0 when the phase starts);
31. train through ssd_scan — the backward of ``ssd_scan``
             (``csrc/ssd_scan_bwd.cu``: states, dchunk, group_sum; FFMA) and
             training on it under ``ssm_impl="pallas"``: (a) on every
             SSD_CASES case in f32 and bf16, with and without a cotangent of
             the final state, dx, ddt, da, dB, dC against ``ssd_bwd_ref``
             (f32 allclose 1e-4 against it run in f64, relative norms at the
             serve shape as phase 10 holds the forward there; bf16 relative
             norms 2e-2 against it in f32 on the same inputs), the f32 plain
             version's own distance to f64 printed, B and C rolled one step
             together failing every limit, the strong decay's gradients
             finite; (b) the backward timed at mamba2-1.3b's training shape
             (8 x 128; f32 too) and its serve shape beside the plain version
             (autograd through ``ssd_chunked`` at chunk 256) and the bound,
             with the FLOPs it issues; (c) mamba2-1.3b at full width (48
             layers, remat full, AdamW), 4 steps on the chunked route and 4
             on the kernel route from the same parameters and batch: 96
             forward launches a step (layers and remat recomputes, all
             wgmma) and 48 backward calls, finite and falling losses, the
             first within 2e-2 of chunked's, layers 0 and 47's backward on
             their captured inputs within bf16's 2e-2 with B and C rolled
             outside it, each route's walls, launches, busy share and peak;
             (d) mamba2-1.3b cut to 2 layers in f32, one step card (kernels)
             against CPU (plain versions): loss 1e-5, gradients 1e-4, tokens
             rolled outside it.  Every other kernel reads 0 launches; no
             earlier phase launches ``ssd_scan_bwd`` (``run_serve`` and
             phase 29 (d) assert it, ``ssd_ops.BWD_LAUNCHES`` is 0 when the
             phase starts).
32. train through rglru_scan — the backward of ``rglru_scan``
             (``csrc/rglru_scan_bwd.cu``: one launch, h recomputed in f32,
             then one reverse scan) and training on it and flash under
             ``rglru_impl="pallas"``, ``attn_impl="pallas"``: (a) on every
             RGLRU_CASES case in f32 and bf16, with and without a cotangent
             of the final state, dlog_a and db against ``rglru_bwd`` (f32
             allclose 1e-4 against it run in f64, the serve shape too;
             bf16 relative norms 2e-2 against it in f32), log_a
             and b rolled one step together failing every limit; (b) the
             backward timed at recurrentgemma-9b's training shape (8 x 128 x
             4096) and its serve shape, f32, beside the plain version
             (autograd through ``rglru_associative``) and the bound, and the
             flash backward at its training shape (MQA, D = 256); (c)
             recurrentgemma-9b at full width cut to 5 of its 38 layers (its
             two groups once each; bf16 parameters, AdamW), 4 steps on the
             plain routes and 4 on the kernel routes from the same
             parameters and batch: 8 ``rglru_scan`` and 2 flash forward
             launches a step (layers and remat recomputes), 4 and 1 backward
             calls, finite and falling losses, the first within 2e-2 of the
             plain routes', the first and last RG-LRU layers' backward on
             their captured inputs (relative norms 1e-4 against f64, log_a
             and b rolled outside it), each route's walls, launches, busy
             share and peak; (d) its (rglru, rglru) group in f32 at full
             width, one step card (kernels) against CPU (plain versions):
             loss 1e-5, gradients 1e-4, tokens
             rolled outside it.  Every other kernel reads 0 launches; no
             earlier phase launches ``rglru_scan_bwd``.

The last three lines are ``{"kernels": [...]}`` (``gmm`` with the launches
of phases 3, 18, 23, 24, 25, 26 and 29, ``tgmm`` with those of phases 3, 23, 24, 25, 26 and 29, by path too, with worst
errors and times by path, olmoe's wgmma times and the train step's, ``flash_attention`` with
those of phases 7, 14, 18, 21, 27, 28, 30 and 32 (and how many were bidirectional),
``flash_attention_bwd`` with phases 30 and 32's calls, worst errors by dtype and its
times at the six shapes, ``ssd_scan`` with those of phases 12 and 31,
``ssd_scan_bwd`` with phase 31's calls, worst errors by dtype and its times
at the training and serve shapes,
``rglru_scan`` with those of phases 14 and 32, ``rglru_scan_bwd`` with phase
32's calls, worst errors by dtype and its times at the training and serve
shapes, ``flash_decode_int8`` with those of
phase 21 and its decode_32k-length reading; flash and ``ssd_scan`` also by kernel path, with worst errors and
times by path, their ``ms`` and ``max_abs_err`` the bf16 ``wgmma`` path's; every kernel's
``launches_by_path`` also holds its launches in phase 26, 0),
the card's name and power limit as ``nvidia-smi`` prints them, and
``{"ok": true, "device": {...}}``.  The script uses one card: unless
``CUDA_VISIBLE_DEVICES`` names exactly one, it is set to the first.
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import json
import math
import os
import re
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
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
WHISPER_ARCH, INTERNVL_ARCH = "whisper-base", "internvl2-26b"
# whisper-base's encoder (bidirectional; its decoder's self-attention is the
# same shape, causal) and internvl2-26b's prefill: 256 patches + the prompt
WHISPER_ENC_SHAPE = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 8, 8, 64, False, None)
INTERNVL_PREFIX = SERVE_PROMPT + 256
INTERNVL_ATTN_SHAPE = (SERVE_BATCH, INTERNVL_PREFIX, INTERNVL_PREFIX, 48, 8, 128, True, None)
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
    ("serve shape (whisper-base encoder)", WHISPER_ENC_SHAPE),
    ("serve shape (internvl2-26b, GQA 6:1)", INTERNVL_ATTN_SHAPE),
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
    run must show ``expected`` launches of each kernel.  The flash launches
    without the causal mask (an encoder's) are tallied beside them."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch.serve import serve
    from repro_torch.models.lm import make_lm_cache
    from repro_torch.tree import tree_leaves

    kw = dict(batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, seed=0)
    serve(cfg, decode_steps=1, log=lambda *a: None, **kw)   # warm: allocator, library handles
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for counts in (*counters, fa_ops.PATH_LAUNCHES, ssd_ops.PATH_LAUNCHES):
        for key in counts:
            counts[key] = 0
    real, masks = fa_ops.flash_attention, []

    def tally(q, k, v, *a, **kw):
        masks.append(kw.get("causal", True))
        return real(q, k, v, *a, **kw)

    with mock.patch.object(fa_ops, "flash_attention", tally):
        res = serve(cfg, decode_steps=SERVE_STEPS,
                    log=lambda *a: say("  " + " ".join(map(str, a))), **kw)
    launches = {k: v for counts in counters for k, v in counts.items()}
    flash_paths, ssd_paths = dict(fa_ops.PATH_LAUNCHES), dict(ssd_ops.PATH_LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    b, s = SERVE_BATCH, SERVE_PROMPT
    n_prefix = s + cfg.n_vision_tokens
    param_gb = sum(t.numel() * t.element_size() for t in tree_leaves(res["params"])) / 1e9
    cache, _ = make_lm_cache(cfg, b, n_prefix + SERVE_STEPS + 1, "meta",
                             enc_len=s if cfg.is_encdec else 0)
    cache_gb = sum(t.numel() * t.element_size() for t in tree_leaves(cache)) / 1e9
    say(f"  prefill {res['prefill_s']:.4f} s ({b * s / res['prefill_s']:.0f} tok/s), decode "
        f"{res['decode_s']:.4f} s ({b * SERVE_STEPS / res['decode_s']:.1f} tok/s); launches "
        f"{launches}, flash by path {flash_paths} ({masks.count(False)} without the causal "
        f"mask), ssd_scan by path {ssd_paths}; weights {param_gb:.2f} GB, decode cache "
        f"{cache_gb:.2f} GB, peak allocated {peak_gb:.2f} GB")
    assert launches == expected, (launches, expected)   # every launch in the prefill
    # every served prefill computes in bf16 with 16-byte rows: all on the tensor cores;
    # serving takes no gradient
    assert flash_paths == {"ffma": 0, "wgmma": launches["flash_attention"], "bwd_ffma": 0}, \
        flash_paths
    assert ssd_paths == {"ffma": 0, "wgmma": launches["ssd_scan"], "bwd_ffma": 0}, ssd_paths
    assert len(masks) == launches["flash_attention"], masks
    launches["flash_attention_by_path"] = flash_paths
    launches["flash_attention_noncausal"] = masks.count(False)
    launches["ssd_scan_by_path"] = ssd_paths
    res["peak_gb"] = peak_gb
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
    batch, n_prefix = serve_inputs(cfg, res, SERVE_STEPS)
    with torch.no_grad():
        profile_call(torch, f"one prefill ({SERVE_BATCH} x {n_prefix} positions)",
                     lambda: fns.prefill(res["params"], batch), share_of=kernels)
        _, cache = fns.prefill(res["params"], batch)
        step = {"token": res["tokens"][:, 0], "pos": n_prefix}
        profile_call(torch, "one decode step (batch 4)", lambda: fns.decode(res["params"], cache, step),
                     share_of=kernels)


# ---------------------------------------------------------------- phase 8


def rel_norm(got, want):
    """‖got − want‖ / ‖want‖, in f32."""
    return float((got.float() - want.float()).norm() / want.float().norm())


def serve_inputs(cfg, res, steps):
    """The prefill's inputs of a served run ``res`` (its prompts and stubs)
    with a cache for ``steps`` decode steps, and the first decode position."""
    n_prefix = res["prompts"].shape[1] + cfg.n_vision_tokens
    batch = {"tokens": res["prompts"], "cache_len": n_prefix + steps + 1}
    for key in ("frames", "patch_embeds"):
        if res[key] is not None:
            batch[key] = res[key]
    return batch, n_prefix


def teacher_forced_logits(torch, cfg, res, tokens=None):
    """Last-token logits of the prefill of the served run ``res``, then of
    each decode step fed ``tokens`` (default: the served tokens); and the
    cache after the last of them."""
    from repro_torch.models.registry import model_fns

    fns = model_fns(cfg)
    tokens = res["tokens"] if tokens is None else tokens
    steps = tokens.shape[1] - 1
    batch, n_prefix = serve_inputs(cfg, res, steps)
    with torch.no_grad():
        logits, cache = fns.prefill(res["params"], batch)
        out = [logits]
        for i in range(steps):
            logits, cache = fns.decode(res["params"], cache,
                                       {"token": tokens[:, i], "pos": n_prefix + i})
            out.append(logits)
    return out, cache


def roll_kv(torch, real):
    """The flash kernel fed K/V rolled by one position: each query also sees the next key."""
    def rolled(q, k, v, *a, **kw):
        return real(q, torch.roll(k, -1, dims=1), torch.roll(v, -1, dims=1), *a, **kw)
    return rolled


def roll_k(torch, real):
    """The flash kernel fed K alone rolled by one position, so each key
    meets its neighbour's value.  (Rolling K and V together only permutes
    the keys of an unmasked, bidirectional attention: its output would not
    change.)"""
    def rolled(q, k, v, *a, **kw):
        return real(q, torch.roll(k, -1, dims=1), v, *a, **kw)
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


def serve_twin(torch, cfg, res, plain_routes, control, control_f32=None, floor_routes=None,
               control_gate=True):
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
    the bf16 limit is then held layer by layer (``layer_twin``).

    With ``control_gate`` False the controls are printed, not asserted: for
    a model whose logits barely see the kernel's work (whisper's, at random
    init), which the caller then holds layer by layer."""
    kernel_cfg = cfg.replace(**KERNEL_ROUTES)
    plain_cfg = kernel_cfg.replace(**plain_routes)

    def rel_all(got, want):
        num = sum(float((a.float() - b.float()).norm()) ** 2 for a, b in zip(got, want))
        den = sum(float(b.float().norm()) ** 2 for b in want)
        return math.sqrt(num / den)

    def readings(over, tokens, patches):
        plain, plain_cache = teacher_forced_logits(torch, plain_cfg.replace(**over), res, tokens)
        plain_states = final_states(plain_cache)
        del plain_cache      # the caches of a large model: keep one alive at a time
        kernel, kernel_cache = ((res["logits"], None) if tokens is res["tokens"] else
                                teacher_forced_logits(torch, kernel_cfg.replace(**over), res,
                                                      tokens))
        kernel_states = final_states(kernel_cache) if kernel_cache is not None else []
        del kernel_cache
        with contextlib.ExitStack() as stack:
            for module, attr, roll in patches:
                stack.enter_context(
                    mock.patch.object(module, attr, roll(torch, getattr(module, attr))))
            wrong, wrong_cache = teacher_forced_logits(torch, kernel_cfg.replace(**over), res,
                                                       tokens)
        wrong_states = final_states(wrong_cache)
        del wrong_cache
        states = ()
        if kernel_states and plain_states:
            states = (rel_all(kernel_states, plain_states), rel_all(wrong_states, plain_states))
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
        floor, _ = teacher_forced_logits(torch, plain_cfg.replace(**floor_routes), res)
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
    if not control_gate:
        say(f"  the controls are not asserted end to end (the logits barely see this kernel's "
            f"work): held layer by layer below")
    if bf16_asserted:
        assert max(sound) < SERVE_TWIN_REL_TOL, sound
        assert not control_gate or max(control_r) > SERVE_TWIN_REL_TOL, control_r
    assert sound32[0] < SERVE_TWIN_F32_REL_TOL, sound32
    assert not control_gate or control32[0] > SERVE_TWIN_F32_REL_TOL, control32
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


def attention_layer_twin(torch, cfg, res, roll):
    """Every self-attention launch of the served prefill through the kernel
    and through the plain version on the inputs the kernel saw there, so no
    layer's difference is carried into the next: in bf16 compute (the
    wgmma path) within 2e-2 and in f32 compute (the ffma path) within 2e-5,
    as relative norms, phase 6's tolerances; in f32 the kernel fed
    ``roll``'s inputs must exceed that limit at every layer.  (In bf16 the
    plain version's own rounding is of the size of what a roll changes at
    random init, so there the control is printed.)  Returns the largest bf16
    relative norm."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models.registry import model_fns

    real = fa_ops.flash_attention
    rolled = roll(torch, real)
    rows = []

    def compare(q, k, v, *a, **kw):
        got = real(q, k, v, *a, **kw)
        want = fa_ref.attention_ref(q, k, v, causal=kw["causal"], window=kw.get("window"))
        wrong = rolled(q, k, v, *a, **kw)
        rows.append((kw["causal"], rel_norm(got, want), rel_norm(wrong, want),
                     float((got.float() - want.float()).abs().max()), tuple(q.shape)))
        return got

    batch, _ = serve_inputs(cfg, res, SERVE_STEPS)
    worst = 0.0
    for cd, tol in (("bfloat16", 2e-2), ("float32", 2e-5)):
        rows.clear()
        with torch.no_grad(), mock.patch.object(fa_ops, "flash_attention", compare):
            model_fns(cfg.replace(compute_dtype=cd, **KERNEL_ROUTES)).prefill(res["params"], batch)
        causal, sound, wrong, err, shape = rows[0]
        say(f"  {cd} compute, layer 0's {'causal' if causal else 'bidirectional'} flash launch "
            f"on its served inputs {shape}: kernel against plain {sound:.3e} (max|err| "
            f"{err:.3e}), {roll.__name__} {wrong:.3e}")
        for kind, rs in (("bidirectional", [r for r in rows if not r[0]]),
                         ("causal", [r for r in rows if r[0]])):
            if rs:
                say(f"  {cd} compute, each of {len(rs)} {kind} launches on its own served inputs: "
                    f"kernel against plain {max(r[1] for r in rs):.3e} (largest), "
                    f"{roll.__name__} {min(r[2] for r in rs):.3e} (smallest); limit {tol:g}")
        assert len(rows) == cfg.total_layers + cfg.n_enc_layers, len(rows)
        assert max(r[1] for r in rows) < tol, (cd, rows)
        if cd == "float32":
            assert min(r[2] for r in rows) > tol, (cd, rows)
        else:
            worst = max(r[1] for r in rows)
    return worst


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
    mask = dict(causal=causal, window=window)
    row = {
        "path": "wgmma",
        "ms": median_ms(torch, lambda: fa_ops.flash_attention(q, k, v, **mask)),
        "ffma_bf16_ms": median_ms(torch, lambda: fa_ops.flash_attention(q, k, v, **mask,
                                                                       path="ffma")),
        "f32_ms": median_ms(torch, lambda: fa_ops.flash_attention(q32, k32, v32, **mask)),
        "plain_ms": median_ms(torch, lambda: fa_ref.attention_ref(q, k, v, **mask), reps=10),
        "library_ms": median_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=causal,
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
    say(f"  flash_attention B={b} S={sq} Hq={hq} Hk={hk} D={d} "
        f"{'causal' if causal else 'bidirectional'} window={window}: bf16 wgmma "
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
        logits, _ = teacher_forced_logits(torch, cfg, res)
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
    got, _ = teacher_forced_logits(torch, f32, res)
    want, _ = teacher_forced_logits(torch, f32.replace(**plain), res)
    real = ops.grouped_matmul
    with mock.patch.object(ops, "grouped_matmul",
                           lambda x, w, gs: real(x, torch.roll(w, -1, dims=0), gs)):
        wrong, _ = teacher_forced_logits(torch, f32, res)
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
# the profiled warm wave's local steps: a step's launches and busy share are
# those of every step, and the profiler's tally of a 10-step LSTM wave
# (~48,000 launches) took ~50 s of the phase
CLIENTS_PROFILE_STEPS = 2
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
                               f"{CLIENTS_PROFILE_STEPS} steps x batch {CLIENTS_BATCH})",
                        lambda: ex.run_wave(last["start"], [by_id[c] for c in last["cids"]],
                                            CLIENTS_PROFILE_STEPS))
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
    turns = [run_fabric(torch, ops, mcfg, "cuda", trace=t) for t in (False, True)]
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


# ---------------------------------------------------------------- phase 25

#: phase 25's world: repro_torch.launch.multihost's deployment world (8
#: clients, 3 rounds, 8 participants, 2 local steps, batch 8) at the repo's
#: MLP width (SmallModelConfig's default hidden, 128; WorldSpec's is 16)
MH_HIDDEN = 128
MH_ROUND_TIMEOUT = 300.0
#: the fault-injection world and plan: every worker's connection killed
#: once after two frames, every third client frame sent twice
MH_CHAOS_WORLD = dict(n_clients=4, rounds=2, participants_per_round=4)
MH_CHAOS_PLAN = dict(kill_after_frames=2, kill_times=1, duplicate_every=3)
#: (d)'s limit: the largest per-leaf ‖Δcard − Δcpu‖ / ‖Δcpu‖ of the params'
#: change over the campaign (Δ = final − initial params); read 4.5e-6 on an
#: H100, the zeroed-delta control 0.39
MH_UPDATE_REL_TOL = 1e-4


@contextlib.contextmanager
def phase_walls(torch, walls):
    """Every ``FederatedTrainer`` round's wall seconds by phase, appended to
    ``walls`` (one dict a round; the card synchronized after each phase).
    Under a dispatcher DISPATCH holds the remote training: the broadcast,
    the workers' steps and the uploads over the wire."""
    from repro_torch.fed.trainer import FederatedTrainer, RoundPhase

    step_round = FederatedTrainer.step_round

    def timed(self, st):
        phase = st.phase
        if phase is RoundPhase.SAMPLE:
            walls.append({})
        t0 = time.perf_counter()
        out = step_round(self, st)
        sync(torch, self.device)
        walls[-1][phase.value] = walls[-1].get(phase.value, 0.0) + time.perf_counter() - t0
        return out

    with mock.patch.object(FederatedTrainer, "step_round", timed):
        yield


def zero_launches(counters):
    for counts in counters:
        for k in counts:
            counts[k] = 0


def multihost_run(torch, counters, label, run, device=None):
    """One deployment run with every kernel count set to 0 just before it
    and read just after (the parent process's: a worker's launches are its
    own process's, and a worker trains client by client, with no kernel on
    its path): the trainer, its phase walls, the wall and the launches."""
    walls = []
    zero_launches(counters)
    sync(torch, device or "cuda")
    t0 = time.perf_counter()
    with phase_walls(torch, walls):
        trainer = run()
    sync(torch, device or "cuda")
    wall = time.perf_counter() - t0
    launches = {k: v for counts in counters for k, v in counts.items()}
    hist = trainer.history
    for rec in hist:
        for k, v in rec.items():
            if "loss" in k or k.endswith("_ce"):
                assert math.isfinite(v), (label, k, v)
    say(f"  {label}: wall {wall:.3f} s, completed {[r['completed'] for r in hist]}, "
        f"kernel launches in this process {launches}")
    for i, w in enumerate(walls, 1):
        say(f"    round {i} phase wall s: " + ", ".join(f"{k} {v:.4f}" for k, v in w.items()))
    return {"trainer": trainer, "walls": walls, "wall": wall, "launches": launches}


def same_bits(torch, a, b):
    from repro_torch.tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(la, lb))


def say_bit_gap(torch, a, b):
    """Where two parameter trees differ: each leaf's max |Δ| and how many
    elements differ (printed before a bit-identity gate fails)."""
    from repro_torch.tree import tree_flatten_with_path

    for (path, x), (_, y) in zip(tree_flatten_with_path(a), tree_flatten_with_path(b)):
        x, y = x.cpu(), y.cpu()
        say(f"    {path}: max |Δ| {float((x - y).abs().max()):.3e}, "
            f"{int((x != y).sum())} of {x.numel()} elements differ")


def socket_run(torch, counters, label, spec, chaos=None, device=None):
    """``run_multihost`` over a server transport that notes its first
    frame: 8 (or 4) spawned workers on the card over loopback TCP; with
    ``chaos`` the workers dial a ``ChaosProxy``.  Adds the time from the
    spawn to the first REGISTER, the server's per-session wire stats (the
    workers' stats blobs) and the proxy."""
    from repro_torch.fed.net import ChaosProxy, FaultPlan, SocketServerTransport
    from repro_torch.launch.multihost import run_multihost

    class FirstFrame(SocketServerTransport):
        first_at = None

        def _ingest(self, sess, body):
            if self.first_at is None:
                self.first_at = time.perf_counter()
            super()._ingest(sess, body)

    transport = FirstFrame(spec.host, spec.port, protocol_version=spec.wire_version)
    proxy = (ChaosProxy(transport.host, transport.port, FaultPlan(**chaos))
             if chaos is not None else None)
    connect = (proxy.host, proxy.port) if proxy is not None else None
    t_spawn = time.perf_counter()
    try:
        res = multihost_run(torch, counters, label, lambda: run_multihost(
            spec, transport=transport, connect=connect, round_timeout=MH_ROUND_TIMEOUT,
            device=device), device)
    finally:
        if proxy is not None:
            proxy.close()
    res.update(transport=transport, proxy=proxy, stats=transport.session_stats(),
               first_register_s=transport.first_at - t_spawn)
    peers = {cid: s.get("peer", {}) for cid, s in sorted(res["stats"].items())}
    say(f"    spawn to the first REGISTER {res['first_register_s']:.3f} s; the workers' "
        f"last train_s " + ", ".join(f"{c}: {p.get('train_s')}" for c, p in peers.items())
        + "; train_s_total " + ", ".join(f"{c}: {p.get('train_s_total')}"
                                         for c, p in peers.items()))
    for rec in res["trainer"].history:
        say(f"    round {rec['round']}: wire_bytes {rec['wire_bytes']}, wire_payload_bytes "
            f"{rec['wire_payload_bytes']}, wire_header_bytes {rec['wire_header_bytes']}, "
            f"comm_bytes {rec['comm_bytes']}")
    return res


@contextlib.contextmanager
def dispatched_uploads(uploads, zero_first=False):
    """Every round's uploads as ``ControlPlaneDispatcher.train_round`` hands
    them to the trainer, one list a round, appended to ``uploads``.  With
    ``zero_first`` (the control of gate (d)) the first reporting client's
    delta reaches the trainer as zeros, its weight kept."""
    import numpy as np

    from repro_torch.launch.multihost import ControlPlaneDispatcher
    from repro_torch.tree import tree_map

    train_round = ControlPlaneDispatcher.train_round

    def wrapped(self, *a, **kw):
        out = train_round(self, *a, **kw)
        if zero_first:
            (delta, n, metrics), rest = out[0], out[1:]
            out = [(tree_map(np.zeros_like, delta), n, metrics)] + rest
        uploads.append([delta for delta, _n, _m in out])
        return out

    with mock.patch.object(ControlPlaneDispatcher, "train_round", wrapped):
        yield


def update_gap(torch, a, b, init):
    """Largest per-leaf ‖(a − init) − (b − init)‖ / ‖b − init‖: two runs'
    parameter changes over a campaign from the same initial params."""
    from repro_torch.tree import tree_leaves

    gap = 0.0
    for x, y, z in zip(tree_leaves(a), tree_leaves(b), tree_leaves(init)):
        dx, dy = x.cpu().double() - z.double(), y.cpu().double() - z.double()
        gap = max(gap, float((dx - dy).norm() / dy.norm()))
    return gap


def run_multihost_phase(torch, counters, smi, device=None):
    """Phase 25: the flat multihost deployment on the card (``device``
    None: every process resolves the card), four gates."""
    import dataclasses

    import numpy as np

    from repro_torch.fed.compression import QuantizedTensor, is_compressed_tree, tree_wire_bytes
    from repro_torch.launch.multihost import WorldSpec, build_world, run_local_inline
    from repro_torch.models.small import init_small
    from repro_torch.tree import tree_leaves

    say(f"  card: {smi}")
    spec = WorldSpec(hidden=MH_HIDDEN)
    say(f"  world: {spec}")
    row = {"card": smi}

    say("  (a) 8 worker processes over loopback TCP (codec v2) against the inline run on the card:")
    inline = multihost_run(torch, counters, "inline, LocalTransport", lambda: run_local_inline(spec, device), device)
    sock = socket_run(torch, counters, "socket, 8 spawned workers", spec, device=device)
    a_hist = sock["trainer"].history
    a_same = same_bits(torch, inline["trainer"].params, sock["trainer"].params)
    wires = [r["wire_bytes"] for r in a_hist]
    say(f"  (a) params bit for bit: {a_same}; completed {[r['completed'] for r in a_hist]}; "
        f"wire_bytes {wires}; inline wall {inline['wall']:.3f} s against socket "
        f"{sock['wall']:.3f} s ({sock['wall'] / inline['wall']:.2f}x)")
    if not a_same:
        say_bit_gap(torch, inline["trainer"].params, sock["trainer"].params)
    assert a_same
    assert all(r["completed"] == spec.participants_per_round for r in a_hist), a_hist
    assert wires[0] > 0 and wires == sorted(wires), wires
    assert [r["mode"] for r in a_hist] == ["FULL"] * spec.rounds

    say("  (b) the same with int8 uplink compression (QuantizedTensor as a native v2 segment):")
    spec_b = dataclasses.replace(spec, compression="int8")
    inline_b = multihost_run(torch, counters, "inline, int8", lambda: run_local_inline(spec_b, device), device)
    uploads = []
    with dispatched_uploads(uploads):
        sock_b = socket_run(torch, counters, "socket, int8", spec_b, device=device)
    b_hist = sock_b["trainer"].history
    b_same = same_bits(torch, inline_b["trainer"].params, sock_b["trainer"].params)
    assert len(uploads) == spec.rounds and all(
        is_compressed_tree(u) and all(isinstance(q, QuantizedTensor) and q.q.dtype == np.int8
                                      for q in tree_leaves(u))
        for ups in uploads for u in ups), "an upload did not arrive as int8 QuantizedTensors"
    expect = list(itertools.accumulate(sum(tree_wire_bytes(u) for u in ups) for ups in uploads))
    comm = [r["comm_bytes"] for r in b_hist]
    say(f"  (b) params bit for bit: {b_same}; comm_bytes {comm} against tree_wire_bytes of the "
        f"uploads the server received {expect}; inline comm_bytes "
        f"{[r['comm_bytes'] for r in inline_b['trainer'].history]}; "
        f"wire_payload_bytes int8 {b_hist[-1]['wire_payload_bytes']} against f32 "
        f"{a_hist[-1]['wire_payload_bytes']}")
    if not b_same:
        say_bit_gap(torch, inline_b["trainer"].params, sock_b["trainer"].params)
    assert b_same
    assert comm == expect, (comm, expect)
    assert all(r["completed"] == spec.participants_per_round for r in b_hist), b_hist
    assert b_hist[-1]["wire_payload_bytes"] < a_hist[-1]["wire_payload_bytes"]

    say(f"  (c) fault injection: {MH_CHAOS_WORLD} through a ChaosProxy {MH_CHAOS_PLAN}:")
    spec_c = dataclasses.replace(spec, **MH_CHAOS_WORLD)
    inline_c = multihost_run(torch, counters, "inline, fault-free", lambda: run_local_inline(spec_c, device), device)
    sock_c = socket_run(torch, counters, "socket through the proxy", spec_c, chaos=MH_CHAOS_PLAN,
                        device=device)
    proxy, transport = sock_c["proxy"], sock_c["transport"]
    c_same = same_bits(torch, inline_c["trainer"].params, sock_c["trainer"].params)
    c_completed = [r["completed"] for r in sock_c["trainer"].history]
    say(f"  (c) connections killed {proxy.connections_killed}, frames duplicated "
        f"{proxy.frames_duplicated}, forwarded {proxy.frames_forwarded}; server reconnects "
        f"{transport.reconnects}, duplicates dropped {transport.duplicates_dropped}, "
        f"retransmits {transport.retransmits}; completed {c_completed}; params bit for bit "
        f"against the fault-free inline run: {c_same}")
    if not c_same:
        say_bit_gap(torch, inline_c["trainer"].params, sock_c["trainer"].params)
    assert proxy.connections_killed == spec_c.n_clients, proxy.connections_killed
    assert transport.reconnects >= spec_c.n_clients, transport.reconnects
    assert c_completed == [spec_c.participants_per_round] * spec_c.rounds, c_completed
    assert c_same

    say("  (d) the card against the CPU: the inline run of (a)'s world on the CPU:")
    zero_launches(counters)
    t0 = time.perf_counter()
    cpu = run_local_inline(spec, device="cpu")
    cpu_wall = time.perf_counter() - t0
    diff = {k: [(g[k], w[k]) for g, w in zip(a_hist, cpu.history) if g[k] != w[k]]
            for k in SIM_FIELDS}
    diff = {k: v for k, v in diff.items() if v}
    mcfg, _clients, _test, fed = build_world(spec)
    init = init_small(fed.seed, mcfg, device="cpu")
    gap = update_gap(torch, sock["trainer"].params, cpu.params, init)
    params_rel = params_gap(torch, sock["trainer"].params, cpu.params)
    zeroed = []
    with dispatched_uploads(zeroed, zero_first=True):
        control = run_local_inline(spec, device)
    control_gap = update_gap(torch, control.params, cpu.params, init)
    control_rel = params_gap(torch, control.params, cpu.params)
    say(f"  (d) CPU inline wall {cpu_wall:.3f} s; simulated fields equal: {not diff}; the params' "
        f"change over the campaign, card (socket) against CPU, largest per-leaf relative norm "
        f"{gap:.3e} (limit {MH_UPDATE_REL_TOL:g}; the params themselves {params_rel:.3e}); the "
        f"control, the card's inline run with one client's delta zeroed each round: {control_gap:.3e} "
        f"(the params themselves {control_rel:.3e}); test_acc card {[r['test_acc'] for r in a_hist]}, "
        f"CPU {[r['test_acc'] for r in cpu.history]}")
    assert not diff, diff
    assert gap <= MH_UPDATE_REL_TOL, gap
    assert len(zeroed) == spec.rounds and control_gap > MH_UPDATE_REL_TOL, control_gap
    launches = {name: sum(r["launches"].get(name, 0) for r in
                          (inline, sock, inline_b, sock_b, inline_c, sock_c))
                for name in ("gmm", "tgmm")}
    assert all(v == 0 for r in (inline, sock, inline_b, sock_b, inline_c, sock_c)
               for v in r["launches"].values()), "a kernel launched on the multihost path"

    def summary(res):
        return {"wall_s": res["wall"], "phase_wall_s": res["walls"]}

    def sock_summary(res):
        return {**summary(res), "first_register_s": res["first_register_s"],
                "worker_train_s_total": {c: s.get("peer", {}).get("train_s_total")
                                         for c, s in res["stats"].items()},
                "wire": [{k: r[k] for k in ("wire_bytes", "wire_payload_bytes",
                                            "wire_header_bytes", "comm_bytes")}
                         for r in res["trainer"].history]}

    row.update({
        "a": {"inline": summary(inline), "socket": sock_summary(sock), "bit_identical": a_same},
        "b_int8": {"inline": summary(inline_b), "socket": sock_summary(sock_b),
                   "bit_identical": b_same, "comm_bytes": comm},
        "c_chaos": {"inline": summary(inline_c), "socket": sock_summary(sock_c),
                    "bit_identical": c_same, "killed": proxy.connections_killed,
                    "reconnects": transport.reconnects},
        "d_cpu": {"wall_s": cpu_wall, "update_gap": gap, "params_gap": params_rel,
                  "control_update_gap": control_gap, "control_params_gap": control_rel},
    })
    return launches, row


# ---------------------------------------------------------------- phase 26

#: phase 26(a)'s world, examples/hier_tree.py's cut from 1,000 simulated
#: clients to 500 for the script's time limit (the campaign's walls scale with
#: the clients, the leaves' spawn does not): over 2 leaf processes (pods
#: cid % 2), 2 rounds, template w 16x16 + b 16
HIER_CLIENTS = 500
HIER_ROUNDS = 2
HIER_LEAVES = 2
#: run_flat_campaign's params digest of that world under "none", as the
#: reference computes it (tests/test_torch_hier.py holds it against
#: repro.fed.hier: the card's machine has no JAX)
HIER_FLAT_DIGEST = "0c0e768ae1e918fddd1af6043f95501ade4ef47e2f23e56a61774e0b48e24588"
HIER_MLP_CLIENTS = 128     # (a) again with the main path's client (784->128->128->62) as template
HIER_CHAOS_CLIENTS = 200   # examples/hier_tree.py --chaos --clients 200
HIER_KILL_CLIENTS = 10     # tests/test_faults.py:376's leaf SIGKILL world
HIER_SCALE = (100_000, 8, 2)   # tests/test_hier.py:358: clients, leaf accumulators, rounds
HIER_TIMEOUT = 300.0
#: in-process folds timed a template (fold ms a client)
HIER_FOLD_REPS = {"16x16+16": 500, "femnist-mlp": 32}


def hier_template():
    import numpy as np

    return {"w": np.zeros((16, 16), np.float32), "b": np.zeros(16, np.float32)}


def mlp_template(mcfg):
    """The FEMNIST-MLP client's parameter tree as f32 numpy zeros."""
    import numpy as np

    from repro_torch.bridge import params_to_numpy
    from repro_torch.models.small import init_small
    from repro_torch.tree import tree_map

    return tree_map(np.zeros_like, params_to_numpy(init_small(0, mcfg, device="cpu")))


def raise_fd_limit(want=4096):
    """Room for 1,000 client sockets in this process (examples/hier_tree.py's
    ``_raise_fd_limit``); the spawned leaves inherit the limit."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < want:
        resource.setrlimit(resource.RLIMIT_NOFILE,
                           (min(want, hard) if hard > 0 else want, hard))
    return resource.getrlimit(resource.RLIMIT_NOFILE)[0]


def hier_leaf(leaf_id, root_host, root_port, ready, done, kw):
    """A spawned leaf process: ``run_leaf`` under an ObsPlane whose counters
    it reports on ``done`` once the root has shut it down."""
    from repro_torch.fed.hier import run_leaf
    from repro_torch.obs import ObsPlane

    obs = ObsPlane()
    run_leaf(leaf_id, root_host, root_port, ready_queue=ready, obs=obs, **kw)
    done.put((leaf_id, obs.registry.counters_snapshot()))


def spawn_leaves(ctx, uplinks, **kw):
    """One leaf process (``spawn``) per entry of ``uplinks`` (leaf id -> the
    root address it dials): the processes, each leaf's client port, the
    seconds from the spawn to its ``ready_queue`` report, and the queue its
    counters arrive on at shutdown."""
    ready, done = ctx.Queue(), ctx.Queue()
    procs = {lid: ctx.Process(target=hier_leaf, args=(lid, host, port, ready, done, kw),
                              daemon=True)
             for lid, (host, port) in uplinks.items()}
    t0 = time.perf_counter()
    for p in procs.values():
        p.start()
    ports, ready_s = {}, {}
    for _ in procs:
        lid, port = ready.get(timeout=120.0)
        ports[lid], ready_s[lid] = port, time.perf_counter() - t0
    return procs, ports, ready_s, done


def join_leaves(procs, done):
    """Each leaf's counters (drained before the join), then each leaf's
    exit, which must be clean."""
    counters = dict(done.get(timeout=60.0) for _ in procs)
    for p in procs.values():
        p.join(timeout=60.0)
    assert all(p.exitcode == 0 for p in procs.values()), \
        {lid: p.exitcode for lid, p in procs.items()}
    return counters


def stop_all(procs):
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(timeout=10.0)


def log_rounds(root, log):
    """Wrap ``root.train_round``: each round's wall and each leaf's
    PARTIAL_SUM as a v2 frame (bytes), appended to ``log``."""
    from repro_torch.fed.transport import Message, MsgType, encode_envelope_wire

    train_round = root.train_round

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = train_round(*a, **kw)
        log.append({"wall_s": time.perf_counter() - t0, "partial_bytes": {
            lid: len(encode_envelope_wire(0, 0, Message(MsgType.PARTIAL_SUM, lid, up)).data)
            for lid, up in sorted(root.server.uploads.items())}})
        return out

    root.train_round = timed


def upload_bytes(template, rnd, cids, compression):
    """The v2 frames (bytes) of ``cids``' simulated uploads of round ``rnd``,
    each encoded once here: what their leaf takes in when no frame is lost,
    resent or duplicated."""
    from repro_torch.fed.hier import _client_delta, sim_weight
    from repro_torch.fed.transport import Message, MsgType, encode_envelope_wire

    return sum(len(encode_envelope_wire(0, 0, Message(MsgType.UPLOAD, c, {
        "delta": _client_delta(template, rnd, c, compression), "n": sim_weight(c),
        "round": rnd})).data) for c in cids)


def driver_threads(template, dial, pods, errors):
    """One thread of ``drive_sim_clients`` a pod (16 driver threads each),
    started; a driver's error lands in ``errors``."""
    from repro_torch.fed.hier import drive_sim_clients

    def drive(lid, port, cids):
        try:
            drive_sim_clients("127.0.0.1", port, cids, template, threads=16,
                              timeout=HIER_TIMEOUT, max_reconnect_attempts=40)
        except BaseException as e:      # noqa: BLE001 - checked after the join
            errors.append((lid, repr(e)))

    threads = [threading.Thread(target=drive, args=(lid, dial[lid], cids), daemon=True)
               for lid, cids in pods.items()]
    for t in threads:
        t.start()
    return threads


def join_drivers(threads, errors):
    for t in threads:
        t.join(timeout=120.0)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads), "a client driver hung"


def hier_only(snap):
    """The ``hier.*`` and ``fault.*`` counters of a counters snapshot."""
    return {k: v for k, v in snap.items() if k.startswith(("hier.", "fault."))}


def hier_counters(root_obs, leaf_counters):
    """The ``hier.*`` and ``fault.*`` counters, the root's and each leaf's."""
    return {"root": hier_only(root_obs.registry.counters_snapshot()),
            **{f"leaf {lid}": hier_only(s) for lid, s in sorted(leaf_counters.items())}}


def hier_campaign(ctx, label, template, n_clients, compression="none", chaos=False):
    """A root in this process over 2 spawned leaves and ``n_clients``
    simulated clients on driver threads, ``HIER_ROUNDS`` rounds, against
    ``run_flat_campaign``.  With ``chaos``: examples/hier_tree.py's pinned
    fault script (leaf 0's uplink through a corrupting proxy, leaf 1's pod
    through a FaultSchedule: every connection killed at its frame 3, the
    pod's first client blackholed for 4 frames)."""
    from repro_torch.fed.hier import RootAggregator, run_flat_campaign, run_root_campaign
    from repro_torch.fed.net import (ChaosProxy, FaultEvent, FaultPlan, FaultSchedule,
                                     SocketServerTransport)
    from repro_torch.obs import ObsPlane

    cids = list(range(n_clients))
    pods = {lid: cids[lid::HIER_LEAVES] for lid in range(HIER_LEAVES)}
    obs = ObsPlane()
    root_t = SocketServerTransport("127.0.0.1", 0, obs=obs)
    root = RootAggregator(root_t, obs=obs, round_timeout=HIER_TIMEOUT)
    log = []
    log_rounds(root, log)
    uplinks = {lid: (root_t.host, root_t.port) for lid in pods}
    proxies, sched, procs = {}, None, {}
    try:
        if chaos:
            proxies["uplink"] = ChaosProxy(root_t.host, root_t.port,
                                           FaultPlan(corrupt_after_frames=2, corrupt_times=2))
            uplinks[0] = (proxies["uplink"].host, proxies["uplink"].port)
        procs, ports, ready_s, done = spawn_leaves(ctx, uplinks)
        dial = dict(ports)
        if chaos:
            sched = FaultSchedule([FaultEvent(frame=3, op="kill"),
                                   FaultEvent(frame=2, op="blackhole", client_id=pods[1][0], arg=4)])
            proxies["pod 1"] = ChaosProxy("127.0.0.1", ports[1], schedule=sched)
            dial[1] = proxies["pod 1"].port
        errors = []
        drivers = driver_threads(template, dial, pods, errors)
        t0 = time.perf_counter()
        digest, _ = run_root_campaign(root, pods, template, HIER_ROUNDS, compression=compression)
        wall = time.perf_counter() - t0
        join_drivers(drivers, errors)
        leaf_counters = join_leaves(procs, done)
    finally:
        stop_all(procs.values())
        for p in proxies.values():
            p.close()
        root_t.close()
    t0 = time.perf_counter()
    flat, _ = run_flat_campaign(template, cids, HIER_ROUNDS, compression=compression)
    flat_s = time.perf_counter() - t0
    expected = [{lid: upload_bytes(template, rnd, pod, compression) for lid, pod in pods.items()}
                for rnd in range(HIER_ROUNDS)]
    # the leaf's client-side transport (scope "server" in its ObsPlane):
    # framed bytes both ways over the campaign, resent and duplicated frames included
    leaf_wire = {lid: s["wire.framed_bytes"]["server"] for lid, s in sorted(leaf_counters.items())}
    res = {"digest": digest, "flat_digest": flat, "tree_equals_flat": digest == flat,
           "campaign_wall_s": wall, "flat_wall_s": flat_s,
           "spawn_to_ready_s": ready_s,
           "rounds": [{**r, "upload_bytes_fault_free": b} for r, b in zip(log, expected)],
           "leaf_client_wire_bytes": leaf_wire,
           "root_wire_bytes": root_t.wire_bytes,
           "counters": hier_counters(obs, leaf_counters)}
    if chaos:
        res.update(frames_corrupted=proxies["uplink"].frames_corrupted,
                   connections_killed=proxies["pod 1"].connections_killed,
                   frames_blackholed=proxies["pod 1"].frames_blackholed,
                   schedule_fired={op: sum(ev.op == op for _c, ev in sched.fired)
                                   for op in ("kill", "blackhole")})
    say(f"  {label}: {n_clients} clients, {compression}: tree {digest[:16]}, flat {flat[:16]}, "
        f"equal {res['tree_equals_flat']}; campaign wall {wall:.3f} s (flat in-process "
        f"{flat_s:.3f} s); spawn to ready " + ", ".join(f"leaf {l} {s:.3f} s"
                                                          for l, s in sorted(ready_s.items())))
    for i, r in enumerate(res["rounds"]):
        say(f"    round {i}: train_round wall {r['wall_s']:.4f} s; PARTIAL_SUM bytes "
            f"{r['partial_bytes']} against the uploads' bytes with no fault "
            f"{r['upload_bytes_fault_free']}")
    say(f"    leaves' client-side wire bytes over the campaign (both ways, every frame "
        f"sent or taken in): {leaf_wire}; the root's {root_t.wire_bytes}")
    say(f"    counters {res['counters']}")
    if chaos:
        say(f"    chaos: {res['frames_corrupted']} uplink frames corrupted, "
            f"{res['connections_killed']} client connections killed, "
            f"{res['frames_blackholed']} frames blackholed, schedule fired {res['schedule_fired']}")
    assert digest == flat, (label, digest, flat)
    return res


def free_port():
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def wal_uploads(path, rnd):
    from repro_torch.fed import wal as walmod

    try:
        r = walmod.recover(path).rounds.get(rnd)
    except walmod.WalError:
        return 0
    return len(r.uploads) if r is not None else 0


def hier_leaf_kill(ctx, template, directory):
    """(c): tests/test_faults.py:376's crash-restart on the port: one leaf
    process journaling (checkpoint every 2 folds) SIGKILLed once 3 uploads
    of round 0 are journaled, restarted on its port and journal."""
    from repro_torch.fed import wal as walmod
    from repro_torch.fed.hier import RootAggregator, run_flat_campaign, run_root_campaign
    from repro_torch.fed.net import SocketServerTransport

    cids = list(range(HIER_KILL_CLIENTS))
    wal_path = os.path.join(directory, "leaf0.wal")
    leaf_port = free_port()
    kw = dict(port=leaf_port, wal_path=wal_path, wal_checkpoint_every=2)
    root_t = SocketServerTransport("127.0.0.1", 0)
    root = RootAggregator(root_t, round_timeout=HIER_TIMEOUT)
    uplink = {0: (root_t.host, root_t.port)}
    result, errors, procs = {}, [], []

    def campaign():
        try:
            result["digest"], _ = run_root_campaign(root, {0: cids}, template, HIER_ROUNDS)
        except BaseException as e:      # noqa: BLE001 - checked after the join
            errors.append(("root", repr(e)))

    try:
        first, ports, ready_s, _done = spawn_leaves(ctx, uplink, **kw)
        procs.append(first[0])
        assert ports[0] == leaf_port, ports
        camp = threading.Thread(target=campaign, daemon=True)
        camp.start()
        drivers = driver_threads(template, {0: leaf_port}, {0: cids[:6]}, errors)
        deadline = time.monotonic() + 120.0
        while wal_uploads(wal_path, 0) < 3:
            assert time.monotonic() < deadline, "no uploads journaled"
            time.sleep(0.02)
        os.kill(first[0].pid, signal.SIGKILL)
        first[0].join(timeout=10.0)
        journaled = wal_uploads(wal_path, 0)
        second, _ports, ready2, done = spawn_leaves(ctx, uplink, **kw)
        procs.append(second[0])
        drivers += driver_threads(template, {0: leaf_port}, {0: cids[6:]}, errors)
        camp.join(timeout=HIER_TIMEOUT)
        assert not camp.is_alive(), "campaign hung after the leaf restart"
        join_drivers(drivers, errors)
        leaf_counters = join_leaves(second, done)
    finally:
        stop_all(procs)
        root_t.close()
    flat, _ = run_flat_campaign(template, cids, HIER_ROUNDS)
    rec = walmod.recover(wal_path)
    closes = {rnd: rec.rounds[rnd].close_meta for rnd in range(HIER_ROUNDS)}
    pairs = {rnd: [(c, p.get("round")) for c, p in rec.rounds[rnd].uploads]
             for rnd in range(HIER_ROUNDS)}
    say(f"  (c) leaf SIGKILL: killed with {journaled} uploads of round 0 journaled; restarted "
        f"leaf ready in {ready2[0]:.3f} s (first {ready_s[0]:.3f} s); tree {result['digest'][:16]}, "
        f"flat {flat[:16]}; closes {closes}; journaled uploads a round "
        f"{ {r: len(p) for r, p in pairs.items()} }; restarted leaf's counters "
        f"{hier_only(leaf_counters[0])}")
    assert journaled >= 3, journaled
    assert result["digest"] == flat, (result["digest"], flat)
    for rnd in range(HIER_ROUNDS):
        assert rec.rounds[rnd].closed and closes[rnd]["mode"] == "FULL", closes
        assert closes[rnd]["count"] == len(cids), closes
        assert len(pairs[rnd]) == len(set(pairs[rnd])) == len(cids), pairs[rnd]
    assert len(rec.rounds[0].uploads) > journaled - 1
    return {"journaled_at_kill": journaled, "restart_ready_s": ready2[0],
            "tree_equals_flat": True, "closes": closes,
            "counters": hier_only(leaf_counters[0])}


def hier_scale():
    """(d): tests/test_hier.py:358's world in this process: 100,000 clients
    over 8 leaf accumulators, every partial through the codec, 2 rounds
    (``run_two_tier_campaign``), against the flat run."""
    import numpy as np

    from repro_torch.fed.hier import run_flat_campaign, run_two_tier_campaign

    n, n_leaves, rounds = HIER_SCALE
    template = {"w": np.zeros((8, 8), np.float32)}
    t0 = time.perf_counter()
    digest, _params, counts = run_two_tier_campaign(template, range(n), rounds, n_leaves)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    flat, _ = run_flat_campaign(template, range(n), rounds)
    flat_s = time.perf_counter() - t0
    say(f"  (d) {n:,} clients over {n_leaves} leaf accumulators, {rounds} rounds: wall {wall:.3f} s "
        f"(flat {flat_s:.3f} s); counts {counts}; tree {digest[:16]}, flat {flat[:16]}")
    assert counts == [n] * rounds, counts
    assert digest == flat, (digest, flat)
    return {"wall_s": wall, "flat_wall_s": flat_s, "tree_equals_flat": True}


def fold_ms(templates):
    """Fold ms a client at each template width: ``ExactAccumulator.fold`` of
    simulated f32 deltas, in this process."""
    from repro_torch.fed.hier import ExactAccumulator, sim_weight, synth_delta

    out = {}
    for name, template in templates.items():
        reps = HIER_FOLD_REPS[name]
        deltas = [synth_delta(template, 0, c) for c in range(reps)]
        acc = ExactAccumulator()
        t0 = time.perf_counter()
        for c, d in enumerate(deltas):
            acc.fold(d, sim_weight(c))
        out[name] = (time.perf_counter() - t0) * 1e3 / reps
    say("  fold ms a client: " + ", ".join(f"{k} {v:.4f}" for k, v in out.items()))
    return out


def hier_card_round(torch, ctx, device=None):
    """(e): phase 25's world through the tree.  8 worker processes
    (``run_worker``, so on the card) dial 2 leaf processes, pods ``cid % 2``;
    the root calls ``RootAggregator.train_round`` once from the world's
    initial params.  The flat side trains each client once in this process
    on the card, as ``ClientWorker`` does, and folds every delta with its
    ``n`` into one ``ExactAccumulator``."""
    from repro_torch.bridge import params_from_numpy, params_to_numpy
    from repro_torch.device import resolve_device
    from repro_torch.fed.client import make_small_step
    from repro_torch.fed.hier import ExactAccumulator, RootAggregator, params_digest
    from repro_torch.fed.net import SocketServerTransport
    from repro_torch.launch.multihost import WorldSpec, build_world, run_worker
    from repro_torch.models.small import init_small
    from repro_torch.optim.optimizers import make_optimizer

    dev = resolve_device(device)
    spec = WorldSpec(hidden=MH_HIDDEN)
    mcfg, clients, _test, fed = build_world(spec)
    params = params_to_numpy(init_small(fed.seed, mcfg, device="cpu"))
    pods = {lid: [c for c in range(spec.n_clients) if c % HIER_LEAVES == lid]
            for lid in range(HIER_LEAVES)}
    root_t = SocketServerTransport("127.0.0.1", 0)
    root = RootAggregator(root_t, round_timeout=MH_ROUND_TIMEOUT)
    procs, workers = {}, []
    try:
        procs, ports, ready_s, done = spawn_leaves(
            ctx, {lid: (root_t.host, root_t.port) for lid in pods})
        workers = [ctx.Process(target=run_worker,
                               args=(spec, cid, "127.0.0.1", ports[cid % HIER_LEAVES], device),
                               daemon=True) for cid in range(spec.n_clients)]
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        mean, count, weight = root.train_round(pods, params, 0, local_steps=spec.local_steps)
        wall = time.perf_counter() - t0
        root.server.broadcast_shutdown()
        for w in workers:
            w.join(timeout=60.0)
        assert all(w.exitcode == 0 for w in workers), [w.exitcode for w in workers]
        leaf_counters = join_leaves(procs, done)
    finally:
        stop_all(workers + list(procs.values()))
        root_t.close()

    opt = make_optimizer(fed.optimizer, fed.learning_rate)
    step_fn = make_small_step(mcfg, opt, fed.prox_mu)
    flat, ns = ExactAccumulator(), []
    t0 = time.perf_counter()
    for c in clients:
        delta, n_seen, _metrics = c.train_local(params_from_numpy(params, dev), step_fn, opt,
                                                n_steps=spec.local_steps)
        flat.fold(params_to_numpy(delta), int(n_seen))
        ns.append(int(n_seen))
    sync(torch, dev)
    flat_s = time.perf_counter() - t0
    got, want = params_digest(mean), params_digest(flat.finalize_mean())
    say(f"  (e) the card's deltas: 8 worker processes on {dev} under 2 leaves, one train_round "
        f"wall {wall:.3f} s (spawn included); leaves ready in "
        + ", ".join(f"{l}: {s:.3f} s" for l, s in sorted(ready_s.items()))
        + f"; count {count}, weight {weight} (flat {flat.count}, {sum(ns)}); tree mean "
        f"{got[:16]}, flat mean {want[:16]}, equal {got == want}; flat side trained in "
        f"{flat_s:.3f} s; leaf counters "
        f"{ {l: hier_only(s) for l, s in sorted(leaf_counters.items())} }")
    assert count == spec.n_clients and weight == sum(ns), (count, weight, ns)
    assert got == want, (got, want)
    return {"train_round_wall_s": wall, "spawn_to_ready_s": ready_s, "count": count,
            "weight": weight, "tree_equals_flat": True, "flat_train_s": flat_s}


def run_hier_phase(torch, mcfg, smi, device=None):
    """Phase 26: the hierarchical tree (``repro_torch.fed.hier``), five
    gates; the root in this process, leaves spawned."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    say(f"  card: {smi}")
    say(f"  open-file limit {raise_fd_limit()}")
    template = hier_template()
    row = {"card": smi}
    say(f"  (a) {HIER_CLIENTS} simulated clients over {HIER_LEAVES} leaf processes, "
        f"{HIER_ROUNDS} rounds, template w 16x16 + b 16, under none, int8 and topk:")
    row["a"] = {c: hier_campaign(ctx, f"(a) {c}", template, HIER_CLIENTS, c)
                for c in ("none", "int8", "topk")}
    assert row["a"]["none"]["flat_digest"] == HIER_FLAT_DIGEST, row["a"]["none"]["flat_digest"]
    mlp = mlp_template(mcfg)
    row["a"]["femnist-mlp"] = hier_campaign(ctx, "(a) the main path's client as template",
                                            mlp, HIER_MLP_CLIENTS)
    row["fold_ms"] = fold_ms({"16x16+16": template, "femnist-mlp": mlp})
    say(f"  (b) chaos: examples/hier_tree.py's pinned fault script at {HIER_CHAOS_CLIENTS} clients:")
    row["b"] = hier_campaign(ctx, "(b) chaos", template, HIER_CHAOS_CLIENTS, chaos=True)
    assert row["b"]["frames_corrupted"] >= 1, row["b"]["frames_corrupted"]
    assert row["b"]["connections_killed"] >= 1, row["b"]["connections_killed"]
    with tempfile.TemporaryDirectory() as directory:
        row["c"] = hier_leaf_kill(ctx, template, directory)
    row["d"] = hier_scale()
    row["e"] = hier_card_round(torch, ctx, device)
    return row


# ---------------------------------------------------------------- phases 27, 28


def free_card(torch):
    gc.collect()
    torch.cuda.empty_cache()


def run_whisper_phase(torch, counters, no_launches):
    """Phase 27: whisper-base served at full width, its twin and its
    attention held layer by layer.  Returns the serve's launches and the
    largest bf16 relative norm of a layer's flash output against plain."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops

    cfg = get_config(WHISPER_ARCH)
    n_self = cfg.n_enc_layers + cfg.total_layers
    say(f"PHASE 27 serve path: {WHISPER_ARCH} at its published width ({cfg.n_enc_layers} encoder + "
        f"{cfg.total_layers} decoder layers, d_model {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.param_dtype} "
        f"weights), batch {SERVE_BATCH}, frames {SERVE_BATCH} x {SERVE_PROMPT} x {cfg.d_model}, "
        f"prompt {SERVE_PROMPT}, {SERVE_STEPS} greedy decode steps")
    res, launches = run_serve(torch, cfg, counters, {**no_launches, "flash_attention": n_self})
    assert launches["flash_attention_noncausal"] == cfg.n_enc_layers, launches
    profile_serve(torch, cfg, res, ("flash_fwd",))
    say("  twin: the same prefill and decode with self-attention through the plain version "
        "(cross-attention runs attention_chunked in both)")
    serve_twin(torch, cfg, res, {"attn_impl": "reference"},
               ("K rolled by one, V kept", [(fa_ops, "flash_attention", roll_k)]),
               control_gate=False)
    layer_err = attention_layer_twin(torch, cfg, res, roll_k)
    del res
    free_card(torch)
    return launches, layer_err


def run_internvl_phase(torch, counters, no_launches):
    """Phase 28: internvl2-26b served at full width (the card's memory
    freed first) and its twin.  Returns the serve's launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops

    free_card(torch)
    cfg = get_config(INTERNVL_ARCH)
    say(f"PHASE 28 serve path: {INTERNVL_ARCH} at its published width ({cfg.total_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} KV heads of "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.param_dtype} "
        f"weights, {cfg.param_count() / 1e9:.2f} B parameters), batch {SERVE_BATCH}, "
        f"{cfg.n_vision_tokens} patch embeddings + prompt {SERVE_PROMPT}, {SERVE_STEPS} greedy "
        f"decode steps from position {SERVE_PROMPT + cfg.n_vision_tokens}")
    say(f"  card memory allocated before the phase {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    res, launches = run_serve(torch, cfg, counters,
                              {**no_launches, "flash_attention": cfg.total_layers})
    profile_serve(torch, cfg, res, ("flash_fwd",))
    say("  twin: the same prefill and decode with attention through the plain version "
        "(attention_chunked)")
    torch.cuda.reset_peak_memory_stats()
    # K alone: with K and V rolled together the last causal row attends
    # every (key, value) pair, permuted, and its output does not change
    serve_twin(torch, cfg, res, {"attn_impl": "chunked"},
               ("K rolled by one, V kept", [(fa_ops, "flash_attention", roll_k)]),
               floor_routes={"attn_impl": "reference"})
    say(f"  peak allocated in the twin {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
        f"(the serve's {res['peak_gb']:.2f} GB)")
    del res
    free_card(torch)
    return launches


# ---------------------------------------------------------------- phase 29

TRAIN_ARCH = "qwen1.5-0.5b"
TRAIN_ROUNDS, TRAIN_SILOS, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 3, 4, 4, 8, 128
TRAIN_INT8_ROUNDS = 2           # the int8 run: its host round trip is ~9 s a round
TRAIN_RESUME_REL_TOL = 1e-3     # a resumed round against the same round from memory
TRAIN_TWIN_LOSS_REL_TOL = 1e-5  # qwen-100m in f32, card against CPU
TRAIN_TWIN_GRAD_REL_TOL = 1e-4
TRAIN_MOE_LAYERS = 4            # olmoe-1b-7b cut to 4 of its 16 layers: AdamW state fits
TRAIN_MOE_STEPS = 2
TRAIN_MOE_TOLS = {"float32": 1e-4, "bfloat16": 2e-2}
TRAIN_FAMILIES = ("whisper-base", "mamba2-1.3b")


def tree_bytes(tree):
    from repro_torch.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def train_batch(torch, cfg, device):
    """One batch of the silo data ``launch/train.py`` draws (a Zipf stream,
    contiguous windows; silo 0's seeds), plus whisper's frames from a
    generator seeded 1."""
    from repro_torch.data.pipeline import TokenDataset
    from repro_torch.data.synthetic import make_lm_tokens

    data = TokenDataset(make_lm_tokens(200_000, cfg.vocab_size, seed=0), TRAIN_SEQ,
                        TRAIN_BATCH, seed=0)
    batch = {"tokens": torch.from_numpy(data.next_batch()["tokens"]).to(device)}
    if cfg.is_encdec:
        gen = torch.Generator(device=device).manual_seed(1)
        batch["frames"] = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model), generator=gen,
                                      device=device)
    return batch


def step_walls(torch, step, args, reps):
    """Median wall seconds of ``step(*args)`` (each ending in a synchronize)
    after one warm call, and the peak memory of a call."""
    step(*args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls), torch.cuda.max_memory_allocated() / 1e9


def train_run(torch, cfg, label, device, **kw):
    """``launch/train.py``'s ``train`` with its printed lines, and each
    round's phase walls."""
    from repro_torch.launch.train import train

    say(f"  {label}:")
    res = train(cfg, rounds=kw.pop("rounds", TRAIN_ROUNDS), silos=TRAIN_SILOS,
                local_steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, device=device,
                log=lambda *a: say("    " + " ".join(map(str, a))), **kw)
    for h in res["history"]:
        say(f"    round {h['round']} phase wall s: "
            + ", ".join(f"{k} {v:.4f}" for k, v in h["phase_s"].items()))
    losses = [h["loss"] for h in res["history"]]
    assert all(math.isfinite(x) for x in losses), losses
    return res


def run_train_main_path(torch, cfg, device, directory):
    """(a): qwen1.5-0.5b's federated pretraining rounds under none (checkpointed)
    and int8, a resume, and one train step's wall, launches and memory."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.models.registry import make_train_step
    from repro_torch.tree import tree_leaves

    none = train_run(torch, cfg, "compression none, checkpointed", device, ckpt_dir=directory)
    params = none["params"]
    n_params = sum(t.numel() for t in tree_leaves(params))
    f32_bytes = 4 * n_params
    losses = [h["loss"] for h in none["history"]]
    assert losses[-1] < losses[0], losses
    comm = none["history"][-1]["comm_bytes"]
    assert comm == TRAIN_SILOS * TRAIN_ROUNDS * f32_bytes, (comm, f32_bytes)
    say(f"  none: loss {losses[0]:.4f} -> {losses[-1]:.4f}; comm_bytes {comm} = {TRAIN_SILOS} "
        f"silos x {TRAIN_ROUNDS} rounds x {f32_bytes} f32 parameter bytes ({n_params} parameters)")
    step, restored = CheckpointManager(directory).restore_latest(params)
    assert step == TRAIN_ROUNDS
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(restored), tree_leaves(params)))
    say(f"  the checkpoint of round {step} restores the run's parameters bit for bit")
    del restored
    resumed = train_run(torch, cfg, "resumed from the checkpoint, one round", device, rounds=1,
                        ckpt_dir=directory)
    straight = train_run(torch, cfg, "the same round from the parameters in memory", device,
                         rounds=1, init_params=params)
    (r,), (s,) = resumed["history"], straight["history"]
    assert resumed["start_round"] == TRAIN_ROUNDS and r["round"] == TRAIN_ROUNDS + 1
    assert r["comm_bytes"] == s["comm_bytes"], (r, s)
    gap = abs(r["loss"] - s["loss"]) / abs(s["loss"])
    say(f"  resumed round {r['round']} against the round from memory: loss {r['loss']:.6f} vs "
        f"{s['loss']:.6f} (relative {gap:.2e}, tol {TRAIN_RESUME_REL_TOL:g}), comm_bytes "
        f"{r['comm_bytes']} both")
    assert gap <= TRAIN_RESUME_REL_TOL, gap
    del resumed, straight
    int8 = train_run(torch, cfg, "compression int8", device, compression="int8",
                     rounds=TRAIN_INT8_ROUNDS)
    losses8 = [h["loss"] for h in int8["history"]]
    assert losses8[-1] < losses8[0], losses8
    comm8 = int8["history"][-1]["comm_bytes"]
    n_leaves = len(tree_leaves(params))
    assert comm8 == TRAIN_SILOS * TRAIN_INT8_ROUNDS * (n_params + 4 * n_leaves), comm8
    comm_none = TRAIN_SILOS * TRAIN_INT8_ROUNDS * f32_bytes
    say(f"  int8: loss {losses8[0]:.4f} -> {losses8[-1]:.4f}; comm_bytes {comm8} "
        f"({comm8 / comm_none:.4f} of none's over as many rounds)")
    del int8

    step_fn, opt = make_train_step(cfg)
    state = opt.init(params)
    batch = train_batch(torch, cfg, device)
    wall, peak = step_walls(torch, step_fn, (params, state, batch), reps=6)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    say(f"  one train step ({TRAIN_BATCH} x {TRAIN_SEQ}, remat {cfg.remat}, {cfg.compute_dtype} "
        f"compute, {cfg.optimizer} clip {cfg.grad_clip:g}): median wall {wall * 1e3:.2f} ms, "
        f"{tokens / wall:.0f} tokens/s, peak allocated {peak:.2f} GB (parameters "
        f"{f32_bytes / 1e9:.2f} GB, AdamW state {tree_bytes(state) / 1e9:.2f} GB)")
    prof = profile_call(torch, "one train step", lambda: step_fn(params, state, batch))
    row = {"params": n_params, "losses": {"none": losses, "int8": losses8},
           "comm_bytes": {"none": comm, "int8": comm8},
           "round_phase_s": [h["phase_s"] for h in none["history"]],
           "round_wall_s": [h["wall_s"] for h in none["history"]],
           "step_ms": wall * 1e3, "tokens_per_s": tokens / wall, "peak_gb": peak,
           "resume_loss_rel_gap": gap, **{f"step_{k}": v for k, v in prof.items()}}
    del state, batch, params, none
    return row


def params_init(torch, cfg, device):
    """The init ``train`` draws (a generator seeded 0 on the device)."""
    from repro_torch.models.registry import model_fns

    return model_fns(cfg).init(torch.Generator(device=device).manual_seed(0), device)[0]


def grads_gap(torch, a, b):
    """Global relative L2 of gradient tree ``a`` against ``b``."""
    from repro_torch.tree import tree_leaves

    num = sum(float((x.float().cpu() - y.float().cpu()).square().sum())
              for x, y in zip(tree_leaves(a), tree_leaves(b)))
    den = sum(float(y.float().square().sum()) for y in tree_leaves(b))
    return math.sqrt(num / den)


def run_train_twin(torch, device, attn_impl="chunked", cfg=None):
    """(b): one step of qwen-100m in f32 (TF32 off) on the card and on the CPU
    from the same parameters and batch; the tokens rolled by one as control.
    Phase 30 runs it on the flash route (``attn_impl="pallas"``): the card's
    attention on the ffma forward and the backward's kernels, the CPU's on
    their plain versions; phase 31 runs ``cfg`` (mamba2-1.3b cut to 2
    layers, ``ssm_impl="pallas"``) so, and phase 32 recurrentgemma-9b's
    (rglru, rglru) group (``rglru_impl="pallas"``)."""
    from repro_torch.launch.train import train_config
    from repro_torch.models.registry import make_train_step, model_fns, value_and_grad
    from repro_torch.tree import tree_map

    if cfg is None:
        cfg = train_config("qwen-100m").replace(attn_impl=attn_impl)
    cfg = cfg.replace(compute_dtype="float32")
    fns = model_fns(cfg)
    host, _ = fns.init(torch.Generator().manual_seed(0), "cpu")
    card = tree_map(lambda t: t.to(device), host)
    batch_h = train_batch(torch, cfg, "cpu")
    batch_c = {k: v.to(device) for k, v in batch_h.items()}
    rolled = {"tokens": batch_c["tokens"].roll(1, dims=1)}
    assert not torch.backends.cuda.matmul.allow_tf32
    t0 = time.perf_counter()
    (loss_h, _), g_h = value_and_grad(fns.loss, host, batch_h)
    cpu_s = time.perf_counter() - t0
    (loss_c, _), g_c = value_and_grad(fns.loss, card, batch_c)
    (loss_r, _), g_r = value_and_grad(fns.loss, card, rolled)
    step, opt = make_train_step(cfg)
    _, _, m_h = step(host, opt.init(host), batch_h)
    _, _, m_c = step(card, opt.init(card), batch_c)
    loss_gap = abs(float(loss_c) - float(loss_h)) / abs(float(loss_h))
    step_gap = abs(float(m_c["loss"]) - float(m_h["loss"])) / abs(float(m_h["loss"]))
    gap, control = grads_gap(torch, g_c, g_h), grads_gap(torch, g_r, g_h)
    rolled_gap = abs(float(loss_r) - float(loss_h)) / abs(float(loss_h))
    say(f"  {cfg.name} ({cfg.param_count() / 1e6:.1f} M parameters, f32, TF32 off, attention "
        f"{cfg.attn_impl}, SSD scan {cfg.ssm_impl}, RG-LRU scan {cfg.rglru_impl}), batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}: loss card {float(loss_c):.7f} CPU {float(loss_h):.7f} "
        f"(relative {loss_gap:.2e}, tol {TRAIN_TWIN_LOSS_REL_TOL:g}; the train step's "
        f"{step_gap:.2e}, grad_norm {float(m_c['grad_norm']):.6f} vs {float(m_h['grad_norm']):.6f}); "
        f"gradients' global relative L2 {gap:.2e} (tol {TRAIN_TWIN_GRAD_REL_TOL:g}); control, "
        f"tokens rolled by one on the card: {control:.2e} (loss {rolled_gap:.2e}); CPU "
        f"value_and_grad {cpu_s:.1f} s")
    assert loss_gap <= TRAIN_TWIN_LOSS_REL_TOL and step_gap <= TRAIN_TWIN_LOSS_REL_TOL
    assert gap <= TRAIN_TWIN_GRAD_REL_TOL, gap
    assert control > TRAIN_TWIN_GRAD_REL_TOL, control
    return {"loss_rel_gap": loss_gap, "grad_rel_l2": gap, "control_grad_rel_l2": control}


def moe_train_config():
    from repro_torch.configs.base import LayerGroup
    from repro_torch.configs.registry import get_config

    cfg = get_config(OLMOE_ARCH)
    return cfg.replace(n_layers=TRAIN_MOE_LAYERS,
                       groups=(LayerGroup(cfg.groups[0].pattern, TRAIN_MOE_LAYERS),))


@contextlib.contextmanager
def capture_expert_products(ops, caps, n):
    """Record the first ``n`` grouped-matmul calls' (x, w, group sizes), and
    every path ``gmm`` chooses."""
    real, real_path = ops.grouped_matmul, ops.choose_path
    paths = []

    def spy(x, w, sizes):
        if len(caps) < n:
            caps.append((x.detach(), w.detach(), sizes))
        return real(x, w, sizes)

    def path_spy(*a, **kw):
        paths.append(real_path(*a, **kw))
        return paths[-1]

    with mock.patch.object(ops, "grouped_matmul", spy), \
            mock.patch.object(ops, "choose_path", path_spy):
        yield paths


def hold_expert_grads(torch, ops, ref, x, w, sizes, dtype, seed):
    """dx and dw of the kernel route against autograd through the plain loop
    at these inputs in ``dtype``, and the kernel with the group sizes rolled
    by one as the control: (relative norms, control's)."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    x, w = x.to(dtype), w.to(dtype)
    dy = torch.randn((x.shape[0], w.shape[2]), generator=gen, device=x.device).to(dtype)

    def grads(fn, gs):
        xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        fn(xx, ww, gs).backward(dy)
        return xx.grad, ww.grad

    want = grads(ref.grouped_matmul_ref, sizes)
    got = grads(ops.grouped_matmul, sizes)
    bad = grads(ops.grouped_matmul, sizes.roll(1))
    torch.cuda.synchronize()
    return ([rel_norm(a, b) for a, b in zip(got, want)],
            [rel_norm(a, b) for a, b in zip(bad, want)])


def time_train_products(torch, ops, ref, x, w, h, wd, sizes):
    """``gmm`` (forward and the backward's dx on wᵀ as a view) and ``tgmm`` at
    the train step's expert shapes and routed split, bf16: kernel (on a
    schedule made beforehand) beside the plain loop, ``torch._grouped_mm``
    and the least time the card could take."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    m, g = x.shape[0], w.shape[0]
    live = int((sizes > 0).sum())
    ends = torch.cumsum(sizes, 0, dtype=torch.int32)
    bounds = ops.row_bounds(sizes, m)
    rows = {}
    dy_up = torch.randn((m, w.shape[2]), generator=gen, device="cuda").bfloat16()
    dy_down = torch.randn((m, wd.shape[2]), generator=gen, device="cuda").bfloat16()
    gmm_cases = (("wg/wu forward", x, w), ("wd forward", h, wd),
                 ("wg/wu dx (wT view)", dy_up, w.transpose(1, 2)),
                 ("wd dx (wT view)", dy_down, wd.transpose(1, 2)))
    for name, a, b in gmm_cases:
        (_, k), n = a.shape, b.shape[2]
        path = ops.choose_path(m, k, n, g, a.dtype, ops._vector_rows(a, b))
        prefix = ops.tile_prefix(bounds, ops.PATHS[path][1])
        y = torch.empty((m, n), device="cuda", dtype=a.dtype)
        lib_ms, lib_note = grouped_mm_ms(torch, a, b, ends)
        row = {"kernel": "gmm", "M": m, "K": k, "N": n, "G": g, "path": path,
               "ms": median_ms(torch, lambda: ops.launch_gmm(path, a, b, bounds, prefix, y),
                               reps=20, warm=2),
               "plain_ms": median_ms(torch, lambda: ref.grouped_matmul_ref(a, b, sizes),
                                     reps=5, warm=1),
               "library_ms": lib_ms}
        flops, io_bytes = 2 * m * k * n, 2 * (m * k + live * k * n + m * n) + 4 * (g + 1)
        rows[name] = timing_row(row, flops, io_bytes, lib_note)
    for name, a, d in (("wg/wu dw", x, dy_up), ("wd dw", h, dy_down)):
        (_, k), n = a.shape, d.shape[1]
        path = ops.choose_tgmm_path(m, k, n, g, a.dtype)
        dw = torch.empty((g, k, n), device="cuda", dtype=a.dtype)
        lib_ms, lib_note = grouped_mm_ms(torch, a.t(), d, ends)
        row = {"kernel": "tgmm", "M": m, "K": k, "N": n, "G": g, "path": path,
               "ms": median_ms(torch, lambda: ops.launch_tgmm(path, a, d, bounds, dw),
                               reps=20, warm=2),
               "plain_ms": median_ms(torch, lambda: ref.tgmm_ref(a, d, sizes, g), reps=5, warm=1),
               "library_ms": lib_ms}
        flops, io_bytes = 2 * m * k * n, 2 * (m * k + m * n + g * k * n) + 4 * (g + 2)
        rows[name] = timing_row(row, flops, io_bytes, lib_note)
    for name, row in rows.items():
        lib = row["library_ms"]
        say(f"  {row['kernel']} {name:<20} M={row['M']} K={row['K']} N={row['N']} G={row['G']}: "
            f"{row['ms']:.4f} ms ({row['path']}); plain {row['plain_ms']:.4f} ms; library "
            f"(torch._grouped_mm) {'null' if lib is None else f'{lib:.4f} ms'}"
            f"{' (' + row['library_note'] + ')' if row['library_note'] else ''}; bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}); {row['tflop_per_s']:.1f} TFLOP/s; "
            f"kernel / bound {row['ms'] / row['bound_ms']:.2f}"
            + (f", kernel / library {row['ms'] / lib:.2f}" if lib else ""))
    return rows


def timing_row(row, flops, io_bytes, lib_note):
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, io_bytes / HBM_BYTES_PER_S * 1e3
    row.update(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
               tflop_per_s=flops / row["ms"] / 1e9, library_note=lib_note)
    return row


def run_train_moe(torch, ops, ref, counters, device):
    """(c): olmoe-1b-7b at full width, 4 of its 16 layers: two train steps with
    every expert product on the kernels, counted; then one layer's captured
    expert products held against autograd through the plain loop, and timed."""
    from repro_torch.models.registry import make_train_step

    cfg = moe_train_config()
    n_moe = TRAIN_MOE_LAYERS
    say(f"  {OLMOE_ARCH} at full width, {TRAIN_MOE_LAYERS} of its 16 layers ({cfg.param_count() / 1e9:.2f} "
        f"B parameters, f32; {cfg.compute_dtype} compute, remat {cfg.remat}, {cfg.optimizer} clip "
        f"{cfg.grad_clip:g}), batch {TRAIN_BATCH} x {TRAIN_SEQ}: {TRAIN_BATCH * TRAIN_SEQ * cfg.top_k} "
        f"routed rows a layer over {cfg.n_experts} experts")
    params = params_init(torch, cfg, device)
    step, opt = make_train_step(cfg)
    state = opt.init(params)
    batch = train_batch(torch, cfg, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches((*counters, ops.TGMM_PATH_LAUNCHES))
    caps, walls, losses = [], [], []
    with capture_expert_products(ops, caps, 3) as paths:
        for _ in range(TRAIN_MOE_STEPS):
            t0 = time.perf_counter()
            params, state, metrics = step(params, state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
    launches = {k: v for counts in counters for k, v in counts.items()}
    tgmm_paths = dict(ops.TGMM_PATH_LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    say(f"  {TRAIN_MOE_STEPS} steps: walls {', '.join(f'{w:.3f}' for w in walls)} s, losses "
        f"{losses}, peak allocated {peak:.2f} GB (parameters {tree_bytes(params) / 1e9:.2f} GB, "
        f"AdamW state {tree_bytes(state) / 1e9:.2f} GB); launches {launches}, tgmm by path "
        f"{tgmm_paths}, gmm paths chosen {sorted(set(paths))}")
    want = {**{k: 0 for k in launches}, "gmm": 9 * n_moe * TRAIN_MOE_STEPS,
            "tgmm": 3 * n_moe * TRAIN_MOE_STEPS}
    assert launches == want, (launches, want)       # forward, recompute, dx: 3 x 3 a layer
    assert tgmm_paths == {"ffma": 0, "wgmma": want["tgmm"]}, tgmm_paths
    assert paths == ["wgmma"] * want["gmm"], paths
    assert all(math.isfinite(x) for x in losses), losses
    del params, state, batch
    free_card(torch)

    (x, wg, sizes), _, (h, wd, _) = caps
    assert x.shape == (TRAIN_BATCH * TRAIN_SEQ * cfg.top_k, cfg.d_model), x.shape
    assert int(sizes.sum()) == x.shape[0]
    say(f"  layer 0's routed split: {int((sizes > 0).sum())} experts live, rows an expert "
        f"{int(sizes.min())} .. {int(sizes.max())} (mean {x.shape[0] / cfg.n_experts:.0f})")
    errs = {}
    for dtype, tol in TRAIN_MOE_TOLS.items():
        for name, a, b in (("wg", x, wg), ("wd", h, wd)):
            got, bad = hold_expert_grads(torch, ops, ref, a, b, sizes, getattr(torch, dtype), 16)
            errs[f"{dtype} {name}"] = {"dx": got[0], "dw": got[1], "control": bad}
            say(f"  {dtype} {name} product x {tuple(a.shape)} w {tuple(b.shape)}: kernel route "
                f"against autograd through the plain loop, relative dx {got[0]:.2e} dw "
                f"{got[1]:.2e} (tol {tol:g}); group sizes rolled by one: dx {bad[0]:.2e} dw "
                f"{bad[1]:.2e}")
            assert max(got) <= tol, (dtype, name, got)
            assert min(bad) > tol, (dtype, name, bad)
    rows = time_train_products(torch, ops, ref, x.bfloat16(), wg.bfloat16(), h.bfloat16(),
                               wd.bfloat16(), sizes)
    del caps, x, wg, h, wd
    free_card(torch)
    return launches, tgmm_paths, {"step_s": walls, "losses": losses, "peak_gb": peak,
                                  "grads": errs}, rows


def run_train_families(torch, device):
    """(d): one train step each of whisper-base (encdec_loss) and mamba2-1.3b
    (ssd_chunked in plain torch) at full width: finite loss, params changed."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import make_train_step
    from repro_torch.tree import tree_leaves

    out = {}
    for arch in TRAIN_FAMILIES:
        cfg = get_config(arch)
        params = params_init(torch, cfg, device)
        step, opt = make_train_step(cfg)
        state = opt.init(params)
        batch = train_batch(torch, cfg, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for i in range(2):
            t0 = time.perf_counter()
            new, state, metrics = step(params if i == 0 else new, state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if i == 0:
                loss = float(metrics["loss"])
                changed = sum(not torch.equal(a, b)
                              for a, b in zip(tree_leaves(new), tree_leaves(params)))
                del params
        peak = torch.cuda.max_memory_allocated() / 1e9
        n_leaves = len(tree_leaves(new))
        say(f"  {arch} at full width ({cfg.param_count() / 1e9:.2f} B parameters, remat "
            f"{cfg.remat}, {cfg.compute_dtype} compute"
            f"{f', frames {TRAIN_BATCH} x {TRAIN_SEQ} x {cfg.d_model}' if cfg.is_encdec else ''}): "
            f"two steps {walls[0]:.3f} s (the first) and {walls[1]:.3f} s, first loss {loss:.4f}, "
            f"{changed} of {n_leaves} parameter leaves changed by it, peak allocated {peak:.2f} GB")
        assert math.isfinite(loss) and changed == n_leaves, (loss, changed, n_leaves)
        out[arch] = {"step_s": walls, "loss": loss, "peak_gb": peak}
        del new, state, batch
        free_card(torch)
    return out


def run_train_phase(torch, ops, ref, counters, smi, device="cuda"):
    """Phase 29: LM training.  (a) and (b), (d) with every kernel count set to
    0 before and read 0 after; (c) with its two steps counted."""
    from repro_torch.configs.registry import get_config

    free_card(torch)
    cfg = get_config(TRAIN_ARCH)
    say(f"PHASE 29 train: repro_torch.launch.train on {TRAIN_ARCH} at its published width "
        f"({cfg.total_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
        f"{cfg.param_dtype} parameters, {cfg.compute_dtype} compute, remat {cfg.remat}, "
        f"{cfg.optimizer} clip {cfg.grad_clip:g}), {TRAIN_ROUNDS} rounds x {TRAIN_SILOS} silos x "
        f"{TRAIN_STEPS} local steps, batch {TRAIN_BATCH} x {TRAIN_SEQ}")
    say(f"  card: {smi}")
    t0 = time.perf_counter()
    zero_launches(counters)
    with tempfile.TemporaryDirectory() as directory:
        main_row = run_train_main_path(torch, cfg, device, directory)
    say("  (b) card against CPU")
    twin_row = run_train_twin(torch, device)
    quiet = {k: v for counts in counters for k, v in counts.items()}
    assert not any(quiet.values()), quiet          # the dense path runs no kernel
    say("  (c) expert gradients on gmm and tgmm")
    moe_launches, moe_tgmm_paths, moe_row, moe_rows = run_train_moe(torch, ops, ref, counters,
                                                                    device)
    say("  (d) the other families")
    zero_launches(counters)
    family_rows = run_train_families(torch, device)
    quiet = {k: v for counts in counters for k, v in counts.items()}
    assert not any(quiet.values()), quiet
    say(f"  phase 29 {time.perf_counter() - t0:.1f} s")
    row = {"card": smi, TRAIN_ARCH: main_row, "qwen-100m twin": twin_row,
           f"{OLMOE_ARCH} ({TRAIN_MOE_LAYERS} layers)": moe_row, **family_rows}
    return moe_launches, moe_tgmm_paths, moe_rows, row


# ---------------------------------------------------------------- phase 30

FLASH_BWD_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu"
# dq, dk, dv against the plain backward: f32 allclose (tests/test_kernels.py:56), bf16
# relative norm against the plain version in f32 on the same bf16 inputs; the lse allclose
FLASH_BWD_TOLS = {"float32": 1e-4, "bfloat16": 2e-2}
FLASH_LSE_TOL = 1e-5
# qwen1.5-0.5b's attention in phase 29's train step (batch 8 x 128)
TRAIN_ATTN_SHAPE = (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 16, 16, 64, True, None)
FLASH_TRAIN_STEPS = 4
FLASH_TRAIN_LOSS_REL_TOL = 2e-2   # the first step's loss, flash route against chunked (bf16)


def bwd_close(torch, got, want32, dtype):
    """(passes, errors): f32 allclose FLASH_BWD_TOLS (errors max|err|), bf16
    relative norms against the f32 plain version (errors those norms)."""
    tol = FLASH_BWD_TOLS[str(dtype)[6:]]
    if dtype == torch.float32:
        return (all(torch.allclose(a, b, rtol=tol, atol=tol) for a, b in zip(got, want32)),
                [float((a - b).abs().max()) for a, b in zip(got, want32)])
    errs = [rel_norm(a, b) for a, b in zip(got, want32)]
    return max(errs) <= tol, errs


def bwd_inputs(torch, case, dtype, seed=0):
    q, k, v = flash_inputs(torch, case, dtype, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 100)
    return q, k, v, torch.randn(q.shape, generator=gen, device="cuda").to(dtype)


def check_flash_bwd(torch, fa_ops, fa_ref):
    """(a): the forward's lse and the backward's dq, dk, dv against their
    plain versions on every FLASH_CASES case in f32 and bf16, the forward on
    the path the dtype takes (f32 ffma, bf16 wgmma); K rolled by one
    position must fail the limits.  Returns the largest errors by dtype."""
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name_dt = str(dtype)[6:]
        for name, case in FLASH_CASES:
            causal, window = case[6:]
            q, k, v, do = bwd_inputs(torch, case, dtype)
            before = dict(fa_ops.BWD_LAUNCHES)
            o, lse = fa_ops.flash_attention_fwd(q, k, v, causal=causal, window=window)
            got = fa_ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)
            torch.cuda.synchronize()
            assert fa_ops.BWD_LAUNCHES == {key: n + 1 for key, n in before.items()}, name
            lse_want = fa_ref.attention_lse_ref(q, k, causal=causal, window=window)
            want32 = fa_ref.attention_bwd_ref(q.float(), k.float(), v.float(), do.float(),
                                              causal=causal, window=window)
            ok, errs = bwd_close(torch, got, want32, dtype)
            abs_err = max(float((a.float() - b).abs().max()) for a, b in zip(got, want32))
            lse_err = float((lse - lse_want).abs().max())
            kr = k.roll(1, dims=1)
            o_r, lse_r = fa_ops.flash_attention_fwd(q, kr, v, causal=causal, window=window)
            rolled = fa_ops.flash_attention_bwd(q, kr, v, o_r, lse_r, do, causal=causal,
                                                window=window)
            ctl = [bwd_close(torch, (a,), (b,), dtype) for a, b in zip(rolled, want32)]
            lse_ctl = float((lse_r - lse_want).abs().max())
            say(f"  {name_dt:>8} {name:<38} {str(case):<40} dq/dk/dv "
                f"{' '.join(f'{e:.2e}' for e in errs)} (max|err| {abs_err:.2e}), lse max|err| "
                f"{lse_err:.2e}; K rolled: {' '.join(f'{c[1][0]:.2e}' for c in ctl)}, lse "
                f"{lse_ctl:.2e}")
            assert ok, (name, name_dt, errs)
            torch.testing.assert_close(lse, lse_want, rtol=FLASH_LSE_TOL, atol=FLASH_LSE_TOL,
                                       msg=lambda m_: f"lse {name} {name_dt}: {m_}")
            assert not any(c[0] for c in ctl), (name, name_dt, ctl)
            # without a mask every row sums over all keys: a roll permutes them, lse stays
            if causal or window is not None:
                assert not torch.allclose(lse_r, lse_want, rtol=FLASH_LSE_TOL,
                                          atol=FLASH_LSE_TOL), name
            row = worst.setdefault(name_dt, {"grads": 0.0, "max_abs_err": 0.0, "lse": 0.0})
            row["grads"] = max(row["grads"], max(errs))
            row["max_abs_err"] = max(row["max_abs_err"], abs_err)
            row["lse"] = max(row["lse"], lse_err)
            del q, k, v, do, o, lse, got, want32, rolled, o_r, lse_r
            free_card(torch)
    return worst


def bwd_tile_pairs(fa_ops, sq, skv, causal, window, d):
    """(query tile, KV tile) pairs the backward visits (each kernel the same)."""
    tq, tk = fa_ops.bwd_tiles(d)
    return sum(max(0, end - begin) for begin, end in (
        fa_ops.kv_tiles(qt, sq, skv, causal, window, tq, tk) for qt in range(-(-sq // tq))))


def time_flash_bwd(torch, fa_ops, fa_ref, shape, f32=False):
    """(b): the backward at ``shape`` in bf16 (and f32 with ``f32``) beside
    its plain version, the library's backward (torch.autograd.grad over one
    scaled_dot_product_attention output, built once) and its bound: the
    four gradient products over the live pairs at the bf16 peak against q,
    k, v, o, dO and lse read and dq, dk, dv written at 3.35 TB/s."""
    b, sq, skv, hq, hk, d, causal, window = shape
    assert window is None or window >= skv   # the library's causal mask is the same
    mask = dict(causal=causal, window=window)
    q, k, v, do = bwd_inputs(torch, shape, torch.bfloat16, seed=3)
    o, lse = fa_ops.flash_attention_fwd(q, k, v, **mask)
    row = {"ms": median_ms(torch, lambda: fa_ops.flash_attention_bwd(q, k, v, o, lse, do, **mask)),
           "plain_ms": median_ms(torch, lambda: fa_ref.attention_bwd_ref(q, k, v, do, **mask),
                                 reps=3, warm=1)}
    if f32:
        q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
        o32, lse32 = fa_ops.flash_attention_fwd(q32, k32, v32, **mask)
        row["f32_ms"] = median_ms(torch, lambda: fa_ops.flash_attention_bwd(
            q32, k32, v32, o32, lse32, do32, **mask))
        del q32, k32, v32, do32, o32, lse32
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                           enable_gqa=hq != hk)
    dot = do.transpose(1, 2).contiguous()
    try:
        row["library_ms"] = median_ms(torch, lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True))
    except RuntimeError as e:       # the yardstick only: its absence fails nothing
        row["library_ms"], row["library_note"] = None, str(e)[:160]
    pairs = live_pairs(sq, skv, causal, window) * b * hq
    flops = 8 * d * pairs                                   # dV, dP, dQ, dK on each live pair
    tq, tk = fa_ops.bwd_tiles(d)
    issued = (14 * d * tq * tk * bwd_tile_pairs(fa_ops, sq, skv, causal, window, d) * b * hq
              + 2 * d * b * sq * hq)                        # S, dP twice; dV, dK, dQ; delta
    io_bytes = 2 * (4 * b * sq * hq * d + 4 * b * skv * hk * d) + 4 * b * hq * sq
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, io_bytes / HBM_BYTES_PER_S * 1e3
    row.update(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
               gflop=flops / 1e9, issued_gflop=issued / 1e9, io_mb=io_bytes / 1e6,
               tflops_issued=issued / row["ms"] / 1e9, shape=list(shape))
    lib = row["library_ms"]
    say(f"  flash_attention_bwd B={b} S={sq} Hq={hq} Hk={hk} D={d} "
        f"{'causal' if causal else 'bidirectional'} window={window}, bf16: {row['ms']:.4f} ms "
        f"({issued / 1e9:.2f} GFLOP issued on FFMA, {row['tflops_issued']:.1f} TFLOP/s)"
        + (f", f32 {row['f32_ms']:.4f} ms" if f32 else "")
        + f"; plain {row['plain_ms']:.4f} ms; library (autograd.grad of scaled_dot_product_"
        f"attention, bf16) " + (f"{lib:.4f} ms" if lib else row["library_note"])
        + f"; bound {row['bound_ms']:.4f} ms ({row['bound_by']}: {flops / 1e9:.2f} GFLOP at 989 "
        f"TFLOP/s, {io_bytes / 1e6:.1f} MB at 3.35 TB/s); kernel / bound "
        f"{row['ms'] / row['bound_ms']:.1f}" + (f", kernel / library {row['ms'] / lib:.1f}"
                                                if lib else ""))
    del q, k, v, do, o, lse, qt, kt, vt, out, dot
    free_card(torch)
    return row


@contextlib.contextmanager
def capture_bwd_calls(fa_ops, caps, keep):
    """Record the inputs of the backward calls whose index is in ``keep``
    (clones: q, k, v, o, lse, dO, causal, window)."""
    real, n = fa_ops.flash_attention_bwd, [0]

    def spy(q, k, v, o, lse, do, **kw):
        if n[0] in keep:
            caps[n[0]] = [t.detach().clone() for t in (q, k, v, o, lse, do)] + \
                [kw["causal"], kw["window"]]
        n[0] += 1
        return real(q, k, v, o, lse, do, **kw)

    with mock.patch.object(fa_ops, "flash_attention_bwd", spy):
        yield


def counts_now(counters, fa_ops):
    return ({k: v for counts in counters for k, v in counts.items()},
            dict(fa_ops.PATH_LAUNCHES), dict(fa_ops.BWD_LAUNCHES))


def run_flash_qwen_train(torch, fa_ops, fa_ref, counters, device):
    """(c) qwen1.5-0.5b at full width: FLASH_TRAIN_STEPS train steps on the
    chunked route and on the flash route from the same parameters and
    batch; the flash route's launches counted; layers 0 and 23's captured
    backward inputs held against the plain backward."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import make_train_step

    cfg = get_config(TRAIN_ARCH)
    n = cfg.total_layers
    params0 = params_init(torch, cfg, device)
    batch = train_batch(torch, cfg, device)
    rows, caps = {}, {}
    for impl in ("chunked", "pallas"):
        step, opt = make_train_step(cfg.replace(attn_impl=impl))
        params, state = params0, opt.init(params0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches((*counters, fa_ops.PATH_LAUNCHES, fa_ops.BWD_LAUNCHES))
        losses, walls = [], []
        with capture_bwd_calls(fa_ops, caps, (0, n - 1) if impl == "pallas" else ()):
            for _ in range(FLASH_TRAIN_STEPS):
                t0 = time.perf_counter()
                params, state, metrics = step(params, state, batch)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                losses.append(float(metrics["loss"]))
        launches, paths, kernels = counts_now(counters, fa_ops)
        peak = torch.cuda.max_memory_allocated() / 1e9
        prof = profile_call(torch, f"one {impl} train step", lambda: step(params, state, batch))
        rows[impl] = {"losses": losses, "step_s": walls, "peak_gb": peak, "launches": launches,
                      "flash_by_path": paths, "bwd_kernels": kernels,
                      **{f"step_{k}": v for k, v in prof.items()}}
        say(f"  {impl}: {FLASH_TRAIN_STEPS} steps, walls {', '.join(f'{w:.3f}' for w in walls)} s "
            f"(median {statistics.median(walls) * 1e3:.1f} ms), losses "
            f"{', '.join(f'{x:.4f}' for x in losses)}, peak allocated {peak:.2f} GB; launches "
            f"{launches}, flash by path {paths}, backward kernels {kernels}")
        assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], losses
        del params, state, step, opt
        free_card(torch)
    want = {k: 0 for k in rows["pallas"]["launches"]}
    assert rows["chunked"]["launches"] == want, rows["chunked"]["launches"]
    s = FLASH_TRAIN_STEPS
    want.update({"flash_attention": 2 * n * s, "flash_attention_bwd": n * s})  # forward, remat recompute
    assert rows["pallas"]["launches"] == want, (rows["pallas"]["launches"], want)
    assert rows["pallas"]["flash_by_path"] == {"ffma": 0, "wgmma": 2 * n * s, "bwd_ffma": n * s}
    assert rows["pallas"]["bwd_kernels"] == {"preprocess": n * s, "dkdv": n * s, "dq": n * s}
    first = [rows[impl]["losses"][0] for impl in ("chunked", "pallas")]
    gap = abs(first[1] - first[0]) / abs(first[0])
    say(f"  first step's loss: flash {first[1]:.6f} against chunked {first[0]:.6f} (relative "
        f"{gap:.2e}, tol {FLASH_TRAIN_LOSS_REL_TOL:g})")
    assert gap <= FLASH_TRAIN_LOSS_REL_TOL, gap
    layers = {}
    for i, layer in ((n - 1, 0), (0, n - 1)):      # the backward walks the layers last first
        q, k, v, o, lse, do, causal, window = caps[i]
        got = fa_ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)
        want32 = fa_ref.attention_bwd_ref(q.float(), k.float(), v.float(), do.float(),
                                          causal=causal, window=window)
        ok, errs = bwd_close(torch, got, want32, q.dtype)
        kr = k.roll(1, dims=1)
        o_r, lse_r = fa_ops.flash_attention_fwd(q, kr, v, causal=causal, window=window)
        rolled = fa_ops.flash_attention_bwd(q, kr, v, o_r, lse_r, do, causal=causal,
                                            window=window)
        _, ctl = bwd_close(torch, rolled, want32, q.dtype)
        say(f"  layer {layer}'s backward on its captured inputs {tuple(q.shape)} {q.dtype}: "
            f"dq/dk/dv relative {' '.join(f'{e:.2e}' for e in errs)} (tol "
            f"{FLASH_BWD_TOLS['bfloat16']:g}); K rolled: {' '.join(f'{e:.2e}' for e in ctl)}")
        assert q.dtype == torch.bfloat16 and ok, (layer, errs)
        assert max(ctl) > FLASH_BWD_TOLS["bfloat16"], (layer, ctl)
        layers[layer] = {"rel": errs, "k_rolled": ctl}
    rows["layers"] = layers
    del caps, params0, batch
    free_card(torch)
    return rows


def run_flash_whisper_train(torch, fa_ops, counters, device):
    """(c) one whisper-base train step under the flash route: its encoder's
    bidirectional and its decoder's causal self-attentions on the kernels
    (twice each forward under remat full), cross-attention on
    attention_chunked, every leaf changed."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import make_train_step
    from repro_torch.tree import tree_leaves

    cfg = get_config(WHISPER_ARCH).replace(attn_impl="pallas")
    n_self = cfg.n_enc_layers + cfg.total_layers
    params = params_init(torch, cfg, device)
    step, opt = make_train_step(cfg)
    state = opt.init(params)
    batch = train_batch(torch, cfg, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches((*counters, fa_ops.PATH_LAUNCHES, fa_ops.BWD_LAUNCHES))
    real, masks = fa_ops.flash_attention, []

    def tally(q, k, v, *a, **kw):
        masks.append(kw.get("causal", True))
        return real(q, k, v, *a, **kw)

    t0 = time.perf_counter()
    with mock.patch.object(fa_ops, "flash_attention", tally):
        new, state, metrics = step(params, state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, paths, kernels = counts_now(counters, fa_ops)
    loss = float(metrics["loss"])
    changed = sum(not torch.equal(a, b) for a, b in zip(tree_leaves(new), tree_leaves(params)))
    n_leaves = len(tree_leaves(new))
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_fwd = n_self * (2 if cfg.remat == "full" else 1)
    say(f"  {WHISPER_ARCH} at full width, one step (remat {cfg.remat}, {cfg.compute_dtype} "
        f"compute, frames {TRAIN_BATCH} x {TRAIN_SEQ} x {cfg.d_model}): wall {wall:.3f} s, loss "
        f"{loss:.4f}, {changed} of {n_leaves} leaves changed, peak allocated {peak:.2f} GB; "
        f"launches {launches}, flash by path {paths}, {masks.count(False)} of {len(masks)} flash "
        f"calls bidirectional, backward kernels {kernels}")
    want = {**{k: 0 for k in launches}, "flash_attention": n_fwd, "flash_attention_bwd": n_self}
    assert launches == want, (launches, want)
    assert paths == {"ffma": 0, "wgmma": n_fwd, "bwd_ffma": n_self}, paths
    assert len(masks) == n_fwd and masks.count(False) == n_fwd // n_self * cfg.n_enc_layers, masks
    assert math.isfinite(loss) and changed == n_leaves, (loss, changed, n_leaves)
    del params, new, state, batch
    free_card(torch)
    return {"step_s": wall, "loss": loss, "peak_gb": peak, "launches": launches,
            "flash_by_path": paths}


def run_flash_train_phase(torch, fa_ops, fa_ref, counters, smi, device="cuda"):
    """Phase 30: train through flash.  (a) kernel gates, (b) timings, (c)
    training: qwen-100m's f32 twin, qwen1.5-0.5b at full width, whisper-base."""
    free_card(torch)
    say("PHASE 30 train through flash: the backward of flash_attention (three FFMA kernels) "
        "against its plain version, timed, and training on it under attn_impl=\"pallas\"")
    say(f"  card: {smi}")
    t0 = time.perf_counter()
    # BWD_LAUNCHES is never reset before this phase: no earlier phase launched a backward
    assert not any(fa_ops.BWD_LAUNCHES.values()), fa_ops.BWD_LAUNCHES
    say("  (a) the lse and dq, dk, dv against their plain versions, every FLASH_CASES case")
    worst = check_flash_bwd(torch, fa_ops, fa_ref)
    say("  (b) timings")
    timings = {TRAIN_ATTN_SHAPE: time_flash_bwd(torch, fa_ops, fa_ref, TRAIN_ATTN_SHAPE, f32=True)}
    for shape in (SERVE_SHAPE, RG_ATTN_SHAPE, OLMOE_ATTN_SHAPE, WHISPER_ENC_SHAPE,
                  INTERNVL_ATTN_SHAPE):
        timings[shape] = time_flash_bwd(torch, fa_ops, fa_ref, shape)
    say("  (c) training: qwen-100m card against CPU on the flash route")
    zero_launches((*counters, fa_ops.PATH_LAUNCHES, fa_ops.BWD_LAUNCHES))
    twin = run_train_twin(torch, device, attn_impl="pallas")
    twin_launches, twin_paths, _ = counts_now(counters, fa_ops)
    n = 8      # qwen-100m's layers (remat none); on the card two value_and_grad and one step
    want = {**{k: 0 for k in twin_launches}, "flash_attention": 3 * n,
            "flash_attention_bwd": 3 * n}
    say(f"  qwen-100m launches on the card {twin_launches}, flash by path {twin_paths}")
    assert twin_launches == want, (twin_launches, want)
    assert twin_paths == {"ffma": 3 * n, "wgmma": 0, "bwd_ffma": 3 * n}, twin_paths
    say(f"  (c) {TRAIN_ARCH} at full width, {FLASH_TRAIN_STEPS} steps on each route")
    qwen = run_flash_qwen_train(torch, fa_ops, fa_ref, counters, device)
    say(f"  (c) {WHISPER_ARCH}, one step on the flash route")
    whisper = run_flash_whisper_train(torch, fa_ops, counters, device)
    say(f"  phase 30 {time.perf_counter() - t0:.1f} s")
    runs = {"qwen-100m twin (card)": (twin_launches, twin_paths),
            f"{TRAIN_ARCH} train steps": (qwen["pallas"]["launches"],
                                          qwen["pallas"]["flash_by_path"]),
            f"{WHISPER_ARCH} train step": (whisper["launches"], whisper["flash_by_path"])}
    return worst, timings, runs, {"card": smi, "qwen-100m twin": twin, TRAIN_ARCH: qwen,
                                      WHISPER_ARCH: whisper,
                                      "timings": {str(k): v for k, v in timings.items()}}


# ---------------------------------------------------------------- phase 31

SSD_BWD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bwd.cu"
# dx, ddt, da, dB, dC against the plain backward (autograd through ssd_chunked):
# f32 allclose (tests/test_kernels.py:56) against it run in f64 (in f32 it misses
# f64 by more than the limit itself at served widths: printed beside), but at
# the serve shape relative norms, as phase 10 holds the forward there (at L =
# 2,048 ddt reaches 1e3 and da 3e4, and an element that cancels to ~0.3 carries
# an ulp or two of those terms: 6e-5 each, past an absolute 1e-4; the
# elementwise reading is printed); bf16 relative norms against it in f32 on
# the same bf16 inputs
SSD_BWD_TOLS = {"float32": 1e-4, "bfloat16": 2e-2}
SSD_GRADS = ("dx", "ddt", "da", "dB", "dC")
# mamba2-1.3b's scan in a train step of batch 8 x 128
SSD_TRAIN_SHAPE = (TRAIN_BATCH, TRAIN_SEQ, 64, 64, 1, 128)
SSD_TRAIN_STEPS = 4
SSD_TRAIN_LOSS_REL_TOL = 2e-2   # the first step's loss, kernel route against chunked (bf16)
SSD_TWIN_LAYERS = 2             # mamba2-1.3b cut to 2 layers for the f32 step, card against CPU


def grads_close(torch, got, want, dtype, elementwise=True):
    """(passes, errors) for each gradient: f32 max |got - want| / (tol + tol
    |want|) (allclose fails above 1), bf16 and f32 not ``elementwise``
    relative norms."""
    tol = SSD_BWD_TOLS[str(dtype)[6:]]
    if dtype == torch.float32 and elementwise:
        errs = [float(((g.double() - w.double()).abs() / (tol + tol * w.double().abs())).max())
                for g, w in zip(got, want)]
        return [e <= 1.0 for e in errs], errs
    errs = [rel_norm(g, w) for g, w in zip(got, want)]
    return [e <= tol for e in errs], errs


def ssd_bwd_plain(torch, ssd_ref, args, dy, ds, work):
    """The plain backward at the config's chunk, run in ``work``."""
    return ssd_ref.ssd_bwd_ref(*(t.to(work) for t in args), dy.to(work),
                               None if ds is None else ds.to(work), chunk=SSD_CHUNK)


def ssd_cotangents(torch, case, dtype, with_state, seed=0):
    b, l, h, p, g, n = case
    gen = torch.Generator(device="cuda").manual_seed(seed + 200)
    dy = torch.randn((b, l, h, p), generator=gen, device="cuda").to(dtype)
    ds = torch.randn((b, h, p, n), generator=gen, device="cuda") if with_state else None
    return dy, ds


def roll_bc(args):
    """B and C rolled one step along L together (each gradient is linear in
    the inputs other than its own: dB does not see B, nor dC C)."""
    return (*args[:3], args[3].roll(1, dims=1), args[4].roll(1, dims=1))


def check_ssd_bwd(torch, ssd_ops, ssd_ref):
    """(a): dx, ddt, da, dB, dC of the backward kernels against the plain
    backward on every SSD_CASES case in f32 and bf16, with and without a
    cotangent of the final state; B and C rolled by one step must fail every
    limit.  Returns the largest errors by dtype."""
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name_dt = str(dtype)[6:]
        for name, case, strong in SSD_CASES:
            args = ssd_inputs(torch, case, dtype, strong=strong)
            for with_state in (False, True):
                dy, ds = ssd_cotangents(torch, case, dtype, with_state)
                before = dict(ssd_ops.BWD_LAUNCHES)
                got = ssd_ops.ssd_bwd(*args, dy, ds)
                torch.cuda.synchronize()
                assert ssd_ops.BWD_LAUNCHES == {k: v + 1 for k, v in before.items()}, name
                for g_, t in zip(got, args):
                    assert g_.dtype == t.dtype and g_.shape == t.shape, name
                    assert torch.isfinite(g_.float()).all(), (name, name_dt)
                work = torch.float64 if dtype == torch.float32 else torch.float32
                want = ssd_bwd_plain(torch, ssd_ref, args, dy, ds, work)
                elementwise = case != SSD_SERVE_SHAPE
                ok, errs = grads_close(torch, got, want, dtype, elementwise)
                abs_err = max(float((g_.double() - w.double()).abs().max())
                              for g_, w in zip(got, want))
                rolled = ssd_ops.ssd_bwd(*roll_bc(args), dy, ds)
                ctl_ok, ctl = grads_close(torch, rolled, want, dtype, elementwise)
                how = "rel" if dtype == torch.bfloat16 or not elementwise else "of tol"
                extra = ""
                if dtype == torch.float32:   # how far the f32 plain version is from f64
                    _, plain = grads_close(
                        torch, ssd_bwd_plain(torch, ssd_ref, args, dy, ds, torch.float32), want,
                        dtype)
                    extra = f"; the f32 plain version {' '.join(f'{e:.2f}' for e in plain)} of tol"
                    row = worst.setdefault(name_dt, {"plain_f32_over_tol": 0.0})
                    row["plain_f32_over_tol"] = max(row["plain_f32_over_tol"], max(plain))
                    if not elementwise:
                        _, over = grads_close(torch, got, want, dtype)
                        extra += f"; elementwise {' '.join(f'{e:.2f}' for e in over)} of tol"
                        row["serve_shape_elementwise_over_tol"] = max(over)
                say(f"  {name_dt:>8} {name:<28} {str(case):<28} "
                    f"{'dstate' if with_state else '      '} {'/'.join(SSD_GRADS)} "
                    f"{' '.join(f'{e:.2e}' for e in errs)} ({how}; max|err| {abs_err:.2e}); B, C "
                    f"rolled {' '.join(f'{e:.2e}' for e in ctl)}" + extra)
                assert all(ok), (name, name_dt, with_state, errs)
                assert not any(ctl_ok), (name, name_dt, with_state, ctl)
                row = worst.setdefault(name_dt, {})
                key = "grads" if elementwise else "serve_shape_rel"
                row[key] = max(row.get(key, 0.0), max(errs))
                row["max_abs_err"] = max(row.get("max_abs_err", 0.0), abs_err)
                del dy, ds, got, want, rolled
            del args
            free_card(torch)
    return worst


def ssd_bwd_issued(ssd_ops, shape):
    """FLOPs the backward kernels issue at ``shape``: each chunk of Q rows a
    (b, h) with P and N padded to the kernels' buckets, the states kernel's
    update, the chunk kernel's G, D, dx, dB, dC and dS products, the group sum."""
    b, l, h, p, g, n = shape
    q = ssd_ops.library().repro_ssd_scan_bwd_chunk_rows()
    pm, nm = (16 if p <= 16 else 64), (32 if n <= 32 else 128)
    per_chunk = 2 * (q * q * (3 * nm + 2 * pm) + 5 * q * pm * nm)
    return b * h * -(-l // q) * per_chunk + 2 * b * l * h * n


def time_ssd_bwd(torch, ssd_ops, ssd_ref, shape, f32=False):
    """(b): the backward at ``shape`` in bf16 (and f32 with ``f32``) beside
    its plain version (autograd through ssd_chunked at the config's chunk,
    forward included) and its bound: x, dt, B, C and dY read and dx, ddt,
    dB, dC written at 3.35 TB/s against the step recurrence's gradient (14
    P N FLOP a row and head: the adjoint's update, dx, dB, dC, the state
    recomputed, d(a dt)) at the bf16 peak.  No single PyTorch call computes
    it: no library time."""
    b, l, h, p, g, n = shape
    args = ssd_inputs(torch, shape, torch.bfloat16, seed=5)
    dy, _ = ssd_cotangents(torch, shape, torch.bfloat16, False, seed=5)
    row = {"ms": median_ms(torch, lambda: ssd_ops.ssd_bwd(*args, dy)),
           "plain_ms": median_ms(torch, lambda: ssd_ref.ssd_bwd_ref(*args, dy, chunk=SSD_CHUNK),
                                 reps=3, warm=1),
           "library_ms": None}
    flops = 14 * b * l * h * p * n
    issued = ssd_bwd_issued(ssd_ops, shape)
    io_bytes = 2 * (3 * b * l * h * p + 4 * b * l * g * n) + 4 * (2 * b * l * h + 2 * h)
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, io_bytes / HBM_BYTES_PER_S * 1e3
    row.update(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
               gflop=flops / 1e9, issued_gflop=issued / 1e9, io_mb=io_bytes / 1e6,
               tflops_issued=issued / row["ms"] / 1e9, shape=list(shape))
    f32_note = ""
    if f32:   # the same work in f32: twice the bytes of x, B, C, dY and their gradients, f32 FFMA
        args32, dy32 = [t.float() for t in args], dy.float()
        row["f32_ms"] = median_ms(torch, lambda: ssd_ops.ssd_bwd(*args32, dy32))
        del args32, dy32
        t_ops32 = flops / F32_FLOPS * 1e3
        t_bytes32 = (io_bytes + 2 * (3 * b * l * h * p + 4 * b * l * g * n)) / HBM_BYTES_PER_S * 1e3
        row.update(f32_bound_ms=max(t_ops32, t_bytes32),
                   f32_bound_by="operations" if t_ops32 >= t_bytes32 else "bytes")
        f32_note = (f", f32 {row['f32_ms']:.4f} ms (bound {row['f32_bound_ms']:.4f} ms, "
                    f"{row['f32_bound_by']} at 67 TFLOP/s of f32 FFMA and 3.35 TB/s)")
    say(f"  ssd_scan_bwd {shape}, bf16: {row['ms']:.4f} ms ({issued / 1e9:.2f} GFLOP issued on "
        f"FFMA, {row['tflops_issued']:.1f} TFLOP/s)" + f32_note
        + f"; plain {row['plain_ms']:.4f} ms; library null (no single PyTorch call); bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {io_bytes / 1e6:.1f} MB at 3.35 TB/s, "
        f"{flops / 1e9:.2f} GFLOP at 989 TFLOP/s); kernel / bound {row['ms'] / row['bound_ms']:.1f}")
    del args, dy
    free_card(torch)
    return row


@contextlib.contextmanager
def capture_calls(module, name, caps, keep):
    """Record the tensor arguments of the calls of ``module.name`` whose
    index is in ``keep`` (clones; None stays None): phase 31's ``ssd_bwd``
    (x, dt, a, B, C, dY, dstate), phase 32's ``rglru_bwd`` (log_a, b, dy,
    dh_final)."""
    real, n = getattr(module, name), [0]

    def spy(*args, **kw):
        if n[0] in keep:
            caps[n[0]] = [None if t is None else t.detach().clone() for t in args]
        n[0] += 1
        return real(*args, **kw)

    with mock.patch.object(module, name, spy):
        yield


def run_ssd_mamba_train(torch, ssd_ops, ssd_ref, counters, device):
    """(c) mamba2-1.3b at full width: SSD_TRAIN_STEPS train steps on the
    chunked route and on the kernel route from the same parameters and
    batch; the kernel route's launches counted; layers 0 and 47's captured
    backward inputs held against the plain backward."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import make_train_step

    cfg = get_config(MAMBA_ARCH)
    n = cfg.total_layers
    params0 = params_init(torch, cfg, device)
    batch = train_batch(torch, cfg, device)
    rows, caps = {}, {}
    for impl in ("chunked", "pallas"):
        t_route = time.perf_counter()
        step, opt = make_train_step(cfg.replace(ssm_impl=impl))
        params, state = params0, opt.init(params0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches((*counters, ssd_ops.PATH_LAUNCHES, ssd_ops.BWD_LAUNCHES))
        losses, walls = [], []
        with capture_calls(ssd_ops, "ssd_bwd", caps, (0, n - 1) if impl == "pallas" else ()):
            for _ in range(SSD_TRAIN_STEPS):
                t0 = time.perf_counter()
                params, state, metrics = step(params, state, batch)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                losses.append(float(metrics["loss"]))
        launches, paths, kernels = counts_now(counters, ssd_ops)
        peak = torch.cuda.max_memory_allocated() / 1e9
        prof = profile_call(torch, f"one {impl} train step", lambda: step(params, state, batch),
                            share_of=("ssd_bwd", "ssd_wgmma_kernel"))
        rows[impl] = {"losses": losses, "step_s": walls, "peak_gb": peak, "launches": launches,
                      "ssd_by_path": paths, "bwd_kernels": kernels,
                      **{f"step_{k}": v for k, v in prof.items()}}
        say(f"  {impl}: {SSD_TRAIN_STEPS} steps, walls {', '.join(f'{w:.3f}' for w in walls)} s "
            f"(median {statistics.median(walls) * 1e3:.1f} ms), losses "
            f"{', '.join(f'{x:.4f}' for x in losses)}, peak allocated {peak:.2f} GB; launches "
            f"{launches}, ssd_scan by path {paths}, backward kernels {kernels}")
        assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], losses
        del params, state, step, opt
        free_card(torch)
        say(f"  the {impl} route's run, profile included: {time.perf_counter() - t_route:.1f} s")
    want = {k: 0 for k in rows["pallas"]["launches"]}
    assert rows["chunked"]["launches"] == want, rows["chunked"]["launches"]
    s = SSD_TRAIN_STEPS
    want.update({"ssd_scan": 2 * n * s, "ssd_scan_bwd": n * s})   # forward, remat recompute
    assert rows["pallas"]["launches"] == want, (rows["pallas"]["launches"], want)
    assert rows["pallas"]["ssd_by_path"] == {"ffma": 0, "wgmma": 2 * n * s, "bwd_ffma": n * s}
    assert rows["pallas"]["bwd_kernels"] == {"states": n * s, "dchunk": n * s, "group_sum": n * s}
    first = [rows[impl]["losses"][0] for impl in ("chunked", "pallas")]
    gap = abs(first[1] - first[0]) / abs(first[0])
    say(f"  first step's loss: kernels {first[1]:.6f} against chunked {first[0]:.6f} (relative "
        f"{gap:.2e}, tol {SSD_TRAIN_LOSS_REL_TOL:g})")
    assert gap <= SSD_TRAIN_LOSS_REL_TOL, gap
    layers = {}
    for i, layer in ((n - 1, 0), (0, n - 1)):      # the backward walks the layers last first
        args, (dy, ds) = caps[i][:5], caps[i][5:]
        got = ssd_ops.ssd_bwd(*args, dy, ds)
        want32 = ssd_bwd_plain(torch, ssd_ref, args, dy, ds, torch.float32)
        ok, errs = grads_close(torch, got, want32, args[0].dtype)
        ctl_ok, ctl = grads_close(torch, ssd_ops.ssd_bwd(*roll_bc(args), dy, ds), want32,
                                      args[0].dtype)
        say(f"  layer {layer}'s backward on its captured inputs {tuple(args[0].shape)} "
            f"{args[0].dtype}: {'/'.join(SSD_GRADS)} relative {' '.join(f'{e:.2e}' for e in errs)} "
            f"(tol {SSD_BWD_TOLS['bfloat16']:g}); B, C rolled: {' '.join(f'{e:.2e}' for e in ctl)}")
        assert args[0].dtype == torch.bfloat16 and all(ok), (layer, errs)
        assert not any(ctl_ok), (layer, ctl)
        layers[layer] = {"rel": errs, "bc_rolled": ctl}
    rows["layers"] = layers
    del caps, params0, batch
    free_card(torch)
    return rows


def mamba_twin_config():
    from repro_torch.configs.base import LayerGroup
    from repro_torch.configs.registry import get_config

    cfg = get_config(MAMBA_ARCH)
    return cfg.replace(n_layers=SSD_TWIN_LAYERS, ssm_impl="pallas",
                       groups=(LayerGroup(cfg.groups[0].pattern, SSD_TWIN_LAYERS),))


def run_ssd_train_phase(torch, ssd_ops, ssd_ref, counters, smi, device="cuda"):
    """Phase 31: train through ssd_scan.  (a) kernel gates, (b) timings, (c)
    mamba2-1.3b at full width on both routes, (d) its f32 twin, card
    against CPU."""
    free_card(torch)
    say("PHASE 31 train through ssd_scan: the backward of ssd_scan (three FFMA kernels) against "
        "its plain version, timed, and training on it under ssm_impl=\"pallas\"")
    say(f"  card: {smi}")
    t0 = time.perf_counter()
    # BWD_LAUNCHES is never reset before this phase: no earlier phase launched the backward
    assert not any(ssd_ops.BWD_LAUNCHES.values()), ssd_ops.BWD_LAUNCHES
    zero_launches(counters)
    say("  (a) dx, ddt, da, dB, dC against the plain backward, every SSD_CASES case")
    worst = check_ssd_bwd(torch, ssd_ops, ssd_ref)
    say(f"  (b) timings; (a) took {time.perf_counter() - t0:.1f} s")
    timings = {"train bf16": time_ssd_bwd(torch, ssd_ops, ssd_ref, SSD_TRAIN_SHAPE, f32=True),
               "serve bf16": time_ssd_bwd(torch, ssd_ops, ssd_ref, SSD_SERVE_SHAPE)}
    quiet = {k: v for counts in counters for k, v in counts.items() if k != "ssd_scan_bwd"}
    assert not any(quiet.values()), quiet        # (a) and (b) launch the backward alone
    say(f"  (c) {MAMBA_ARCH} at full width, {SSD_TRAIN_STEPS} steps on each route; so far "
        f"{time.perf_counter() - t0:.1f} s")
    mamba = run_ssd_mamba_train(torch, ssd_ops, ssd_ref, counters, device)
    say(f"  (d) {MAMBA_ARCH} cut to {SSD_TWIN_LAYERS} layers, f32: card (kernels) against CPU "
        f"(plain versions); so far {time.perf_counter() - t0:.1f} s")
    zero_launches((*counters, ssd_ops.PATH_LAUNCHES, ssd_ops.BWD_LAUNCHES))
    twin_cfg = mamba_twin_config()
    twin = run_train_twin(torch, device, cfg=twin_cfg)
    twin_launches, twin_paths, _ = counts_now(counters, ssd_ops)
    n, fwd = SSD_TWIN_LAYERS, 2 if twin_cfg.remat == "full" else 1
    # on the card two value_and_grad (the batch, the rolled control) and one step
    want = {**{k: 0 for k in twin_launches}, "ssd_scan": 3 * n * fwd, "ssd_scan_bwd": 3 * n}
    say(f"  {twin_cfg.name} ({n} layers) launches on the card {twin_launches}, ssd_scan by path "
        f"{twin_paths}")
    assert twin_launches == want, (twin_launches, want)
    assert twin_paths == {"ffma": 3 * n * fwd, "wgmma": 0, "bwd_ffma": 3 * n}, twin_paths
    say(f"  phase 31 {time.perf_counter() - t0:.1f} s")
    runs = {f"{MAMBA_ARCH} train steps": (mamba["pallas"]["launches"],
                                          mamba["pallas"]["ssd_by_path"]),
            f"{MAMBA_ARCH} ({n} layers) f32 twin (card)": (twin_launches, twin_paths)}
    return worst, timings, runs, {"card": smi, MAMBA_ARCH: mamba, "f32 twin": twin,
                                  "timings": timings}


# ---------------------------------------------------------------- phase 32

RGLRU_BWD_SOURCE = "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan_bwd.cu"
# dlog_a and db against the plain backward (ref.rglru_bwd): f32 allclose 1e-4
# (tests/test_kernels.py:56) against it run in f64, the serve shape too; bf16
# relative norms 2e-2 against it in f32 on the same bf16 inputs.  grads_close
# reads SSD_BWD_TOLS, the same limits.
RGLRU_GRADS = ("dlog_a", "db")
# recurrentgemma-9b's scan and attention in a train step of batch 8 x 128
RGLRU_TRAIN_SHAPE = (TRAIN_BATCH, TRAIN_SEQ, 4096)
RG_TRAIN_ATTN_SHAPE = (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 16, 1, 256, True, 2048)
RG_TRAIN_STEPS = 4
RG_TRAIN_LOSS_REL_TOL = 2e-2    # the first step's loss, kernel routes against plain (bf16)


def lru_cotangents(torch, case, dtype, with_state, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed + 300)
    dy = torch.randn(case, generator=gen, device="cuda").to(dtype)
    dh = torch.randn((case[0], case[2]), generator=gen, device="cuda") if with_state else None
    return dy, dh


def roll_lru(args):
    """log_a and b rolled one step along L together (db does not see b)."""
    return tuple(t.roll(1, dims=1) for t in args)


def lru_bwd_plain(lru_ref, args, dy, dh, work):
    """The plain backward, run in ``work``."""
    return lru_ref.rglru_bwd(*(t.to(work) for t in args), dy.to(work),
                             None if dh is None else dh.to(work))


def check_lru_bwd(torch, lru_ops, lru_ref):
    """(a): dlog_a and db of the backward kernel against the plain backward
    on every RGLRU_CASES case in f32 and bf16, with and without a cotangent
    of the final state; log_a and b rolled by one step must fail every
    limit.  Returns the largest errors by dtype."""
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name_dt = str(dtype)[6:]
        for name, case in RGLRU_CASES:
            args = rglru_inputs(torch, case, dtype)
            for with_state in (False, True):
                dy, dh = lru_cotangents(torch, case, dtype, with_state)
                before = dict(lru_ops.BWD_LAUNCHES)
                got = lru_ops.rglru_bwd(*args, dy, dh)
                torch.cuda.synchronize()
                assert lru_ops.BWD_LAUNCHES == {k: v + 1 for k, v in before.items()}, name
                for g_, t in zip(got, args):
                    assert g_.dtype == t.dtype and g_.shape == t.shape, name
                    assert torch.isfinite(g_.float()).all(), (name, name_dt)
                work = torch.float64 if dtype == torch.float32 else torch.float32
                want = lru_bwd_plain(lru_ref, args, dy, dh, work)
                ok, errs = grads_close(torch, got, want, dtype)
                abs_err = max(float((g_.double() - w.double()).abs().max())
                              for g_, w in zip(got, want))
                rolled = lru_ops.rglru_bwd(*roll_lru(args), dy, dh)
                ctl_ok, ctl = grads_close(torch, rolled, want, dtype)
                how = "rel" if dtype == torch.bfloat16 else "of tol"
                say(f"  {name_dt:>8} {name:<32} {str(case):<18} "
                    f"{'dh_final' if with_state else '        '} {'/'.join(RGLRU_GRADS)} "
                    f"{' '.join(f'{e:.2e}' for e in errs)} ({how}; max|err| {abs_err:.2e}); "
                    f"log_a, b rolled {' '.join(f'{e:.2e}' for e in ctl)}")
                assert all(ok), (name, name_dt, with_state, errs)
                assert not any(ctl_ok), (name, name_dt, with_state, ctl)
                row = worst.setdefault(name_dt, {})
                row["grads"] = max(row.get("grads", 0.0), max(errs))
                row["max_abs_err"] = max(row.get("max_abs_err", 0.0), abs_err)
                del dy, dh, got, want, rolled
            del args
            free_card(torch)
    return worst


def time_lru_bwd(torch, lru_ops, lru_ref, shape):
    """(b): the backward at ``shape`` in f32 beside its plain version
    (torch.autograd.grad through ``rglru_associative``, forward included)
    and its bound: log_a, b and dy read and dlog_a and db written at 3.35
    TB/s against 6 flops an element (h's update, dh's, dlog_a's, the carry)
    at the f32 FFMA rate.  No single PyTorch call computes it: no library
    time."""
    log_a, b = rglru_inputs(torch, shape, torch.float32, seed=6)
    dy, _ = lru_cotangents(torch, shape, torch.float32, False, seed=6)

    def plain():
        la, bb = log_a.detach().requires_grad_(), b.detach().requires_grad_()
        return torch.autograd.grad(lru_ref.rglru_associative(la, bb)[0], (la, bb), dy)

    row = {"ms": median_ms(torch, lambda: lru_ops.rglru_bwd(log_a, b, dy)),
           "plain_ms": median_ms(torch, plain, reps=5, warm=1), "library_ms": None}
    n = log_a.numel()
    io_bytes, flops = 4 * 5 * n, 6 * n
    t_ops, t_bytes = flops / F32_FLOPS * 1e3, io_bytes / HBM_BYTES_PER_S * 1e3
    row.update(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
               io_mb=io_bytes / 1e6, tb_per_s=io_bytes / row["ms"] / 1e9, shape=list(shape))
    say(f"  rglru_scan_bwd {shape}, f32: {row['ms']:.4f} ms ({row['tb_per_s']:.2f} TB/s of the "
        f"{io_bytes / 1e6:.1f} MB it must move); plain {row['plain_ms']:.4f} ms; library null (no "
        f"single PyTorch call); bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
        f"{io_bytes / 1e6:.1f} MB at 3.35 TB/s, {flops / 1e9:.3f} GFLOP at 67 TFLOP/s of f32 "
        f"FFMA); kernel / bound {row['ms'] / row['bound_ms']:.2f}")
    del log_a, b, dy
    free_card(torch)
    return row


def rg_train_config():
    """recurrentgemma-9b at full width cut to its two groups once each:
    (rglru, rglru, local attention) + (rglru, rglru), 5 of its 38 layers."""
    from repro_torch.configs.base import LayerGroup
    from repro_torch.configs.registry import get_config

    cfg = get_config(RGEMMA_ARCH)
    groups = tuple(LayerGroup(g.pattern, 1) for g in cfg.groups)
    return cfg.replace(n_layers=sum(g.n_layers for g in groups), groups=groups)


def rg_twin_config():
    """recurrentgemma-9b's (rglru, rglru) group once at full width, f32
    parameters, on the kernel route."""
    from repro_torch.configs.base import LayerGroup
    from repro_torch.configs.registry import get_config

    cfg = get_config(RGEMMA_ARCH)
    return cfg.replace(n_layers=2, groups=(LayerGroup(cfg.groups[-1].pattern, 1),),
                       param_dtype="float32", rglru_impl="pallas")


def lru_layers(cfg):
    return sum(g.repeat for g in cfg.groups for spec in g.pattern if spec.mixer == "rglru")


def run_rg_train(torch, lru_ops, lru_ref, fa_ops, counters, device):
    """(c) recurrentgemma-9b at full width, cut to 5 layers: RG_TRAIN_STEPS
    train steps on the plain routes and on the kernel routes from the same
    parameters and batch; the kernel routes' launches counted; the first and
    last RG-LRU layers' captured backward inputs held against the plain
    backward."""
    from repro_torch.models.registry import make_train_step

    cfg = rg_train_config()
    n_lru = lru_layers(cfg)
    n_attn = cfg.total_layers - n_lru
    say(f"  {RGEMMA_ARCH} at full width cut to {cfg.total_layers} of its 38 layers (its two "
        f"groups once each: {n_lru} RG-LRU, {n_attn} local attention; {cfg.param_count() / 1e9:.2f} "
        f"B parameters, {cfg.param_dtype}; {cfg.compute_dtype} compute, remat {cfg.remat}, "
        f"{cfg.optimizer} clip {cfg.grad_clip:g}), batch {TRAIN_BATCH} x {TRAIN_SEQ}")
    params0 = params_init(torch, cfg, device)
    batch = train_batch(torch, cfg, device)
    rows, caps = {}, {}
    routes = {"plain": dict(attn_impl="chunked", rglru_impl="associative"),
              "kernels": dict(attn_impl="pallas", rglru_impl="pallas")}
    for label, over in routes.items():
        t_route = time.perf_counter()
        step, opt = make_train_step(cfg.replace(**over))
        params, state = params0, opt.init(params0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches((*counters, fa_ops.PATH_LAUNCHES, fa_ops.BWD_LAUNCHES, lru_ops.BWD_LAUNCHES))
        losses, walls = [], []
        keep = (0, n_lru - 1) if label == "kernels" else ()
        with capture_calls(lru_ops, "rglru_bwd", caps, keep):
            for _ in range(RG_TRAIN_STEPS):
                t0 = time.perf_counter()
                params, state, metrics = step(params, state, batch)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                losses.append(float(metrics["loss"]))
        launches, paths, _ = counts_now(counters, fa_ops)
        lru_kernels = dict(lru_ops.BWD_LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 1e9
        prof = profile_call(torch, f"one {label} train step", lambda: step(params, state, batch),
                            share_of=("rglru_bwd_kernel", "rglru_kernel", "flash_fwd", "flash_bwd"))
        rows[label] = {"losses": losses, "step_s": walls, "peak_gb": peak, "launches": launches,
                       "flash_by_path": paths, "rglru_bwd_kernels": lru_kernels,
                       **{f"step_{k}": v for k, v in prof.items()}}
        say(f"  {label} ({over}): {RG_TRAIN_STEPS} steps, walls "
            f"{', '.join(f'{w:.3f}' for w in walls)} s (median "
            f"{statistics.median(walls) * 1e3:.1f} ms), losses "
            f"{', '.join(f'{x:.4f}' for x in losses)}, peak allocated {peak:.2f} GB; launches "
            f"{launches}, flash by path {paths}, RG-LRU backward kernel {lru_kernels}")
        assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], losses
        del params, state, step, opt
        free_card(torch)
        say(f"  the {label} routes' run, profile included: {time.perf_counter() - t_route:.1f} s")
    want = {k: 0 for k in rows["kernels"]["launches"]}
    assert rows["plain"]["launches"] == want, rows["plain"]["launches"]
    s = RG_TRAIN_STEPS
    want.update({"rglru_scan": 2 * n_lru * s, "rglru_scan_bwd": n_lru * s,   # forward, remat
                 "flash_attention": 2 * n_attn * s, "flash_attention_bwd": n_attn * s})
    assert rows["kernels"]["launches"] == want, (rows["kernels"]["launches"], want)
    paths = rows["kernels"]["flash_by_path"]
    assert paths["ffma"] + paths["wgmma"] == 2 * n_attn * s and paths["bwd_ffma"] == n_attn * s, paths
    assert rows["kernels"]["rglru_bwd_kernels"] == {"reverse_scan": n_lru * s}
    first = [rows[label]["losses"][0] for label in routes]
    gap = abs(first[1] - first[0]) / abs(first[0])
    say(f"  first step's loss: kernels {first[1]:.6f} against plain {first[0]:.6f} (relative "
        f"{gap:.2e}, tol {RG_TRAIN_LOSS_REL_TOL:g})")
    assert gap <= RG_TRAIN_LOSS_REL_TOL, gap
    layers = {}
    for i, layer in ((n_lru - 1, 0), (0, n_lru - 1)):   # the backward walks the layers last first
        args, (dy, dh) = caps[i][:2], caps[i][2:]
        got = lru_ops.rglru_bwd(*args, dy, dh)
        want64 = lru_bwd_plain(lru_ref, args, dy, dh, torch.float64)
        # relative norms: the gradients of a train step are far below an absolute 1e-4
        ok, errs = grads_close(torch, got, want64, args[1].dtype, elementwise=False)
        _, over = grads_close(torch, got, want64, args[1].dtype)
        ctl_ok, ctl = grads_close(torch, lru_ops.rglru_bwd(*roll_lru(args), dy, dh), want64,
                                  args[1].dtype, elementwise=False)
        scale = max(float(w.abs().max()) for w in want64)
        say(f"  RG-LRU layer {layer}'s backward on its captured inputs {tuple(args[1].shape)} "
            f"{args[1].dtype}, dh_final {'none' if dh is None else 'given'}: "
            f"{'/'.join(RGLRU_GRADS)} relative {' '.join(f'{e:.2e}' for e in errs)} (tol "
            f"{SSD_BWD_TOLS['float32']:g}; elementwise {' '.join(f'{e:.2f}' for e in over)} of "
            f"tol, largest |gradient| {scale:.2e}); log_a, b rolled: "
            f"{' '.join(f'{e:.2e}' for e in ctl)}")
        assert args[1].dtype == torch.float32 and all(ok), (layer, errs)
        assert not any(ctl_ok), (layer, ctl)
        layers[layer] = {"rel": errs, "elementwise_over_tol": over, "rolled": ctl}
    rows["layers"] = layers
    del caps, params0, batch
    free_card(torch)
    return rows


def run_rglru_train_phase(torch, lru_ops, lru_ref, fa_ops, fa_ref, counters, smi, device="cuda"):
    """Phase 32: train through rglru_scan.  (a) kernel gates, (b) timings, (c)
    recurrentgemma-9b at full width cut to 5 layers on both routes, (d) its
    f32 twin, card against CPU."""
    free_card(torch)
    say("PHASE 32 train through rglru_scan: the backward of rglru_scan (one kernel) against its "
        "plain version, timed, and training on it and flash under rglru_impl=\"pallas\", "
        "attn_impl=\"pallas\"")
    say(f"  card: {smi}")
    t0 = time.perf_counter()
    # BWD_LAUNCHES is never reset before this phase: no earlier phase launched the backward
    assert not any(lru_ops.BWD_LAUNCHES.values()), lru_ops.BWD_LAUNCHES
    zero_launches(counters)
    say("  (a) dlog_a and db against the plain backward, every RGLRU_CASES case")
    worst = check_lru_bwd(torch, lru_ops, lru_ref)
    say(f"  (b) timings; (a) took {time.perf_counter() - t0:.1f} s")
    timings = {"train f32": time_lru_bwd(torch, lru_ops, lru_ref, RGLRU_TRAIN_SHAPE),
               "serve f32": time_lru_bwd(torch, lru_ops, lru_ref, RGLRU_SERVE_SHAPE)}
    quiet = {k: v for counts in counters for k, v in counts.items() if k != "rglru_scan_bwd"}
    assert not any(quiet.values()), quiet        # (a) and (b) launch the backward alone
    say(f"  the flash backward at {RGEMMA_ARCH}'s training shape")
    flash_row = time_flash_bwd(torch, fa_ops, fa_ref, RG_TRAIN_ATTN_SHAPE)
    say(f"  (c) {RGEMMA_ARCH}, {RG_TRAIN_STEPS} steps on each route; so far "
        f"{time.perf_counter() - t0:.1f} s")
    rg = run_rg_train(torch, lru_ops, lru_ref, fa_ops, counters, device)
    twin_cfg = rg_twin_config()
    n = lru_layers(twin_cfg)
    say(f"  (d) {RGEMMA_ARCH} cut to one (rglru, rglru) group ({n} layers) at full width, f32: "
        f"card (kernels) against CPU (plain versions); so far {time.perf_counter() - t0:.1f} s")
    zero_launches((*counters, fa_ops.PATH_LAUNCHES, lru_ops.BWD_LAUNCHES))
    twin = run_train_twin(torch, device, cfg=twin_cfg)
    twin_launches, twin_paths, _ = counts_now(counters, fa_ops)
    fwd = 2 if twin_cfg.remat == "full" else 1
    # on the card two value_and_grad (the batch, the rolled control) and one step
    want = {**{k: 0 for k in twin_launches}, "rglru_scan": 3 * n * fwd, "rglru_scan_bwd": 3 * n}
    say(f"  {twin_cfg.name} ({n} layers) launches on the card {twin_launches}")
    assert twin_launches == want, (twin_launches, want)
    assert lru_ops.BWD_LAUNCHES == {"reverse_scan": 3 * n}, lru_ops.BWD_LAUNCHES
    say(f"  phase 32 {time.perf_counter() - t0:.1f} s")
    runs = {f"{RGEMMA_ARCH} (5 layers) train steps": (rg["kernels"]["launches"],
                                                       rg["kernels"]["flash_by_path"]),
            f"{RGEMMA_ARCH} ({n} layers) f32 twin (card)": (twin_launches, twin_paths)}
    return worst, timings, flash_row, runs, {
        "card": smi, f"{RGEMMA_ARCH} (5 layers)": rg, "f32 twin": twin, "timings": timings,
        f"flash_attention_bwd {list(RG_TRAIN_ATTN_SHAPE)}": flash_row}


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
    say("  flash_attention backward dynamic shared memory a block (dK/dV, dQ): " + ", ".join(
        f"D<={d} {fa_ops.library().repro_flash_attention_bwd_smem_bytes(d, 0)}, "
        f"{fa_ops.library().repro_flash_attention_bwd_smem_bytes(d, 1)} B" for d in (32, 64, 128, 256)))
    say("  ssd_scan dynamic shared memory a block: " + "; ".join(
        f"{path}: " + ", ".join(f"P<={p} N<={n} {ssd_ops.library().repro_ssd_scan_smem_bytes(code, p, n)} B"
                                for p, n in ((16, 32), (16, 128), (64, 32), (64, 64), (64, 128)))
        for path, code in ssd_ops.PATHS.items()))
    say("  ssd_scan backward dynamic shared memory a block (states, dchunk): " + ", ".join(
        f"P<={p} N<={n} {ssd_ops.library().repro_ssd_scan_bwd_smem_bytes(0, p, n)}, "
        f"{ssd_ops.library().repro_ssd_scan_bwd_smem_bytes(1, p, n)} B"
        for p, n in ((16, 32), (16, 128), (64, 32), (64, 128))))
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
                  for shape in (SERVE_SHAPE, RG_ATTN_SHAPE, OLMOE_ATTN_SHAPE, WHISPER_ENC_SHAPE,
                                INTERNVL_ATTN_SHAPE)}
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
    n_lru = lru_layers(cfg)
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
    fp, _ = teacher_forced_logits(torch, cfg.replace(kv_cache_quant=False, **KERNEL_ROUTES), res)
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
    say(f"  so far {time.perf_counter() - t_all:.1f} s")

    say(f"PHASE 25 multihost: the flat deployment of repro_torch.launch.multihost at hidden "
        f"{MH_HIDDEN}: the FLServer and 8 spawned worker processes on the card over loopback "
        f"TCP, against the inline run; int8 uplink; a ChaosProxy; the card against the CPU")
    multihost_launches, multihost_row = run_multihost_phase(torch, counters, smi)
    say(json.dumps({"multihost": multihost_row}))
    say(f"  so far {time.perf_counter() - t_all:.1f} s")

    say(f"PHASE 26 hier: the hierarchical tree of repro_torch.fed.hier, a root in this process "
        f"over spawned leaf processes: {HIER_CLIENTS} simulated clients in three encodings and "
        f"at the main path's client width, chaos, a leaf SIGKILL, {HIER_SCALE[0]:,} clients over "
        f"two tiers, and phase 25's world trained on the card through 2 leaves")
    zero_launches(counters)
    hier_row = run_hier_phase(torch, mcfg, smi)
    hier_launches = {k: v for counts in counters for k, v in counts.items()}
    say(f"  kernel launches in this process during phase 26: {hier_launches}")
    assert not any(hier_launches.values()), "a kernel launched on the hierarchical path"
    say(json.dumps({"hier": hier_row}))
    say(f"  so far {time.perf_counter() - t_all:.1f} s")

    whisper_launches, whisper_layer_err = run_whisper_phase(torch, counters, no_launches)
    say(f"  so far {time.perf_counter() - t_all:.1f} s")
    internvl_launches = run_internvl_phase(torch, counters, no_launches)
    say(f"  so far {time.perf_counter() - t_all:.1f} s")
    train_launches, train_tgmm_paths, train_rows, train_row = run_train_phase(
        torch, ops, ref, counters, smi)
    say(json.dumps({"train": train_row}))
    say(f"  so far {time.perf_counter() - t_all:.1f} s")
    bwd_errs, bwd_rows, bwd_runs, flash_train_row = run_flash_train_phase(
        torch, fa_ops, fa_ref, counters, smi)
    say(json.dumps({"train through flash": flash_train_row}))
    say(f"  so far {time.perf_counter() - t_all:.1f} s")
    ssd_bwd_errs, ssd_bwd_rows, ssd_bwd_runs, ssd_train_row = run_ssd_train_phase(
        torch, ssd_ops, ssd_ref, counters, smi)
    say(json.dumps({"train through ssd_scan": ssd_train_row}))
    say(f"  so far {time.perf_counter() - t_all:.1f} s")
    lru_bwd_errs, lru_bwd_rows, rg_flash_bwd, lru_bwd_runs, rg_train_row = run_rglru_train_phase(
        torch, lru_ops, lru_ref, fa_ops, fa_ref, counters, smi)
    say(json.dumps({"train through rglru_scan": rg_train_row}))
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
    train_key = f"{OLMOE_ARCH} train steps ({TRAIN_MOE_LAYERS} layers)"
    train_keys = (*timing_keys, "path", "tflop_per_s", "M", "K", "N", "G")
    kernels[1].update({
        "launches": (launches["tgmm"] + option_launches["tgmm"] + fabric_launches["tgmm"]
                     + train_launches["tgmm"]),
        "launches_by_path": {"femnist-mlp rounds": launches["tgmm"],
                             "femnist-mlp rounds, other options": option_launches["tgmm"],
                             "femnist-mlp fabric, tenant A": fabric_launches["tgmm"],
                             "femnist-mlp multihost (server process)":
                                 multihost_launches["tgmm"],
                             train_key: train_launches["tgmm"]},
        "path": rows[1]["path"], "wrapper_ms": rows[1]["wrapper_ms"],
        "launches_by_kernel_path": {p: tgmm_paths[p] + option_launches["tgmm_by_path"][p]
                                    + fabric_tgmm_paths[p] + train_tgmm_paths[p]
                                    for p in tgmm_paths},
        "max_abs_err_by_path": tgmm_errs,
        "by_path": {r["layer"]: {"float32": r["by_path"], "bfloat16": r["bfloat16"]["by_path"]}
                    for r in rows if r["name"] == "tgmm"},
        "layers": {r["layer"]: {**{k: r[k] for k in (*timing_keys, "path", "wrapper_ms")},
                                "bfloat16": r["bfloat16"]}
                   for r in rows if r["name"] == "tgmm"},
        OLMOE_ARCH: {key: {k: r[k] for k in (*timing_keys, "path", "wrapper_ms", "tflop_per_s")}
                     for key, r in moe_tgmm_rows.items()},
        train_key: {key: {k: r[k] for k in train_keys}
                    for key, r in train_rows.items() if r["kernel"] == "tgmm"},
    })
    kernels[0].update({
        "launches": (launches["gmm"] + olmoe_launches["gmm"] + option_launches["gmm"]
                     + fabric_launches["gmm"] + train_launches["gmm"]),
        "launches_by_path": {"femnist-mlp rounds": launches["gmm"],
                             OLMOE_ARCH: olmoe_launches["gmm"],
                             "femnist-mlp rounds, other options": option_launches["gmm"],
                             "femnist-mlp fabric, tenant A": fabric_launches["gmm"],
                             "femnist-mlp multihost (server process)":
                                 multihost_launches["gmm"],
                             train_key: train_launches["gmm"]},
        "path": rows[0]["path"], "wrapper_ms": rows[0]["wrapper_ms"],
        OLMOE_ARCH: {f"{name}, {prod}": {k: r[k] for k in (*timing_keys, "path", "wrapper_ms")}
                     for (name, prod), r in moe_rows.items()},
        train_key: {key: {k: r[k] for k in train_keys}
                    for key, r in train_rows.items() if r["kernel"] == "gmm"},
    })
    flash_row = flash_rows[SERVE_SHAPE]
    flash_paths = {SERVE_ARCH: qwen_launches, RGEMMA_ARCH: rgemma_launches,
                   OLMOE_ARCH: olmoe_launches, f"{SERVE_ARCH} (int8 KV cache)": int8_launches,
                   WHISPER_ARCH: whisper_launches, INTERNVL_ARCH: internvl_launches}
    flash_keys = (*timing_keys, "path", "ffma_bf16_ms", "f32_ms", "tflops")
    flash_train = {f"{k} (phase 30)": {"flash_attention": counts["flash_attention"],
                                       "flash_attention_by_path": paths}
                   for k, (counts, paths) in bwd_runs.items()}
    lru_train = {f"{k} (phase 32)": (counts, paths) for k, (counts, paths) in lru_bwd_runs.items()}
    flash_train.update({k: {"flash_attention": counts["flash_attention"],
                            "flash_attention_by_path": paths}
                        for k, (counts, paths) in lru_train.items()})
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": "src/repro/kernels/flash_attention/kernel.py:89",
        "launches": sum(p["flash_attention"] for p in (*flash_paths.values(),
                                                       *flash_train.values())),
        "launches_by_path": {k: p["flash_attention"] for k, p in (*flash_paths.items(),
                                                                  *flash_train.items())},
        "launches_by_kernel_path": {path: sum(p["flash_attention_by_path"][path]
                                              for p in (*flash_paths.values(),
                                                        *flash_train.values()))
                                    for path in fa_ops.PATHS},
        "launches_noncausal": sum(p["flash_attention_noncausal"] for p in flash_paths.values()),
        "max_abs_err": worst["flash_attention"], "max_abs_err_by_path": flash_errs,
        **{k: flash_row[k] for k in flash_keys},
        RGEMMA_ARCH: {k: flash_rows[RG_ATTN_SHAPE][k] for k in flash_keys},
        OLMOE_ARCH: {k: flash_rows[OLMOE_ATTN_SHAPE][k] for k in flash_keys},
        f"{WHISPER_ARCH} encoder": {k: flash_rows[WHISPER_ENC_SHAPE][k] for k in flash_keys},
        INTERNVL_ARCH: {k: flash_rows[INTERNVL_ATTN_SHAPE][k] for k in flash_keys},
        "served_layers_bf16_rel_norm": {WHISPER_ARCH: whisper_layer_err},
    })
    bwd_row = bwd_rows[TRAIN_ATTN_SHAPE]
    bwd_keys = (*timing_keys, "gflop", "issued_gflop", "io_mb", "tflops_issued", "shape")
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda", "source": FLASH_BWD_SOURCE,
        "replaces": "src/repro/kernels/flash_attention/ops.py:43",
        "launches": sum(counts["flash_attention_bwd"]
                        for counts, _ in (*bwd_runs.values(), *lru_train.values())),
        "launches_by_path": {**{f"{k} (phase 30)": counts["flash_attention_bwd"]
                                for k, (counts, _) in bwd_runs.items()},
                             **{k: counts["flash_attention_bwd"]
                                for k, (counts, _) in lru_train.items()}},
        "launches_note": "backward calls of phases 30 and 32's training runs, three kernel "
                         "launches each (preprocess, dK/dV, dQ); 0 in phases 1-29",
        "path": "ffma", "dtype": "bfloat16",
        "max_abs_err": bwd_errs["bfloat16"]["max_abs_err"], "max_err_by_dtype": bwd_errs,
        **{k: bwd_row[k] for k in bwd_keys}, "f32_ms": bwd_row["f32_ms"],
        SERVE_ARCH: {k: bwd_rows[SERVE_SHAPE][k] for k in bwd_keys},
        RGEMMA_ARCH: {k: bwd_rows[RG_ATTN_SHAPE][k] for k in bwd_keys},
        OLMOE_ARCH: {k: bwd_rows[OLMOE_ATTN_SHAPE][k] for k in bwd_keys},
        f"{WHISPER_ARCH} encoder": {k: bwd_rows[WHISPER_ENC_SHAPE][k] for k in bwd_keys},
        INTERNVL_ARCH: {k: bwd_rows[INTERNVL_ATTN_SHAPE][k] for k in bwd_keys},
        f"{RGEMMA_ARCH} training shape": {k: rg_flash_bwd[k] for k in bwd_keys},
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
    ssd_train = {f"{k} (phase 31)": (counts, paths) for k, (counts, paths) in ssd_bwd_runs.items()}
    kernels[-2].update({
        "launches": mamba_launches["ssd_scan"] + sum(c["ssd_scan"] for c, _ in ssd_train.values()),
        "launches_by_path": {MAMBA_ARCH: mamba_launches["ssd_scan"],
                             **{k: c["ssd_scan"] for k, (c, _) in ssd_train.items()}},
        "path": scan_rows["ssd_scan"]["path"], "dtype": "bfloat16",
        "launches_by_kernel_path": {p: mamba_launches["ssd_scan_by_path"][p]
                                    + sum(paths[p] for _, paths in ssd_train.values())
                                    for p in ssd_ops.PATHS},
        "max_abs_err_by_path": ssd_errs,
        "by_path": scan_rows["ssd_scan"]["by_path"],
    })
    ssd_bwd_row = ssd_bwd_rows["train bf16"]
    kernels.insert(len(kernels) - 1, {
        "name": "ssd_scan_bwd", "route": "cuda", "source": SSD_BWD_SOURCE,
        "replaces": "src/repro/kernels/ssd_scan/ops.py:44",
        "launches": sum(c["ssd_scan_bwd"] for c, _ in ssd_train.values()),
        "launches_by_path": {k: c["ssd_scan_bwd"] for k, (c, _) in ssd_train.items()},
        "launches_note": "backward calls of phase 31's training runs, three kernel launches "
                         "each (states, dchunk, group_sum); 0 in phases 1-30",
        "path": "ffma", "dtype": "bfloat16",
        "max_abs_err": ssd_bwd_errs["bfloat16"]["max_abs_err"], "max_err_by_dtype": ssd_bwd_errs,
        **{k: ssd_bwd_row[k] for k in bwd_keys},
        **{k: ssd_bwd_row[k] for k in ("f32_ms", "f32_bound_ms", "f32_bound_by")},
        f"{MAMBA_ARCH} serve shape": {k: ssd_bwd_rows["serve bf16"][k] for k in bwd_keys},
    })
    kernels[-1].update({
        "launches": (rgemma_launches["rglru_scan"]
                     + sum(c["rglru_scan"] for c, _ in lru_train.values())),
        "launches_by_path": {RGEMMA_ARCH: rgemma_launches["rglru_scan"],
                             **{k: c["rglru_scan"] for k, (c, _) in lru_train.items()}},
    })
    lru_keys = (*timing_keys, "io_mb", "tb_per_s", "shape")
    kernels.append({
        "name": "rglru_scan_bwd", "route": "cuda", "source": RGLRU_BWD_SOURCE,
        "replaces": "src/repro/kernels/rglru_scan/ops.py:23",
        "launches": sum(c["rglru_scan_bwd"] for c, _ in lru_train.values()),
        "launches_by_path": {k: c["rglru_scan_bwd"] for k, (c, _) in lru_train.items()},
        "launches_note": "backward calls of phase 32's training runs, one kernel launch each; "
                         "0 in phases 1-31",
        "dtype": "float32",
        "max_abs_err": lru_bwd_errs["float32"]["max_abs_err"], "max_err_by_dtype": lru_bwd_errs,
        **{k: lru_bwd_rows["train f32"][k] for k in lru_keys},
        f"{RGEMMA_ARCH} serve shape": {k: lru_bwd_rows["serve f32"][k] for k in lru_keys},
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
    served_by = {"flash_decode_int8": f"{SERVE_ARCH} (int8 KV cache)"}
    for k in kernels:
        k.setdefault("launches_by_path", {served_by.get(k["name"]): k["launches"]})
        k["launches_by_path"]["hierarchical tree (phase 26, script process)"] = \
            hier_launches[k["name"]]
        k["launches_by_path"].setdefault(train_key, train_launches[k["name"]])
    say(json.dumps({"kernels": kernels}))
    say(smi_line())
    assert torch.cuda.device_count() == 1, torch.cuda.device_count()
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
