"""Where phase 34 (d)'s narrowest gradient leaf gets its gap (on the card).

``chip_smoke.py`` phase 34 (d) holds one train step's cross-entropy
gradient of olmoe-1b-7b (2 layers, EP + FSDP, flash, remat full) on
DTensors over a 2 x 2 ``(data, model)`` mesh of 4 ranks sharing the card
against the same step unsharded, with the sharded run's top-k choices
forced, in bf16 compute, every leaf within 2e-2 relative.  This runs the
same step (``chip_smoke.ranks_olmoe_train``) in f32 compute and in bf16 on
4 ranks forked as phase 34 forks them, and prints every gradient leaf's
relative gap at each of the stacked layers, the worst first, with the
cross-entropy's: an f32 gap at f32's rounding says the sharded step is the
unsharded one and the bf16 gap is bf16's rounding; a gap that enters at
one leaf or one layer says where to look.

    PYTHONPATH=src python tools/torch_ranks_margin.py [cpu]

``cpu`` is the dry run: the reduced config on 4 plain gloo ranks of the
CPU.  The last line of its output is one JSON object with every reading.
"""
from __future__ import annotations

import json
import os
import pickle
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = ("float32", "bfloat16")


def rank_main(rank, directory, device):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.dist import staged_gloo
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.grouped_matmul import ops
    from repro_torch.launch.mesh import init_world

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = device == "cuda"
    init_world(rank, cs.RANKS_WORLD, "file://" + os.path.join(directory, "rendezvous"), device,
               ranks_per_device=cs.RANKS_WORLD if cuda else 1)
    if cuda:
        ops.library()
        fa_ops.library()
    mesh = init_device_mesh(device, cs.RANKS_MOE_MESH, mesh_dim_names=("data", "model"))
    counters = (fa_ops, ops, staged_gloo)
    out = {}
    for dtype in DTYPES:
        t0 = time.perf_counter()
        out[dtype] = cs.ranks_olmoe_train(torch, rank, device, mesh, counters,
                                          compute_dtype=dtype, by_layer=True)
        out[dtype]["seconds"] = time.perf_counter() - t0
        if cuda:
            cs.free_card(torch)
    with open(os.path.join(directory, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    import torch

    device = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("torch_ranks_margin: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.grouped_matmul import ops

    smi = cs.smi_line() if device == "cuda" else "cpu"
    print(f"card: {smi}", flush=True)
    if device == "cuda":   # built once here; the ranks load them
        ops.library()
        fa_ops.library()
    ctx = cs.preloaded_context()
    with tempfile.TemporaryDirectory() as directory:
        procs = [ctx.Process(target=rank_main, args=(r, directory, device))
                 for r in range(cs.RANKS_WORLD)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout=cs.RANKS_TIMEOUT)
        finally:
            cs.stop_all(procs)
        if any(p.exitcode != 0 for p in procs):
            print(f"torch_ranks_margin: ranks exited {[p.exitcode for p in procs]}",
                  file=sys.stderr)
            return 1
        ranks = []
        for r in range(cs.RANKS_WORLD):
            with open(os.path.join(directory, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    out = {"card": smi}
    for dtype in DTYPES:
        rows = [r[dtype] for r in ranks]
        leaves = sorted(cs.rel_of_sums([r["grads sums"] for r in rows]).items(),
                        key=lambda kv: -kv[1])
        ce = abs(rows[0]["ce"] - rows[0]["unsharded_ce"]) / abs(rows[0]["unsharded_ce"])
        out[dtype] = {"ce": ce, "leaves": leaves,
                      "seconds": [r["seconds"] for r in rows]}
        print(f"{dtype}: cross-entropy {rows[0]['ce']:.6f} against unsharded "
              f"{rows[0]['unsharded_ce']:.6f} (relative {ce:.3e}); seconds a rank "
              f"{['%.1f' % r['seconds'] for r in rows]}", flush=True)
        for path, gap in leaves:
            print(f"  {dtype} {path} {gap:.4e}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
