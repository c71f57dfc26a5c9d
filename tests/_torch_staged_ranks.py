"""A 2-rank world on the ``staged_gloo`` backend, in a subprocess of its
own, for ``tests/test_torch_staged_gloo.py``:

    python tests/_torch_staged_ranks.py DIR

Each rank issues every collective the backend implements, directly and
through DTensor's redistributions, on CPU tensors (staged like CUDA ones:
copied to a host buffer, run by gloo, copied back), and pickles the
results and the bytes it staged.
"""
import os
import pickle
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

WORLD = 2


def rank_main(rank, out_dir):
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.dist import staged_gloo

    staged_gloo.register()
    dist.init_process_group(staged_gloo.NAME, rank=rank, world_size=WORLD,
                            init_method="file://" + os.path.join(out_dir, "rendezvous"))
    x = torch.arange(4.0) + 10 * rank
    out = {"backend": dist.get_backend()}
    y = x.clone()
    dist.all_reduce(y)
    out["all_reduce"] = y.tolist()
    out["functional all_gather"] = fc.wait_tensor(
        fc.all_gather_tensor(x, 0, dist.group.WORLD)).tolist()
    out["functional reduce_scatter"] = fc.wait_tensor(
        fc.reduce_scatter_tensor(x, "sum", 0, dist.group.WORLD)).tolist()
    a2a = torch.empty(4)
    dist.all_to_all_single(a2a, x)
    out["all_to_all"] = a2a.tolist()
    b = x.clone()
    dist.broadcast(b, src=1)
    out["broadcast"] = b.tolist()
    mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("a",))
    out["shard to replicate"] = DTensor.from_local(x, mesh, (Shard(0),)).redistribute(
        mesh, (Replicate(),)).to_local().tolist()
    out["partial to replicate"] = DTensor.from_local(x, mesh, (Partial(),)).redistribute(
        mesh, (Replicate(),)).to_local().tolist()
    out["staged"] = dict(staged_gloo.STAGED_BYTES)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    import torch.multiprocessing as mp

    mp.spawn(rank_main, args=(sys.argv[1],), nprocs=WORLD, join=True)
