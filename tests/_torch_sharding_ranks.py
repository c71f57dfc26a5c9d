"""Worlds for ``tests/test_torch_sharding_multirank.py``, each run in a
subprocess of its own so that no process group (and no forced JAX device
count) ever lives in the pytest process:

    python tests/_torch_sharding_ranks.py ref  DIR   # JAX, 4 forced host devices
    python tests/_torch_sharding_ranks.py port DIR   # torch, 4 gloo ranks
    python tests/_torch_sharding_ranks.py fake DIR   # torch, a fake world of 256
    python tests/_torch_sharding_ranks.py host DIR   # torch, a gloo world of 1

``ref`` places the tiny dense and MoE configs' params (``fsdp_params=True``,
so both mesh axes shard) with the reference's ``tree_shardings`` on a 2 × 2
``("data", "model")`` mesh, constrains four activations (one of them a dim
split over both mesh axes) under its
``logical_sharding``, and pickles every device's shard.  ``port`` gives
each of 4 gloo ranks the same params and activations and pickles its
``to_local()`` shards; ``fake`` pickles rank 0's local shapes of
qwen1.5-0.5b's and kimi-k2's params (on ``meta``) on
``make_production_mesh()``; ``host`` runs each family's tiny config inside
and outside a 1 × 1 context.  Only ``ref`` imports JAX; every world ends
with a ``barrier()`` before its process group is destroyed.
"""
import os
import pickle
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: (name, arch): the tiny configs whose params both packages place
ARCHS = (("dense", "qwen1.5-0.5b"), ("moe", "olmoe-1b-7b"))
#: (name, shape, logical axes, the tiny qwen config's overrides, the rules'
#: input shape (name, seq_len, global_batch, kind) or None, the DTensor's
#: placements before the constraint: "replicate", or "shard" = Shard(1) on
#: "model").  The cache of one sequence at decode splits its seq dim over
#: both mesh axes: cache_seq is ("data", "model") there
ACTIVATIONS = (
    ("residual", (4, 8, 64), ("act_batch", "act_seq", None), {"act_seq_shard": True}, None,
     "replicate"),
    ("decode residual (seq 1)", (4, 1, 64), ("act_batch", "act_seq", None),
     {"act_seq_shard": True}, None, "replicate"),
    ("logits", (4, 8, 256), ("act_batch", None, "vocab"), {}, None, "shard"),
    ("decode cache (batch 1, seq over data and model)", (1, 8, 4, 16),
     ("act_batch", "cache_seq", "kvheads", "head"), {"decode_cache_seq_shard": True},
     ("tiny_decode", 8, 1, "decode"), "replicate"),
)
#: the families of the wiring check: (family, arch)
FAMILIES = (("dense", "qwen1.5-0.5b"), ("moe", "olmoe-1b-7b"), ("ssm", "mamba2-1.3b"),
            ("hybrid", "recurrentgemma-9b"), ("vlm", "internvl2-26b"),
            ("whisper", "whisper-base"))
WORLD = 4


def _path(keypath):
    """A JAX key path as the port's tree paths render it (``a/b/[0]``)."""
    parts = []
    for k in keypath:
        parts.append(f"[{k.idx}]" if hasattr(k, "idx") else str(k.key))
    return "/".join(parts)


def _host(a):
    """(array, dtype name): bf16 widened to f32, exactly."""
    import numpy as np

    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.astype(np.float32), "bfloat16"
    return a, a.dtype.name


def activation(shape, seed):
    import numpy as np

    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def run_ref(out_dir):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from repro.configs.base import InputShape
    from repro.configs.registry import get_config
    from repro.dist.sharding import (default_rules, logical_sharding, tree_shardings,
                                     with_logical_constraint)
    from repro.models.registry import model_fns

    assert len(jax.devices()) == WORLD, jax.devices()
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    out = {"params": {}, "activations": {}}
    for name, arch in ARCHS:
        cfg = get_config(arch, reduced=True).replace(fsdp_params=True)
        rules = default_rules(cfg, mesh)
        params, axes = model_fns(cfg).init(jax.random.PRNGKey(0))
        placed = jax.device_put(params, tree_shardings(axes, mesh, rules))
        leaves = {}
        for keypath, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
            shards = {s.device.id: _host(s.data)[0] for s in leaf.addressable_shards}
            full, dtype = _host(jax.device_get(leaf))
            leaves[_path(keypath)] = {"full": full, "dtype": dtype, "shards": shards,
                                      "spec": tuple(leaf.sharding.spec)}
        out["params"][name] = leaves
    cfg = get_config("qwen1.5-0.5b", reduced=True).replace(fsdp_params=True)
    for i, (name, shape, axes, overrides, input_shape, _) in enumerate(ACTIVATIONS):
        rules = default_rules(cfg.replace(**overrides), mesh,
                              input_shape and InputShape(*input_shape))
        x = activation(shape, i)
        with mesh, logical_sharding(mesh, rules):
            y = jax.jit(lambda t, _axes=axes: with_logical_constraint(t, *_axes))(x)
        out["activations"][name] = {
            "x": x, "spec": tuple(y.sharding.spec),
            "shards": {s.device.id: np.asarray(s.data) for s in y.addressable_shards}}
    with open(os.path.join(out_dir, "ref.pkl"), "wb") as f:
        pickle.dump(out, f)


def _init_world(rank, world, out_dir, backend="gloo"):
    import torch.distributed as dist

    dist.init_process_group(backend, init_method="file://" + os.path.join(out_dir, "rendezvous"),
                            rank=rank, world_size=world)


def _end_world():
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def port_rank(rank, out_dir):
    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.dist import sharding as S
    from repro_torch.models.registry import model_fns, shapes_and_axes
    from repro_torch.tree import tree_flatten_with_path

    _init_world(rank, WORLD, out_dir)
    with open(os.path.join(out_dir, "ref.pkl"), "rb") as f:
        ref = pickle.load(f)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {"params": {}, "activations": {}, "errors": []}
    for name, arch in ARCHS:
        cfg = get_config(arch, reduced=True).replace(fsdp_params=True)
        rules = S.default_rules(cfg, mesh)
        shapes, axes = shapes_and_axes(model_fns(cfg).init, torch.Generator().manual_seed(0))
        shardings = dict(tree_flatten_with_path(S.tree_shardings(axes, mesh, rules)))
        leaves = {}
        for path, meta in tree_flatten_with_path(shapes):
            want = ref["params"][name][path]
            full = torch.from_numpy(want["full"]).to(getattr(torch, want["dtype"]))
            assert full.shape == meta.shape and full.dtype == meta.dtype, path
            sh = shardings[path]
            d = distribute_tensor(full, mesh, sh.placements)
            local = d.to_local()
            leaves[path] = {"local": local.float().numpy() if local.dtype == torch.bfloat16
                            else local.numpy(), "spec": tuple(sh.spec),
                            "placements": repr(sh.placements)}
        out["params"][name] = leaves
    cfg = get_config("qwen1.5-0.5b", reduced=True).replace(fsdp_params=True)
    for name, shape, axes, overrides, input_shape, start in ACTIVATIONS:
        rules = S.default_rules(cfg.replace(**overrides), mesh,
                                input_shape and InputShape(*input_shape))
        x = torch.from_numpy(ref["activations"][name]["x"])
        placements = ((Replicate(), Replicate()) if start == "replicate"
                      else (Replicate(), Shard(1)))
        d = distribute_tensor(x, mesh, placements)
        before = S.CALLS["with_logical_constraint"]
        with S.logical_sharding(mesh, rules):
            y = S.with_logical_constraint(d, *axes)
            try:
                S.with_logical_constraint(x, *axes)
                out["errors"].append(f"{name}: a plain tensor passed on the 2x2 mesh")
            except TypeError:
                pass
        assert S.CALLS["with_logical_constraint"] == before + 2
        out["activations"][name] = {"local": y.to_local().numpy(),
                                    "spec": tuple(S.spec_for(axes, rules)),
                                    "placements": repr(tuple(y.placements)),
                                    "full_equal": bool(torch.equal(y.full_tensor(), x))}
    with open(os.path.join(out_dir, f"port{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    _end_world()


def run_port(out_dir):
    import torch.multiprocessing as mp

    mp.spawn(port_rank, args=(out_dir,), nprocs=WORLD, join=True)


def run_fake(out_dir):
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs.registry import get_config
    from repro_torch.dist import sharding as S
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.registry import model_fns, shapes_and_axes
    from repro_torch.tree import tree_flatten_with_path

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
    mesh = make_production_mesh(device_type="cpu")
    out = {"mesh": (tuple(mesh.mesh_dim_names), tuple(mesh.shape)), "archs": {}}
    for arch in ("qwen1.5-0.5b", "kimi-k2-1t-a32b"):
        cfg = get_config(arch)
        rules = S.default_rules(cfg, mesh)
        shapes, axes = shapes_and_axes(model_fns(cfg).init, torch.Generator())
        shardings = dict(tree_flatten_with_path(S.tree_shardings(axes, mesh, rules)))
        local = {}
        for path, t in tree_flatten_with_path(shapes):
            d = distribute_tensor(t, mesh, shardings[path].placements, src_data_rank=None)
            local[path] = (tuple(t.shape), tuple(d.to_local().shape), d.to_local().device.type)
        out["archs"][arch] = local
    with open(os.path.join(out_dir, "fake.pkl"), "wb") as f:
        pickle.dump(out, f)
    _end_world()


def _family_inputs(torch, cfg, b, s):
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen),
             "cache_len": s + cfg.n_vision_tokens + 3}
    if cfg.is_encdec:
        batch["frames"] = torch.randn((b, s, cfg.d_model), generator=gen)
    if cfg.n_vision_tokens:
        batch["patch_embeds"] = torch.randn((b, cfg.n_vision_tokens, cfg.d_model),
                                            generator=gen)
    return batch


def _serve_family(torch, fns, cfg, params, batch, steps, rules=None, mesh=None):
    """Prefill and ``steps`` greedy decode steps; under ``rules`` each call
    runs inside ``logical_sharding(mesh, rules[kind])``."""
    import contextlib

    from repro_torch.dist import sharding as S

    def ctx(kind):
        return S.logical_sharding(mesh, rules[kind]) if rules else contextlib.nullcontext()

    with torch.no_grad():
        with ctx("prefill"):
            logits, cache = fns.prefill(params, batch)
        out = [logits]
        pos = batch["tokens"].shape[1] + cfg.n_vision_tokens
        for i in range(steps):
            with ctx("decode"):
                logits, cache = fns.decode(params, cache,
                                           {"token": torch.argmax(logits, -1), "pos": pos + i})
            out.append(logits)
    return out, cache


def run_host(out_dir):
    from unittest import mock

    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.dist import sharding as S
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as MOE
    from repro_torch.models.registry import model_fns
    from repro_torch.tree import tree_leaves

    mesh = make_host_mesh("cpu")
    b, s, steps = 2, 8, 3
    shapes = {"prefill": InputShape("host_prefill", s, b, "prefill"),
              "decode": InputShape("host_decode", s + steps, b, "decode")}
    out = {"mesh": (tuple(mesh.mesh_dim_names), tuple(mesh.shape),
                    torch.distributed.get_backend())}
    for family, arch in FAMILIES:
        cfg = get_config(arch, reduced=True)
        fns = model_fns(cfg)
        params, _ = fns.init(torch.Generator().manual_seed(0), "cpu")
        batch = _family_inputs(torch, cfg, b, s)
        rules = {k: S.default_rules(cfg, mesh, shape) for k, shape in shapes.items()}
        meshes, real = [], MOE.moe_ffn

        def spy(*a, **kw):
            meshes.append(kw.get("mesh"))
            return real(*a, **kw)

        with mock.patch.object(MOE, "moe_ffn", spy):
            c0 = S.CALLS["with_logical_constraint"]
            plain = _serve_family(torch, fns, cfg, params, batch, steps)
            c1 = S.CALLS["with_logical_constraint"]
            ruled = _serve_family(torch, fns, cfg, params, batch, steps, rules, mesh)
            c2 = S.CALLS["with_logical_constraint"]
        n_moe = len(meshes) // 2
        out[family] = {
            "logits_equal": all(torch.equal(a, b) for a, b in zip(plain[0], ruled[0])),
            "cache_equal": all(torch.equal(a, b) for a, b in
                               zip(tree_leaves(plain[1]), tree_leaves(ruled[1]))),
            "cache_leaves": len(tree_leaves(plain[1])),
            "calls": (c1 - c0, c2 - c1),
            "moe_meshes": (meshes[:n_moe] == [None] * n_moe,
                           all(m is mesh for m in meshes[n_moe:]), n_moe),
        }
    with open(os.path.join(out_dir, "host.pkl"), "wb") as f:
        pickle.dump(out, f)
    _end_world()


if __name__ == "__main__":
    mode, directory = sys.argv[1], sys.argv[2]
    {"ref": run_ref, "port": run_port, "fake": run_fake, "host": run_host}[mode](directory)
