"""Worlds for ``tests/test_torch_moe_sharded.py``, each run in a subprocess
of its own so that no process group (and no forced JAX device count) ever
lives in the pytest process:

    python tests/_torch_moe_ranks.py ref  DIR   # JAX, 4 forced host devices
    python tests/_torch_moe_ranks.py port DIR   # torch, 4 gloo ranks

``ref`` runs the reference's ``moe_ffn`` for every case of ``CASES`` on a
``(data, model)`` mesh of the 4 devices and pickles each device's shard of
the output and of the aux loss, with the numpy params and tokens it used.
``ref`` also takes ``jax.grad`` of ``sum(y * cot) + aux / 2`` (``cot`` a
fixed normal cotangent) with respect to the params and the tokens through
the sharded layer, and of ``sum(y * cot)`` through the sharded and the
unsharded layer.  ``port`` gives each of 4 gloo ranks the same params
(placed by ``tree_shardings`` under ``default_rules``) and tokens (split
over the batch axes) as DTensors, runs the port's ``moe_ffn`` and pickles
each rank's ``to_local()`` of both, which body ran, whether the params'
rules placed them where the body's in-specs want them, the error that a
plain tensor raises, and the gradients of the same loss through
``torch.autograd`` (each gathered whole, with its placements).  Only ``ref`` imports JAX;
every world ends with a ``barrier()`` before its process group is destroyed.
"""
import os
import pickle
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

WORLD = 4
#: the reference test's tiny layer (tests/test_system.py: d 32, E 8, top-2, f 16)
LAYER = dict(d_model=32, n_experts=8, top_k=2, d_ff_expert=16)
#: (name, (data, model), overrides, resident, seq len): every body, every
#: mesh shape, FSDP on and off, one and two token chunks, f32 and bf16
#: compute, and a capacity short enough to drop rows
CASES = (
    ("ep 2x2 fsdp f32", (2, 2), dict(moe_impl="ep", fsdp_params=True, moe_ep_capacity=8.0),
     False, 8),
    ("ep 2x2 fsdp chunks2 f32", (2, 2), dict(moe_impl="ep", fsdp_params=True,
                                             moe_token_chunks=2), False, 8),
    ("ep 2x2 chunks2 bf16", (2, 2), dict(moe_impl="ep", moe_token_chunks=2,
                                         compute_dtype="bfloat16"), False, 8),
    ("ep 1x4 fsdp f32", (1, 4), dict(moe_impl="ep", fsdp_params=True), False, 8),
    ("ep 2x2 fsdp capacity 0.5 (drops rows)", (2, 2),
     dict(moe_impl="ep", fsdp_params=True, moe_ep_capacity=0.5), False, 8),
    ("resident 2x2 fsdp f32", (2, 2), dict(moe_impl="ep", fsdp_params=True), True, 1),
    ("resident 2x2 bf16", (2, 2), dict(moe_impl="ep", compute_dtype="bfloat16"), True, 1),
    ("resident 1x4 fsdp chunks2 f32", (1, 4), dict(moe_impl="ep", fsdp_params=True,
                                                   moe_token_chunks=2), True, 1),
    ("gather 2x2 fsdp f32", (2, 2), dict(moe_impl="gather", fsdp_params=True), False, 8),
    ("gather 2x2 bf16", (2, 2), dict(moe_impl="gather", compute_dtype="bfloat16"), False, 8),
    ("ep on 4x1 takes gather, fsdp f32", (4, 1), dict(moe_impl="ep", fsdp_params=True),
     False, 8),
    ("gather 1x4 fsdp bf16", (1, 4), dict(moe_impl="gather", fsdp_params=True,
                                          compute_dtype="bfloat16"), False, 8),
)
BATCH = 4


def case_body(overrides, shape, resident):
    """The body the reference's ``moe_ffn`` picks for this case."""
    n_model = shape[1]
    if (overrides.get("moe_impl") == "ep" and n_model > 1
            and LAYER["n_experts"] % n_model == 0):
        return "ep_resident" if resident else "ep"
    return "gather"


def inputs(seed, seq):
    import numpy as np

    return np.random.default_rng(seed).normal(
        size=(BATCH, seq, LAYER["d_model"])).astype(np.float32)


def cotangent(seed, shape):
    import numpy as np

    return np.random.default_rng(100 + seed).normal(size=shape).astype(np.float32)


def run_ref(out_dir):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from repro.configs.base import LayerGroup, LayerSpec, ModelConfig
    from repro.models.moe import init_moe, moe_ffn

    assert len(jax.devices()) == WORLD, jax.devices()
    out = {}
    for i, (name, shape, overrides, resident, seq) in enumerate(CASES):
        cfg = ModelConfig(name="m", groups=(LayerGroup((LayerSpec(ffn="moe"),), 1),),
                          compute_dtype="float32", **LAYER).replace(**overrides)
        params, _ = init_moe(jax.random.PRNGKey(i), cfg)
        host = {k: np.asarray(v) for k, v in jax.device_get(params).items()}
        # routing scores that matter, and outputs of order one
        for k, scale in (("router", 50.0), ("wg", 5.0), ("wu", 5.0), ("wd", 20.0)):
            host[k] = host[k] * np.float32(scale)
        x = inputs(i, seq)
        mesh = Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))
        y, aux = jax.jit(lambda p, t, _c=cfg, _m=mesh, _r=resident: moe_ffn(
            p, t, _c, mesh=_m, resident=_r))(host, x)
        local, _ = moe_ffn(host, x, cfg)
        cot = cotangent(i, x.shape)

        def loss(p, t, m, with_aux, _c=cfg, _r=resident, _cot=cot):
            y_, aux_ = moe_ffn(p, t, _c, mesh=m, resident=_r)
            total = jnp.sum(y_.astype(jnp.float32) * _cot)
            return total + 0.5 * aux_ if with_aux else total

        grads = {}
        for key, m, with_aux in (("sharded", mesh, True), ("sharded_y", mesh, False),
                                 ("local_y", None, False)):
            g = jax.jit(jax.grad(lambda p, t, _m=m, _a=with_aux: loss(p, t, _m, _a),
                                 argnums=(0, 1)))(host, x)
            grads[key] = {**{k: np.asarray(v) for k, v in g[0].items()}, "x": np.asarray(g[1])}
        out[name] = {
            "params": host, "x": x, "local": np.asarray(local), "cot": cot, "grads": grads,
            "shards": {s.device.id: np.asarray(s.data) for s in y.addressable_shards},
            "aux": {s.device.id: float(s.data) for s in aux.addressable_shards}}
    with open(os.path.join(out_dir, "ref.pkl"), "wb") as f:
        pickle.dump(out, f)


def _init_world(rank, world, out_dir):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method="file://" + os.path.join(out_dir, "rendezvous"),
                            rank=rank, world_size=world)


def _end_world():
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def port_rank(rank, out_dir):
    from unittest import mock

    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs.base import LayerGroup, LayerSpec, ModelConfig
    from repro_torch.dist import shard_map as SM
    from repro_torch.dist import sharding as S
    from repro_torch.models import moe as MOE

    torch.set_num_threads(1)   # 4 ranks on a shared host: no oversubscribed cores
    _init_world(rank, WORLD, out_dir)
    with open(os.path.join(out_dir, "ref.pkl"), "rb") as f:
        ref = pickle.load(f)
    meshes = {}
    out = {"cases": {}, "errors": {}}
    bodies = []
    spies = {n: (lambda real, n=n: lambda *a, **kw: (bodies.append(n), real(*a, **kw))[1])(
        getattr(MOE, n)) for n in ("_moe_shard_body", "_moe_shard_body_ep",
                                   "_moe_shard_body_ep_resident")}
    names = {"_moe_shard_body": "gather", "_moe_shard_body_ep": "ep",
             "_moe_shard_body_ep_resident": "ep_resident"}
    for name, shape, overrides, resident, seq in CASES:
        cfg = ModelConfig(name="m", groups=(LayerGroup((LayerSpec(ffn="moe"),), 1),),
                          compute_dtype="float32", **LAYER).replace(**overrides)
        mesh = meshes.get(shape)
        if mesh is None:
            mesh = meshes[shape] = init_device_mesh("cpu", shape,
                                                    mesh_dim_names=("data", "model"))
        want = ref[name]
        _, axes = MOE.init_moe(torch.Generator().manual_seed(0), cfg)
        shardings = S.tree_shardings(axes, mesh, S.default_rules(cfg, mesh))
        params = {k: distribute_tensor(torch.from_numpy(v), mesh, shardings[k].placements,
                                       src_data_rank=None) for k, v in want["params"].items()}
        # the body's in-specs, as moe_ffn states them
        b_axes = ("data",)
        fsdp = b_axes if cfg.fsdp_params else ()
        if case_body(overrides, shape, resident) == "gather":
            w_spec, wd_spec = S.P(fsdp or None, None, "model"), S.P(fsdp or None, "model", None)
        else:
            w_spec, wd_spec = S.P("model", None, fsdp or None), S.P("model", fsdp or None, None)
        in_place = {k: tuple(params[k].placements) == S.spec_to_placements(sp, mesh)
                    for k, sp in (("wg", w_spec), ("wu", w_spec), ("wd", wd_spec))}
        x = distribute_tensor(torch.from_numpy(want["x"]), mesh,
                              S.spec_to_placements(S.P(b_axes, None, None), mesh),
                              src_data_rank=None)
        bodies.clear()
        before = dict(SM.COLLECTIVE_BYTES)
        with torch.no_grad(), mock.patch.multiple(MOE, **spies):
            y, aux = MOE.moe_ffn(params, x, cfg, mesh=mesh, resident=resident)
        out["cases"][name] = {
            "local": y.to_local().float().numpy(), "aux": float(aux.to_local()),
            "placements": repr(tuple(y.placements)), "global_shape": tuple(y.shape),
            "bodies": [names[b] for b in bodies], "params_in_place": in_place,
            "collective_bytes": {k: SM.COLLECTIVE_BYTES[k] - before[k] for k in before}}
        out["cases"][name]["grads"] = port_grads(torch, mesh, params, x, want["cot"], cfg,
                                                 resident)
        if name == CASES[0][0]:   # the refusal, on the 2 x 2 mesh
            try:
                MOE.moe_ffn(params, torch.from_numpy(want["x"]), cfg, mesh=mesh)
                out["errors"]["plain"] = None
            except TypeError as e:
                out["errors"]["plain"] = "TypeError: " + str(e)
    out["collectives"] = collectives(torch, rank, meshes[(2, 2)])
    with open(os.path.join(out_dir, f"port{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    _end_world()


def port_grads(torch, mesh, params, x, cot, cfg, resident):
    """Gradients of ``sum(y * cot) + aux / 2`` with respect to the params
    and the tokens, each gathered whole, and whether each kept its input's
    placements."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models import moe as MOE

    live = {k: v.detach().requires_grad_() for k, v in params.items()}
    xg = x.detach().requires_grad_()
    y, aux = MOE.moe_ffn(live, xg, cfg, mesh=mesh, resident=resident)
    c = distribute_tensor(torch.from_numpy(cot), mesh, x.placements, src_data_rank=None)
    loss = (y.float() * c).sum() + 0.5 * aux
    got = torch.autograd.grad(loss, [*live.values(), xg])
    names = [*live, "x"]
    inputs = [*live.values(), xg]
    return {"full": {k: g.full_tensor().numpy() for k, g in zip(names, got)},
            "placements_kept": {k: tuple(g.placements) == tuple(t.placements)
                                for k, g, t in zip(names, got, inputs)}}


def collectives(torch, rank, mesh):
    """``shard_map``'s collectives and in-spec moves on the 2 x 2 mesh:
    each rank contributes its rank; a tuple of axes is gathered first axis
    major; an (8, 4) arange placed (Shard(0), Shard(1)) is moved to
    P(("data", "model"), None) and to P(None, "model")."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from repro_torch.dist import shard_map as SM
    from repro_torch.dist.sharding import P

    def body(t):
        return (SM.all_gather(t, ("data", "model")), SM.all_gather(t, ("model", "data")),
                SM.all_gather(t, "model", tiled=False), SM.psum(t, ("model", "data")),
                SM.pmean(t, "model"),
                torch.tensor([SM.axis_index("data"), SM.axis_index("model"),
                              SM.axis_size("data"), SM.axis_size("model")], dtype=t.dtype))

    mine = DTensor.from_local(torch.full((1,), float(rank)), mesh, (Replicate(), Replicate()),
                              run_check=False)
    got = SM.shard_map(body, mesh, in_specs=(P(),), out_specs=P())(mine)
    full = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    placed = distribute_tensor(full, mesh, (Shard(0), Shard(1)), src_data_rank=None)
    moved = [SM.shard_map(lambda t: t * 1, mesh, in_specs=(spec,), out_specs=spec)(placed)
             for spec in (P(("data", "model"), None), P(None, "model"))]
    return {"gathers": [g.to_local().tolist() for g in got],
            "moved": [m.to_local().tolist() for m in moved]}


def run_port(out_dir):
    import torch.multiprocessing as mp

    mp.spawn(port_rank, args=(out_dir,), nprocs=WORLD, join=True)


if __name__ == "__main__":
    mode, directory = sys.argv[1], sys.argv[2]
    {"ref": run_ref, "port": run_port}[mode](directory)
