"""Worlds for ``tests/test_torch_sharded_serve.py``, each run in a
subprocess of its own so that no process group (and no forced JAX device
count) ever lives in the pytest process:

    python tests/_torch_serve_ranks.py ref  DIR   # JAX, 4 forced host devices
    python tests/_torch_serve_ranks.py port DIR   # torch, 4 gloo ranks

``ref`` first pickles every case's numpy params (the reference's init,
randomized further), prompt and decode tokens (``inputs.pkl``); ``port``
starts on them while ``ref`` compiles.  ``ref`` then serves each case as
the reference's dry run places a serve cell
(``src/repro/launch/dryrun.py``): on a ``(data, model)`` mesh of the 4
devices, the params placed by ``tree_shardings`` and the prompt by the
batch rule, a ``jax.jit`` prefill into a cache of
``decode_cache_len(SEQ)`` slots under the ``prefill`` shape's rules; the
cache ``jax.device_put`` onto ``tree_shardings`` of ``make_cache``'s axes
under the ``decode`` shape's ``default_rules``; then ``STEPS`` steps of
``jax.jit(make_serve_step(cfg), in_shardings=(params_sh, cache_sh,
batch_sh), out_shardings=(None, cache_sh), donate_argnums=(1,))``.  It
pickles every device's shard of the logits and of every cache leaf after
the prefill and after each step: the first ``SEQ + STEPS`` slots (the
written ones) and the largest magnitude past them.

A bf16 MoE case (``_torch_train_ranks.routed``) takes the reference's
top-k choices on the port, one table a program (the prefill and each
step), recorded with ``_torch_train_ranks.recorded_routes``.

``port`` gives each of 4 gloo ranks the same numpy params and tokens,
places them with ``sharding.distribute`` under the same rules, runs the
port's prefill, moves its cache onto the decode placements with
``sharding.distribute`` and runs ``make_serve_step`` on DTensors; it
pickles each rank's ``to_local()`` of the same trees, whether every cache
leaf kept its storage and placements, and the largest tensor a decode
step handed a collective.  Rank 0 also runs the steps unsharded.  A
control step runs from the placed cache with rank 1's local ``k`` replaced
by rank 0's.  ``port`` also records the in-place write's checks on one
rank's shards (``write_checks``) and a decode batch that does not fill
"data" (``REFUSED``).  Only ``ref`` imports JAX; every world ends with a
``barrier()`` before its process group is destroyed.
"""
import contextlib
import os
import pickle
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))

from _torch_train_ranks import (  # noqa: E402
    WORLD, _end_world, _init_world, _path, _wait_for, forced_routes, recorded_routes, routed,
    routing_table)

BATCH, SEQ = 8, 16
STEPS = 3
#: the written slots: the prompt's and one a step
KEPT = SEQ + STEPS
#: (name, arch, (data, model), overrides): the three meshes, the chunked and
#: the flash route, an int8 KV cache, the EP body resident and not and the
#: gather body, f32 and bf16
CASES = (
    ("qwen 2x2 chunked f32", "qwen1.5-0.5b", (2, 2), {}),
    ("qwen 1x4 pallas bf16", "qwen1.5-0.5b", (1, 4),
     dict(attn_impl="pallas", compute_dtype="bfloat16")),
    ("qwen 4x1 chunked fsdp f32", "qwen1.5-0.5b", (4, 1), dict(fsdp_params=True)),
    ("qwen 2x2 int8 cache f32", "qwen1.5-0.5b", (2, 2), dict(kv_cache_quant=True)),
    ("olmoe 2x2 ep resident pallas fsdp f32", "olmoe-1b-7b", (2, 2),
     dict(attn_impl="pallas", fsdp_params=True)),
    ("olmoe 1x4 ep not resident f32", "olmoe-1b-7b", (1, 4), dict(moe_resident_serve=False)),
    ("olmoe 1x4 gather bf16", "olmoe-1b-7b", (1, 4),
     dict(moe_impl="gather", compute_dtype="bfloat16")),
)
#: a decode batch that does not fill "data": its rules shard the cache's
#: sequence over "data", and the port's step refuses it
REFUSED = ("qwen 4x1 batch 2", "qwen1.5-0.5b", (4, 1), 2)


def cell(batch, kind):
    """The ``InputShape`` of a ``kind`` ("prefill" or "decode") cell of
    ``batch`` x SEQ."""
    from repro_torch.configs.base import InputShape

    return InputShape(kind, SEQ, batch, kind)


def decode_tokens(np, cfg, i):
    """Case ``i``'s prompt (BATCH, SEQ) and one token a step (STEPS, BATCH)."""
    rng = np.random.default_rng(200 + i)
    return (rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (STEPS, BATCH)).astype(np.int32))


def _kept(np, a):
    """(the first KEPT slots, the largest magnitude past them) of a cache
    shard (layers, batch, slots, ...), or a logits shard as it is."""
    a = np.asarray(a, dtype=np.float32)
    if a.ndim < 4:
        return a
    rest = a[:, :, KEPT:]
    return a[:, :, :KEPT].copy(), float(np.abs(rest).max()) if rest.size else 0.0


def run_ref(out_dir):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding

    import repro.models.moe as rmoe
    from repro.configs.base import InputShape
    from repro.configs.registry import get_config
    from repro.dist.sharding import default_rules, logical_sharding, spec_for, tree_shardings
    from repro.models.registry import decode_cache_len, make_serve_step, model_fns
    from repro.models.registry import shapes_and_axes

    assert len(jax.devices()) == WORLD, jax.devices()

    def shards(tree):
        out = {}
        for keypath, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[_path(keypath)] = {s.device.id: _kept(np, s.data) for s in leaf.addressable_shards}
        return out

    inputs = {}
    for i, (name, arch, _, overrides) in enumerate(CASES):
        cfg = get_config(arch, reduced=True).replace(**overrides)
        rng = np.random.default_rng(i)
        params, axes = model_fns(cfg).init(jax.random.PRNGKey(0))
        host = jax.tree.map(lambda a: np.asarray(a) + rng.normal(
            scale=0.02, size=a.shape).astype(np.asarray(a).dtype), params)
        prompt, steps = decode_tokens(np, cfg, i)
        inputs[name] = {"host": host, "axes": axes, "tokens": prompt, "steps": steps}
    with open(os.path.join(out_dir, "inputs.tmp"), "wb") as f:
        pickle.dump({k: {n: v[n] for n in ("host", "tokens", "steps")} for k, v in inputs.items()},
                    f)
    os.replace(os.path.join(out_dir, "inputs.tmp"), os.path.join(out_dir, "inputs.pkl"))

    out, routing = {}, {}
    n_slots = decode_cache_len(SEQ)
    for case in sorted(CASES, key=lambda c: not routed(c)):   # the routed first
        name, arch, mesh_shape, overrides = case
        t0 = time.time()
        cfg = get_config(arch, reduced=True).replace(**overrides)
        fns = model_fns(cfg)
        mesh = Mesh(np.array(jax.devices()).reshape(mesh_shape), ("data", "model"))
        host, axes, tokens, steps = (inputs[name][k] for k in ("host", "axes", "tokens", "steps"))
        calls, tables, rec = [], {}, {}

        def recording():
            return (recorded_routes(jax, np, rmoe, calls) if routed(case)
                    else contextlib.nullcontext())

        def keep(program):
            jax.effects_barrier()
            if routed(case):
                tables[program] = routing_table(np, calls)
                calls.clear()

        rules = default_rules(cfg, mesh, InputShape("prefill", SEQ, BATCH, "prefill"))
        with mesh, logical_sharding(mesh, rules):
            params_sh = tree_shardings(axes, mesh, rules)
            batch_sh = tree_shardings({"tokens": ("act_batch", None)}, mesh, rules)
            p = jax.device_put(host, params_sh)
            b = jax.device_put({"tokens": tokens}, batch_sh)
            with recording():
                logits, cache = jax.jit(
                    lambda p_, b_: fns.prefill(p_, dict(b_, cache_len=n_slots)),
                    in_shardings=(params_sh, batch_sh))(p, b)
                keep("prefill")
        rules = default_rules(cfg, mesh, InputShape("decode", SEQ, BATCH, "decode"))
        with mesh, logical_sharding(mesh, rules):
            params_sh = tree_shardings(axes, mesh, rules)
            _, cache_axes = shapes_and_axes(lambda: fns.make_cache(BATCH, n_slots))
            cache_sh = tree_shardings(cache_axes, mesh, rules)
            step_sh = {"token": NamedSharding(mesh, spec_for(("act_batch",), rules)),
                       "pos": NamedSharding(mesh, spec_for((), rules))}
            cache = jax.device_put(cache, cache_sh)
            rec["prefill"] = {"logits": shards(logits), "cache": shards(cache)}
            step = jax.jit(make_serve_step(cfg), in_shardings=(params_sh, cache_sh, step_sh),
                           out_shardings=(None, cache_sh), donate_argnums=(1,))
            with recording():
                for i in range(STEPS):
                    batch = jax.device_put({"token": steps[i], "pos": np.int32(SEQ + i)}, step_sh)
                    logits, cache = step(p, cache, batch)
                    keep(f"step {i}")
                    rec[f"step {i}"] = {"logits": shards(logits), "cache": shards(cache)}
        out[name] = {"programs": rec, "seconds": time.time() - t0}
        if routed(case):
            routing[name] = out[name]["routing"] = tables
            with open(os.path.join(out_dir, "routing.tmp"), "wb") as f:
                pickle.dump(routing, f)
            os.replace(os.path.join(out_dir, "routing.tmp"), os.path.join(out_dir, "routing.pkl"))
    with open(os.path.join(out_dir, "ref.pkl"), "wb") as f:
        pickle.dump(out, f)


def collective_sizes():
    """A dispatch mode that counts the collectives issued inside it (the
    mesh bodies' ``c10d`` ops and DTensor's functional ones) in ``calls``
    and keeps the largest tensor any of them was handed, in bytes, in
    ``largest``."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class CollectiveSizes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls, self.largest = 0, 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func.namespace in ("c10d", "_c10d_functional", "c10d_functional"):
                self.calls += 1
                for t in tree_leaves((args, kwargs)):
                    if isinstance(t, torch.Tensor):
                        self.largest = max(self.largest, t.numel() * t.element_size())
            return func(*args, **kwargs)

    return CollectiveSizes()


def _local_kept(np, t):
    return _kept(np, t.to_local().float().numpy())


def _locals_kept(np, tree):
    from repro_torch.tree import tree_flatten_with_path

    return {k: _local_kept(np, v) for k, v in tree_flatten_with_path(tree)}


def port_case(torch, rank, mesh, case, want, routing=None):
    import numpy as np
    import torch.distributed as dist

    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs.registry import get_config
    from repro_torch.dist import sharding as S
    from repro_torch.models import moe
    from repro_torch.models.registry import decode_cache_len, make_serve_step, model_fns
    from repro_torch.models.registry import shapes_and_axes
    from repro_torch.tree import tree_flatten_with_path, tree_leaves

    name, arch, _, overrides = case

    def routes(program):   # the reference's choices, where the case is routed
        if routing is None:
            return contextlib.nullcontext()
        return forced_routes(torch, moe, routing[program])

    t0 = time.time()
    cfg = get_config(arch, reduced=True).replace(**overrides)
    fns = model_fns(cfg)
    step = make_serve_step(cfg)
    n_slots = decode_cache_len(SEQ)
    _, axes = shapes_and_axes(fns.init, torch.Generator().manual_seed(0))
    _, cache_axes = shapes_and_axes(fns.make_cache, BATCH, n_slots)
    host = params_from_numpy(want["host"], "cpu")
    tokens = torch.from_numpy(want["tokens"])
    steps = torch.from_numpy(want["steps"])
    rec, out = {}, {}
    with torch.no_grad():
        rules = S.default_rules(cfg, mesh, cell(BATCH, "prefill"))
        with S.logical_sharding(mesh, rules):
            p = S.distribute(host, S.tree_shardings(axes, mesh, rules))
            b = S.distribute({"tokens": tokens}, S.batch_shardings({"tokens": tokens}, mesh, rules))
            with routes("prefill"):
                logits, cache = fns.prefill(p, dict(b, cache_len=n_slots))
        rules = S.default_rules(cfg, mesh, cell(BATCH, "decode"))
        with S.logical_sharding(mesh, rules):
            cache = S.distribute(cache, S.tree_shardings(cache_axes, mesh, rules))
            rec["prefill"] = {"logits": logits.to_local().float().numpy(),
                              "cache": _locals_kept(np, cache)}
            leaves = tree_leaves(cache)
            storage = [(t.to_local().data_ptr(), tuple(t.placements)) for t in leaves]
            # the control's cache: this one's copy, rank 1's k shards rank 0's
            ctl = {path: t.to_local().clone() for path, t in tree_flatten_with_path(cache)}
            for path, local in ctl.items():
                if path.endswith("/k"):
                    zero = local.clone()
                    dist.broadcast(zero, src=0)
                    if rank == 1:
                        local.copy_(zero)
            ctl = _rebuilt(cache, ctl)
            sizes = []
            for i in range(STEPS):
                batch = {"token": steps[i], "pos": torch.tensor(SEQ + i, dtype=torch.int32)}
                batch = S.distribute(batch, S.batch_shardings(batch, mesh, rules))
                mode = collective_sizes()
                with routes(f"step {i}"), mode:
                    logits, new_cache = step(p, cache, batch)
                sizes.append((mode.calls, mode.largest))
                assert all(a is c for a, c in zip(tree_leaves(new_cache), leaves))
                rec[f"step {i}"] = {"logits": logits.to_local().float().numpy(),
                                    "cache": _locals_kept(np, cache)}
                if i == 0:
                    with routes("step 0"):
                        ctl_logits, _ = step(p, ctl, batch)
            out["control"] = {"logits": ctl_logits.to_local().float().numpy(),
                              "cache": _locals_kept(np, ctl)}
            out["storage_kept"] = [(t.to_local().data_ptr(), tuple(t.placements))
                                   for t in leaves] == storage
            out["placements"] = [str(s[1]) for s in storage]
            out["collectives_a_step"] = sizes
            k = tree_leaves(cache)[0]   # a layer's local k shard
            out["k_layer_local_bytes"] = k.to_local()[0].numel() * k.to_local().element_size()
            full = {"logits": logits.full_tensor().float().numpy(),
                    "cache": {k: v.full_tensor().float().numpy()
                              for k, v in tree_flatten_with_path(cache)}}
    out["programs"] = rec
    if rank == 0:   # the same steps unsharded, in this one process
        with torch.no_grad():
            with routes("prefill"):
                _, u_cache = fns.prefill(host, {"tokens": tokens, "cache_len": n_slots})
            for i in range(STEPS):
                with routes(f"step {i}"):
                    u_logits, u_cache = step(host, u_cache, {"token": steps[i],
                                                             "pos": torch.tensor(SEQ + i)})
        out["unsharded"] = {
            "logits": u_logits.float().numpy(),
            "cache": {k: v.float().numpy() for k, v in tree_flatten_with_path(u_cache)},
            "sharded": full}
    out["seconds"] = time.time() - t0
    return out


def _rebuilt(tree, locals_by_path):
    """``tree``'s DTensors rebuilt over the local tensors ``locals_by_path``
    (its paths), under the same mesh and placements."""
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import tree_flatten_with_path, tree_unflatten

    leaves = [DTensor.from_local(locals_by_path[k], v.device_mesh, v.placements,
                                 run_check=False)
              for k, v in tree_flatten_with_path(tree)]
    return tree_unflatten(tree, leaves)


def write_checks(torch, mesh):
    """``update_cache`` on DTensor caches placed (batch over "data", KV
    heads over "model"), as a decode step's rules place them, plain and
    int8: the collectives the write issues, whether each leaf keeps its
    local storage and placements, whether the slot holds the new values
    (gathered), and a write through ``lm._layer``'s view of a stacked
    cache reaching the stack; what the decode attention raises on k and v
    it cannot attend in place; and what ``int`` of a replicated DTensor
    position issues."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import layers as L
    from repro_torch.models.lm import _layer

    gen = torch.Generator().manual_seed(7)
    b, s, hk, d, slot = 4, 8, 4, 8, 5
    out = {}
    for quantized in (False, True):
        full = L.make_kv_cache(b, s, hk, d, torch.float32, quantized=quantized)
        for t in full.values():
            t.copy_(torch.randint(-50, 50, t.shape, generator=gen).to(t.dtype))
        k_new, v_new = (torch.randn((b, 1, hk, d), generator=gen) for _ in range(2))
        want = {k: v.clone() for k, v in full.items()}
        L.update_cache(want, k_new, v_new, slot, ring=False)
        # a stacked cache of 2 layers: layer 1 is written through _layer's view
        stacked = {k: torch.stack([torch.zeros_like(v), v]) for k, v in full.items()}
        for how, new_placements in (("alike", [Shard(0), Shard(2)]),
                                    ("replicated", [Replicate(), Replicate()])):
            cache = {k: distribute_tensor(v.clone(), mesh, [Shard(0), Shard(2)],
                                          src_data_rank=None) for k, v in full.items()}
            ptrs = {k: (v.to_local().data_ptr(), tuple(v.placements)) for k, v in cache.items()}
            kn, vn = (distribute_tensor(t, mesh, new_placements, src_data_rank=None)
                      for t in (k_new, v_new))
            mode = collective_sizes()
            with mode:
                L.update_cache(cache, kn, vn, slot, ring=False)
            key = f"{'int8' if quantized else 'plain'}, new placed {how}"
            out[key] = {
                "collectives": mode.calls,
                "storage_kept": all((v.to_local().data_ptr(), tuple(v.placements)) == ptrs[k]
                                    for k, v in cache.items()),
                "equal": all(torch.equal(v.full_tensor(), want[k]) for k, v in cache.items())}
        tree = {k: distribute_tensor(v, mesh, [Shard(1), Shard(3)], src_data_rank=None)
                for k, v in stacked.items()}
        ptrs = {k: v.to_local().data_ptr() for k, v in tree.items()}
        kn, vn = (distribute_tensor(t, mesh, [Shard(0), Shard(2)], src_data_rank=None)
                  for t in (k_new, v_new))
        L.update_cache(_layer(tree, 1), kn, vn, slot, ring=False)
        out[f"{'int8' if quantized else 'plain'}, through the layer view"] = {
            "storage_kept": all(v.to_local().data_ptr() == ptrs[k] for k, v in tree.items()),
            "equal": all(torch.equal(v.full_tensor()[1], want[k]) and
                         torch.equal(v.full_tensor()[0], torch.zeros_like(want[k]))
                         for k, v in tree.items())}
    # the decode attention on DTensors: a cache split on its slots or its
    # head dim, or k and v split unlike each other, is refused
    q = distribute_tensor(torch.randn((b, 1, hk, d), generator=gen), mesh, [Shard(0), Shard(2)],
                          src_data_rank=None)
    qpos = torch.full((b, 1), s - 1, dtype=torch.int32)
    kvpos = torch.arange(s, dtype=torch.int32).expand(b, s)
    for how, k_placements, v_placements in (
            ("slots", [Shard(0), Shard(1)], [Shard(0), Shard(1)]),
            ("head dim", [Shard(0), Shard(3)], [Shard(0), Shard(3)]),
            ("unlike", [Shard(0), Shard(2)], [Shard(2), Shard(0)])):
        kv = [distribute_tensor(torch.randn((b, s, hk, d), generator=gen), mesh, pl,
                                src_data_rank=None) for pl in (k_placements, v_placements)]
        try:
            L.attention_reference(q, *kv, qpos, kvpos)
            out[f"attention, k and v split on the {how}"] = None
        except NotImplementedError as e:
            out[f"attention, k and v split on the {how}"] = f"{type(e).__name__}: {e}"
    pos = distribute_tensor(torch.tensor(17, dtype=torch.int32), mesh, [Replicate(), Replicate()],
                            src_data_rank=None)
    mode = collective_sizes()
    with mode:
        value = int(pos)
    out["int(pos)"] = {"value": value, "collectives": mode.calls}
    return out


def refused(torch, mesh_by_shape, inputs):
    """A decode batch of 2 on 4 x 1: the rules, and what the step raises
    with whether the cache was left as it was."""
    from repro_torch.configs.registry import get_config
    from repro_torch.dist import sharding as S
    from repro_torch.models.registry import decode_cache_len, make_serve_step, model_fns
    from repro_torch.models.registry import shapes_and_axes
    from repro_torch.tree import tree_leaves

    name, arch, mesh_shape, batch_size = REFUSED
    mesh = mesh_by_shape[mesh_shape]
    cfg = get_config(arch, reduced=True)
    fns = model_fns(cfg)
    n_slots = decode_cache_len(SEQ)
    params, axes = fns.init(torch.Generator().manual_seed(0), "cpu")
    _, cache_axes = shapes_and_axes(fns.make_cache, batch_size, n_slots)
    tokens = torch.from_numpy(inputs["tokens"][:batch_size])
    out = {}
    with torch.no_grad():
        rules = S.default_rules(cfg, mesh, cell(batch_size, "prefill"))
        with S.logical_sharding(mesh, rules):
            p = S.distribute(params, S.tree_shardings(axes, mesh, rules))
            b = S.distribute({"tokens": tokens}, S.batch_shardings({"tokens": tokens}, mesh, rules))
            _, cache = fns.prefill(p, dict(b, cache_len=n_slots))
        rules = S.default_rules(cfg, mesh, cell(batch_size, "decode"))
        out["rules"] = {k: rules[k] for k in ("act_batch", "kvheads", "cache_seq")}
        with S.logical_sharding(mesh, rules):
            cache = S.distribute(cache, S.tree_shardings(cache_axes, mesh, rules))
            out["placements"] = [str(tuple(t.placements)) for t in tree_leaves(cache)]
            before = [t.to_local().clone() for t in tree_leaves(cache)]
            batch = {"token": tokens[:, 0], "pos": torch.tensor(SEQ, dtype=torch.int32)}
            batch = S.distribute(batch, S.batch_shardings(batch, mesh, rules))
            try:
                make_serve_step(cfg)(p, cache, batch)
                out["error"] = None
            except NotImplementedError as e:
                out["error"] = f"{type(e).__name__}: {e}"
            out["cache_unchanged"] = all(torch.equal(a, t.to_local())
                                         for a, t in zip(before, tree_leaves(cache)))
    return out


def port_rank(rank, out_dir):
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)   # 4 ranks beside the reference's world: no oversubscribed cores
    _init_world(rank, WORLD, out_dir)
    ref = _wait_for(os.path.join(out_dir, "inputs.pkl"))
    meshes = {}
    for shape in sorted({c[2] for c in CASES}):
        meshes[shape] = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    out = {"cases": {}}
    out["write_checks"] = write_checks(torch, meshes[(2, 2)])
    out["refused"] = refused(torch, meshes, ref[CASES[0][0]])
    routing = None
    for case in CASES:
        if routed(case) and routing is None:
            routing = _wait_for(os.path.join(out_dir, "routing.pkl"))
        out["cases"][case[0]] = port_case(torch, rank, meshes[case[2]], case, ref[case[0]],
                                          routing[case[0]] if routed(case) else None)
    with open(os.path.join(out_dir, f"port{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    _end_world()


def run_port(out_dir):
    import torch.multiprocessing as mp

    mp.spawn(port_rank, args=(out_dir,), nprocs=WORLD, join=True)


if __name__ == "__main__":
    mode, directory = sys.argv[1], sys.argv[2]
    {"ref": run_ref, "port": run_port}[mode](directory)
