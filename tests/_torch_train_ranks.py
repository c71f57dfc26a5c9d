"""Worlds for ``tests/test_torch_sharded_train.py``, each run in a
subprocess of its own so that no process group (and no forced JAX device
count) ever lives in the pytest process:

    python tests/_torch_train_ranks.py ref  DIR   # JAX, 4 forced host devices
    python tests/_torch_train_ranks.py port DIR   # torch, 4 gloo ranks
    python tests/_torch_train_ranks.py summary DIR  # both worlds' worst leaves

``ref`` first pickles every case's numpy params (the reference's init,
randomized further) and tokens (``inputs.pkl``); ``port`` starts on them
while ``ref`` compiles.  ``ref`` then runs the reduced config's prefill,
``jax.value_and_grad`` of its loss and one ``make_train_step`` step (AdamW,
grad clip 1.0) under ``jax.jit`` on a ``(data, model)`` mesh of the 4
devices, inside ``logical_sharding``: the params placed by
``tree_shardings``, the optimizer state by ``opt_state_axes``, the batch
by the dry run's batch axes (``("act_batch", None)``), as
``src/repro/launch/dryrun.py`` places them.  It pickles every device's
shard of the placed params, the logits, the gradients, and the params and
state after the step, with the loss and metrics.

A bf16 MoE case (``routed``) runs with the reference's top-k choices
forced on the port: ``ref`` runs those cases first, records every router
call's choices (``jax.debug.callback``, keyed by the router's first
values, one table a layer and program, with the probabilities) and
pickles them (``routing.pkl``); ``port`` routes its prefill and its step,
sharded and unsharded, by those tables, and rank 0 also records the
choices its unsharded step takes free.  A bf16 run flips a token's k-th
expert where two probabilities tie within bf16's rounding of the
activations, and one flip moves every MoE gradient leaf far past 2e-2.

``port`` gives each of 4 gloo ranks the same numpy params and batch,
places them with ``sharding.distribute`` under the same rules and runs
the port's prefill, ``value_and_grad`` and ``make_train_step`` inside
``logical_sharding``; it pickles each rank's ``to_local()`` of the same
trees, and rank 0 also runs the step unsharded.  Every rank also records
what a plain batch and the scans, the int8 decode and flash on a sequence
or head-dim sharded q raise.  Only ``ref`` imports JAX; every world ends
with a ``barrier()`` before its process group is destroyed.
"""
import contextlib
import os
import pickle
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

WORLD = 4
BATCH, SEQ = 8, 16
#: (name, arch, (data, model), overrides): both meshes' shapes and the
#: model axis alone, the chunked and the flash route (the plain version on
#: the CPU, through the local-shard wrapper), both MoE bodies (each in f32
#: and the gather body in bf16 too), FSDP on and off, remat none and full,
#: the cross-entropy over 4 sequence chunks, f32 and bf16 compute
CASES = (
    ("qwen 2x2 chunked f32", "qwen1.5-0.5b", (2, 2), {}),
    ("qwen 2x2 pallas fsdp remat loss-chunks f32", "qwen1.5-0.5b", (2, 2),
     dict(attn_impl="pallas", fsdp_params=True, remat="full", loss_chunk=4)),
    ("qwen 1x4 pallas bf16", "qwen1.5-0.5b", (1, 4),
     dict(attn_impl="pallas", compute_dtype="bfloat16")),
    ("qwen 4x1 chunked fsdp remat f32", "qwen1.5-0.5b", (4, 1),
     dict(fsdp_params=True, remat="full")),
    ("olmoe 2x2 ep pallas fsdp remat f32", "olmoe-1b-7b", (2, 2),
     dict(attn_impl="pallas", fsdp_params=True, remat="full")),
    ("olmoe 2x2 gather fsdp f32", "olmoe-1b-7b", (2, 2),
     dict(moe_impl="gather", fsdp_params=True)),
    ("olmoe 1x4 gather bf16", "olmoe-1b-7b", (1, 4),
     dict(moe_impl="gather", compute_dtype="bfloat16")),
)
OPT_STATE_KEYS = ("m", "v")
#: the programs whose routing a routed case records and forces
PROGRAMS = ("prefill", "step")


def routed(case) -> bool:
    """A bf16 MoE case: the port takes the reference's top-k choices."""
    return case[1] == "olmoe-1b-7b" and case[3].get("compute_dtype") == "bfloat16"


def _router_key(values):
    """A router's identity across the packages: its first four values (the
    f32 router is carried bit for bit, and every layer's differs)."""
    return tuple(float(v) for v in values)


@contextlib.contextmanager
def recorded_routes(jax, np, rmoe, calls):
    """The reference's ``route`` as it is, each call's top-k choices
    appended to ``calls`` as (router key, choices) when the program runs."""
    real = rmoe.route

    def record(router_w, x_flat, cfg):
        top_p, top_i, probs = real(router_w, x_flat, cfg)
        jax.debug.callback(lambda key, idx, pr: calls.append(
            (_router_key(key), np.asarray(idx), np.asarray(pr))),
            router_w.reshape(-1)[:4], top_i, probs)
        return top_p, top_i, probs

    rmoe.route = record
    try:
        yield calls
    finally:
        rmoe.route = real


def routing_table(np, calls):
    """One (top-k choices, probabilities) pair a router: every device and
    every call of a program (the gradient's forward and the step's) must
    have chosen the same."""
    table = {}
    for key, idx, probs in calls:
        have = table.setdefault(key, (idx, probs))
        if not np.array_equal(have[0], idx):
            raise AssertionError(f"the reference routed one layer two ways in one program: {key}")
    return table


@contextlib.contextmanager
def forced_routes(torch, moe, table):
    """The port's ``route`` with the top-k choices of ``table`` (by router)
    and the probabilities of its own router product."""
    real = moe.route

    def forced(router_w, x_flat, cfg):
        probs = torch.softmax(x_flat.float() @ router_w, dim=-1)
        top_i = torch.from_numpy(table[_router_key(router_w.detach().reshape(-1)[:4].tolist())][0])
        top_i = top_i.long().to(x_flat.device)
        assert top_i.shape[0] == x_flat.shape[0], (top_i.shape, x_flat.shape)
        top_p = torch.gather(probs, 1, top_i)
        return top_p / top_p.sum(-1, keepdim=True), top_i, probs

    moe.route = forced
    try:
        yield
    finally:
        moe.route = real


def _path(keypath):
    """A JAX key path as the port's tree paths render it (``a/b/[0]``)."""
    parts = []
    for k in keypath:
        parts.append(f"[{k.idx}]" if hasattr(k, "idx") else str(k.key))
    return "/".join(parts)


def run_ref(out_dir):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from repro.configs.registry import get_config
    from repro.dist.sharding import default_rules, logical_sharding, tree_shardings
    from repro.models.registry import make_train_step, model_fns
    from repro.optim.optimizers import opt_state_axes

    assert len(jax.devices()) == WORLD, jax.devices()

    def shards(tree):
        out = {}
        for keypath, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[_path(keypath)] = {s.device.id: np.asarray(s.data, dtype=np.float32)
                                   for s in leaf.addressable_shards}
        return out

    # every case's numpy params and tokens first: the port's world starts
    # on them while this one compiles
    inputs = {}
    for i, (name, arch, _, overrides) in enumerate(CASES):
        cfg = get_config(arch, reduced=True).replace(**overrides)
        rng = np.random.default_rng(i)
        params, axes = model_fns(cfg).init(jax.random.PRNGKey(0))
        host = jax.tree.map(lambda a: np.asarray(a) + rng.normal(
            scale=0.02, size=a.shape).astype(np.asarray(a).dtype), params)
        inputs[name] = {"host": host, "axes": axes, "tokens": np.random.default_rng(
            100 + i).integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)}
    with open(os.path.join(out_dir, "inputs.tmp"), "wb") as f:
        pickle.dump({k: {"host": v["host"], "tokens": v["tokens"]} for k, v in inputs.items()},
                    f)
    os.replace(os.path.join(out_dir, "inputs.tmp"), os.path.join(out_dir, "inputs.pkl"))

    import repro.models.moe as rmoe

    out, routing = {}, {}
    # the routed cases first: the port's world waits for their routing
    for case in sorted(CASES, key=lambda c: not routed(c)):
        name, arch, shape, overrides = case
        calls = {program: [] for program in PROGRAMS}
        t0 = time.time()
        cfg = get_config(arch, reduced=True).replace(**overrides)
        fns = model_fns(cfg)
        mesh = Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))
        rules = default_rules(cfg, mesh)
        host, axes, tokens = (inputs[name][k] for k in ("host", "axes", "tokens"))
        with mesh, logical_sharding(mesh, rules):
            params_sh = tree_shardings(axes, mesh, rules)
            batch_sh = tree_shardings({"tokens": ("act_batch", None)}, mesh, rules)
            step, opt = make_train_step(cfg)
            opt_sh = tree_shardings(opt_state_axes(cfg.optimizer, axes, host), mesh, rules)
            p = jax.device_put(host, params_sh)
            b = jax.device_put({"tokens": tokens}, batch_sh)
            s = jax.device_put(opt.init(host), opt_sh)
            with (recorded_routes(jax, np, rmoe, calls["prefill"]) if routed(case)
                  else contextlib.nullcontext()):
                logits, _ = jax.jit(fns.prefill, in_shardings=(params_sh, batch_sh))(p, b)
            # the gradients and the step in one program: one compile
            vag = jax.value_and_grad(fns.loss, has_aux=True)
            with (recorded_routes(jax, np, rmoe, calls["step"]) if routed(case)
                  else contextlib.nullcontext()):
                ((loss, metrics), grads), (p2, s2, m2) = jax.jit(
                    lambda p_, s_, b_: (vag(p_, b_), step(p_, s_, b_)),
                    in_shardings=(params_sh, opt_sh, batch_sh),
                    out_shardings=((None, params_sh), (params_sh, opt_sh, None)))(p, s, b)
                jax.effects_barrier()
        out[name] = {
            "placed": shards(p), "logits": shards(logits),
            "loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": shards(grads), "params_after": shards(p2),
            "state_after": {k: shards(s2[k]) for k in OPT_STATE_KEYS},
            "step_metrics": {k: float(v) for k, v in m2.items()},
            "seconds": time.time() - t0}
        if routed(case):
            routing[name] = out[name]["routing"] = {
                program: routing_table(np, calls[program]) for program in PROGRAMS}
            with open(os.path.join(out_dir, "routing.tmp"), "wb") as f:
                pickle.dump(routing, f)
            os.replace(os.path.join(out_dir, "routing.tmp"), os.path.join(out_dir, "routing.pkl"))
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


def _locals(tree):
    """Each leaf's ``to_local()`` (f32 on the host), by path."""
    from repro_torch.tree import tree_flatten_with_path

    return {k: v.to_local().float().numpy() for k, v in tree_flatten_with_path(tree)}


def _fulls(tree):
    from repro_torch.tree import tree_flatten_with_path

    return {k: (v.full_tensor() if hasattr(v, "full_tensor") else v).float().numpy()
            for k, v in tree_flatten_with_path(tree)}


def port_case(torch, rank, mesh, name, arch, overrides, want, routing=None):
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs.registry import get_config
    from repro_torch.dist import sharding as S
    from repro_torch.models.registry import make_train_step, model_fns, shapes_and_axes
    from repro_torch.models.registry import value_and_grad
    from repro_torch.optim.optimizers import opt_state_axes
    from repro_torch.tree import tree_flatten_with_path, tree_leaves

    from repro_torch.models import moe

    def routes(program):   # the reference's choices, where the case is routed
        if routing is None:
            return contextlib.nullcontext()
        return forced_routes(torch, moe, routing[program])

    t0 = time.time()
    cfg = get_config(arch, reduced=True).replace(**overrides)
    fns = model_fns(cfg)
    rules = S.default_rules(cfg, mesh)
    shapes, axes = shapes_and_axes(fns.init, torch.Generator().manual_seed(0))
    host = params_from_numpy(want["host"], "cpu")
    batch = {"tokens": torch.from_numpy(want["tokens"])}
    step, opt = make_train_step(cfg)
    state = opt.init(host)
    out = {}
    with S.logical_sharding(mesh, rules):
        p = S.distribute(host, S.tree_shardings(axes, mesh, rules))
        s = S.distribute(state, S.tree_shardings(opt_state_axes(cfg.optimizer, axes, shapes),
                                                 mesh, rules))
        b = S.distribute(batch, S.batch_shardings(batch, mesh, rules))
        out["placed"] = _locals(p)
        with torch.no_grad(), routes("prefill"):
            logits, _ = fns.prefill(p, b)
        with routes("step"):
            (loss, metrics), grads = value_and_grad(fns.loss, p, b)
            p2, s2, m2 = step(p, s, b)
        try:
            fns.loss(p, batch)
            out["plain_batch"] = None
        except TypeError as e:
            out["plain_batch"] = str(e)
    out.update(
        logits=logits.to_local().float().numpy(), loss=float(loss.full_tensor()),
        metrics={k: float(v.full_tensor() if hasattr(v, "full_tensor") else v)
                 for k, v in metrics.items()},
        grads=_locals(grads), params_after=_locals(p2),
        state_after={k: _locals(s2[k]) for k in OPT_STATE_KEYS},
        step_metrics={k: float(v.full_tensor() if hasattr(v, "full_tensor") else v)
                      for k, v in m2.items()},
        placements_kept=all(
            tuple(a.placements) == tuple(c.placements)
            for a, c in zip(tree_leaves((p2, s2)), tree_leaves((p, s)))),
        grads_placed_like_params=all(
            tuple(g.placements) == tuple(q.placements)
            for g, q in zip(tree_leaves(grads), tree_leaves(p))))
    # the same step unsharded, in this one process, against the whole trees
    full = {"logits": logits.full_tensor().float().numpy(), "grads": _fulls(grads),
            "params_after": _fulls(p2)}
    if rank == 0:
        with torch.no_grad(), routes("prefill"):
            u_logits, _ = fns.prefill(host, batch)
        with routes("step"):
            (u_loss, _), u_grads = value_and_grad(fns.loss, host, batch)
            u_p2, _, _ = step(host, state, batch)
        out["unsharded"] = {
            "loss": float(u_loss), "logits": u_logits.float().numpy(),
            "grads": {k: v.float().numpy() for k, v in tree_flatten_with_path(u_grads)},
            "params_after": {k: v.float().numpy() for k, v in tree_flatten_with_path(u_p2)},
            "sharded": full}
        if routing is not None:   # the choices the unsharded step takes free
            free = []
            real = moe.route

            def record(router_w, x_flat, cfg_):
                top_p, top_i, probs = real(router_w, x_flat, cfg_)
                free.append((_router_key(router_w.detach().reshape(-1)[:4].tolist()),
                             top_i.numpy().copy()))
                return top_p, top_i, probs

            moe.route = record
            try:
                value_and_grad(fns.loss, host, batch)
            finally:
                moe.route = real
            out["free_routing"] = free
    out["seconds"] = time.time() - t0
    return out


def refusals(torch, mesh):
    """What the scans, the int8 decode and flash on sequence- or
    head-dim-sharded DTensors raise, before any kernel is reached."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels.flash_attention import decode_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    def place(shape, placements, dtype=torch.float32):
        return distribute_tensor(torch.ones(shape, dtype=dtype), mesh, placements,
                                 src_data_rank=None)

    rep = [Replicate(), Replicate()]
    calls = {
        "ssd_scan": lambda: ssd_ops.ssd(place((2, 8, 4, 4), rep), place((2, 8, 4), rep),
                                        place((4,), rep), place((2, 8, 1, 4), rep),
                                        place((2, 8, 1, 4), rep), impl="pallas"),
        "rglru_scan": lambda: lru_ops.rglru_scan(place((2, 8, 4), rep), place((2, 8, 4), rep),
                                                 impl="pallas"),
        "flash_decode_int8": lambda: decode_ops.flash_decode_int8(
            place((2, 4, 8), rep), place((2, 4, 8, 8), rep, torch.int8),
            place((2, 4, 8, 8), rep, torch.int8), place((2, 4, 8), rep),
            place((2, 4, 8), rep), kv_len=8),
    }
    for what, placements in (("flash, q sharded on the sequence", [Shard(0), Shard(1)]),
                             ("flash, q sharded on the head dim", [Shard(0), Shard(3)])):
        calls[what] = lambda p=placements: fa_ops.flash_attention(
            *(place((4, 8, 4, 8), p) for _ in range(3)))
    out = {}
    for what, call in calls.items():
        try:
            call()
            out[what] = None
        except (TypeError, NotImplementedError) as e:
            out[what] = f"{type(e).__name__}: {e}"
    return out


def _wait_for(path, seconds=300):
    """The pickle the reference's world writes at ``path``, once it is there."""
    deadline = time.time() + seconds
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f"no {path}")
        time.sleep(0.2)
    with open(path, "rb") as f:
        return pickle.load(f)


def port_rank(rank, out_dir):
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)   # 4 ranks beside the reference's world: no oversubscribed cores
    _init_world(rank, WORLD, out_dir)
    ref = _wait_for(os.path.join(out_dir, "inputs.pkl"))
    meshes = {}
    out = {"cases": {}}
    routing = None
    for case in CASES:
        name, arch, shape, overrides = case
        mesh = meshes.get(shape)
        if mesh is None:
            mesh = meshes[shape] = init_device_mesh("cpu", shape,
                                                    mesh_dim_names=("data", "model"))
        if routed(case) and routing is None:
            routing = _wait_for(os.path.join(out_dir, "routing.pkl"))
        out["cases"][name] = port_case(torch, rank, mesh, name, arch, overrides, ref[name],
                                       routing[name] if routed(case) else None)
    out["refusals"] = refusals(torch, meshes[(2, 2)])
    with open(os.path.join(out_dir, f"port{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    _end_world()


def run_port(out_dir):
    import torch.multiprocessing as mp

    mp.spawn(port_rank, args=(out_dir,), nprocs=WORLD, join=True)


def summary(out_dir):
    """Print, from both worlds' pickles in ``out_dir``, each case's worst
    leaf against the reference (relative, over the ranks) for the
    gradients, the params after the step and AdamW's moments, and for a
    routed case how many tokens its free unsharded step routes otherwise
    than the reference, with their k-th and k+1-th probabilities' gaps."""
    import numpy as np

    with open(os.path.join(out_dir, "ref.pkl"), "rb") as f:
        ref = pickle.load(f)
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(out_dir, f"port{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))

    def rel(got, want):
        norm = float(np.linalg.norm(want))
        return float(np.linalg.norm(got - want)) / norm if norm else float(np.abs(got).max())

    for case in CASES:
        name = case[0]
        trees = {"grads": lambda c: c["grads"], "params after": lambda c: c["params_after"]}
        trees.update({f"state {k}": (lambda c, k=k: c["state_after"][k]) for k in OPT_STATE_KEYS})
        want = {"grads": ref[name]["grads"], "params after": ref[name]["params_after"]}
        want.update({f"state {k}": ref[name]["state_after"][k] for k in OPT_STATE_KEYS})
        for what, pick in trees.items():
            worst = max((rel(pick(ranks[r]["cases"][name])[path], shards[r]), path, r)
                        for r in range(WORLD) for path, shards in want[what].items())
            print(f"{name}: {what} worst leaf {worst[0]:.3e} ({worst[1]}, rank {worst[2]})")
        if routed(case):
            table = ref[name]["routing"]["step"]
            for key, idx in ranks[0]["cases"][name]["free_routing"]:
                want_idx, probs = table[key]
                flipped = np.nonzero((np.sort(idx, -1) != np.sort(want_idx, -1)).any(-1))[0]
                ranked = -np.sort(-probs[flipped], -1)
                k = idx.shape[-1]
                print(f"{name}: free routing, router {key[0]:.6f}: {len(flipped)} of {len(idx)} "
                      f"tokens otherwise, gaps {(ranked[:, k - 1] - ranked[:, k]).tolist()}")


if __name__ == "__main__":
    mode, directory = sys.argv[1], sys.argv[2]
    {"ref": run_ref, "port": run_port, "summary": summary}[mode](directory)
