"""The optimizer substrate of the port against the reference: momentum,
adam, adamw (weight decay 0 and 0.01), adafactor (factored and unfactored
leaves) and sgd, three updates with params and state within 2e-5; bf16
params keep their dtype; ``warmup_cosine`` and a schedule driving an
update; ``cache_key``; the update of a stacked tree through
``torch.func.vmap`` is each client's own."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _flatten as ref_flatten
from repro.optim import optimizers as ref_opt
from repro_torch.bridge import flatten, params_from_numpy
from repro_torch.optim import optimizers
from repro_torch.tree import tree_leaves, tree_map

from _torch_worlds import max_tree_diff


def _opt_tree(seed, dtype=np.float32):
    """Leaves the factored rule takes (both trailing dims >= 128, a 3-D one
    too) and leaves it does not (a bias, a narrow matrix)."""
    rng = np.random.default_rng(seed)
    shapes = {"big": (128, 160), "stack": (2, 128, 130), "bias": (160,), "narrow": (8, 130)}
    return {k: rng.normal(size=s).astype(dtype) for k, s in shapes.items()}


OPT_CASES = [("sgd", 0.0), ("momentum", 0.0), ("adam", 0.0), ("adamw", 0.0),
             ("adamw", 0.01), ("adafactor", 0.0)]


def _run_updates(mk, name, wd, params, grads_seq, to_tree):
    opt = mk(name, 0.05, wd)
    p = to_tree(params)
    state = opt.init(p)
    for g in grads_seq:
        p, state = opt.update(to_tree(g), state, p)
    return opt, p, state


@pytest.mark.parametrize("name,wd", OPT_CASES, ids=[f"{n}-wd{w}" for n, w in OPT_CASES])
def test_optimizer_updates_match_reference(name, wd):
    params = _opt_tree(0)
    grads = [jax.tree.map(lambda a, s=s: a * s, _opt_tree(10 + i)) for i, s in enumerate((1.0, 3.0, 0.2))]
    r_opt, r_p, r_state = _run_updates(ref_opt.make_optimizer, name, wd, params, grads,
                                       lambda t: jax.tree.map(jnp.asarray, t))
    p_opt, p_p, p_state = _run_updates(optimizers.make_optimizer, name, wd, params, grads,
                                       lambda t: params_from_numpy(t, "cpu"))
    assert p_opt.cache_key == r_opt.cache_key == (name, 0.05, float(wd))
    assert max_tree_diff(flatten(p_p), ref_flatten(jax.device_get(r_p))) < 2e-5
    want_state, got_state = ref_flatten(jax.device_get(r_state)), flatten(p_state)
    assert max_tree_diff(got_state, want_state) < 2e-5   # same keys: factored vr/vc where the reference's
    assert got_state["step"].dtype == np.int32 and int(got_state["step"]) == 3
    if name == "adafactor":
        assert {"v/big/vr", "v/big/vc", "v/stack/vr", "v/bias/v", "v/narrow/v"} <= set(got_state)


@pytest.mark.parametrize("name,wd", OPT_CASES, ids=[f"{n}-wd{w}" for n, w in OPT_CASES])
def test_bf16_params_keep_their_dtype(name, wd):
    params = _opt_tree(1, ml_dtypes.bfloat16)
    grads = [_opt_tree(20 + i, ml_dtypes.bfloat16) for i in range(2)]
    _, r_p, _ = _run_updates(ref_opt.make_optimizer, name, wd, params, grads,
                             lambda t: jax.tree.map(jnp.asarray, t))
    _, p_p, p_state = _run_updates(optimizers.make_optimizer, name, wd, params, grads,
                                   lambda t: params_from_numpy(t, "cpu"))
    assert all(t.dtype == torch.bfloat16 for t in p_p.values())
    assert all(t.dtype in (torch.float32, torch.int32) for t in tree_leaves(p_state))
    # one bf16 rounding of an f32 result that agrees to 2e-5
    for k, want in ref_flatten(jax.device_get(r_p)).items():
        np.testing.assert_allclose(flatten(p_p)[k], want, rtol=1e-2, atol=1e-2)


def test_warmup_cosine_matches_reference():
    r_sched = ref_opt.warmup_cosine(0.3, warmup=10, total=100, floor=0.1)
    p_sched = optimizers.warmup_cosine(0.3, warmup=10, total=100, floor=0.1)
    for step in (0, 1, 10, 55, 100, 250):
        want = float(r_sched(jnp.asarray(step, jnp.int32)))
        got = p_sched(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-7)


def test_schedule_drives_the_update_and_is_not_cacheable():
    params = _opt_tree(2)
    grads = [_opt_tree(30 + i) for i in range(3)]
    r_opt = ref_opt.make_optimizer("momentum", ref_opt.warmup_cosine(0.2, 2, 5))
    p_opt = optimizers.make_optimizer("momentum", optimizers.warmup_cosine(0.2, 2, 5))
    assert r_opt.cache_key is None and p_opt.cache_key is None
    r_p, p_p = jax.tree.map(jnp.asarray, params), params_from_numpy(params, "cpu")
    r_s, p_s = r_opt.init(r_p), p_opt.init(p_p)
    for g in grads:
        r_p, r_s = r_opt.update(jax.tree.map(jnp.asarray, g), r_s, r_p)
        p_p, p_s = p_opt.update(params_from_numpy(g, "cpu"), p_s, p_p)
    assert max_tree_diff(flatten(p_p), ref_flatten(jax.device_get(r_p))) < 2e-5


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        optimizers.make_optimizer("lion", 1e-3)


@pytest.mark.parametrize("name", ["adafactor", "adamw"])
def test_vmapped_update_of_a_stacked_tree_is_each_client_s(name):
    """Two clients' trees stacked on a leading axis, updated through
    ``torch.func.vmap``, give each client's own update: adafactor's RMS clip
    and factoring see one client's leaf, not the stack."""
    opt = optimizers.make_optimizer(name, 0.1, 0.01)
    clients = [params_from_numpy(_opt_tree(40 + c), "cpu") for c in range(2)]
    grads = [params_from_numpy(jax.tree.map(lambda a, s=s: a * s, _opt_tree(50 + c)), "cpu")
             for c, s in enumerate((0.01, 50.0))]
    stack = lambda trees: tree_map(lambda *ls: torch.stack(ls), *trees)
    sp, sg = stack(clients), stack(grads)
    state = torch.func.vmap(opt.init)(sp)
    for _ in range(2):
        sp, state = torch.func.vmap(opt.update)(sg, state, sp)
    for c in range(2):
        p, s = clients[c], opt.init(clients[c])
        for _ in range(2):
            p, s = opt.update(grads[c], s, p)
        got = flatten(tree_map(lambda t, c=c: t[c], sp))
        assert max_tree_diff(got, flatten(p)) < 1e-6
