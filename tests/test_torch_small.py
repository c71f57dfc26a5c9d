"""Model, optimizer, aggregation, data and bridge of the port against the
reference, on bridged parameters and identical numpy inputs (f32 2e-5)."""
import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _flatten as ref_flatten
from repro.core import aggregation as ref_agg
from repro.data.partition import dirichlet_partition as ref_partition
from repro.data.pipeline import ClientDataset as RefClientDataset
from repro.data.synthetic import make_dataset as ref_make_dataset
from repro.models import small as ref_small
from repro.optim import optimizers as ref_opt
from repro_torch.bridge import flatten, params_from_numpy, params_to_numpy
from repro_torch.core import aggregation
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.pipeline import ClientDataset
from repro_torch.data.synthetic import make_dataset
from repro_torch.fed.client import clear_step_cache, make_small_step, step_cache_stats
from repro_torch.models import small
from repro_torch.optim import optimizers
from repro_torch.tree import tree_map

from _torch_worlds import MCFG, REF_MCFG, max_tree_diff

TOL = dict(rtol=2e-5, atol=2e-5)


def _ref_params(seed=0, cfg=REF_MCFG):
    return jax.device_get(ref_small.init_small(jax.random.PRNGKey(seed), cfg))


def _batch(n=12, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=n).astype(np.int32)
    return x, y


def _np_tree(seed, like):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), like)


# ------------------------------ bridge ---------------------------------------


def test_bridge_round_trip_is_exact_and_keys_match_checkpoint():
    ref = _ref_params()
    port = params_from_numpy(ref, "cpu")
    back = params_to_numpy(port)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    want = ref_flatten(ref)
    got = flatten(port)
    assert list(got) == list(want)  # same keys, same leaf order
    assert "main/layers/[0]/w" in got
    assert max_tree_diff(got, want) == 0.0


def test_bridge_carries_bf16_exactly_and_widens_it_to_f32():
    arr = np.random.default_rng(1).normal(size=(5, 3)).astype(ml_dtypes.bfloat16)
    port = params_from_numpy({"a": [arr]}, "cpu")
    assert port["a"][0].dtype == torch.bfloat16
    back = params_to_numpy(port)["a"][0]
    assert back.dtype == np.float32
    assert np.array_equal(back, arr.astype(np.float32))
    assert np.array_equal(flatten(port)["a/[0]"], ref_flatten({"a": [arr]})["a/[0]"])


# ------------------------------ model ----------------------------------------


def test_init_small_follows_the_reference_init_law():
    ref = _ref_params()
    port = small.init_small(3, MCFG, device="cpu")
    again = small.init_small(3, MCFG, device="cpu")
    for (k, a), (_, b) in zip(ref_flatten(ref).items(), flatten(port).items()):
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k.endswith("/b"):
            assert not b.any()
        else:
            bound = 1.0 / np.sqrt(a.shape[0])
            assert np.abs(b).max() <= bound and np.abs(b).max() > 0.5 * bound
    assert max_tree_diff(flatten(port), flatten(again)) == 0.0  # seeded


def test_small_loss_metrics_and_grads_match_reference():
    ref = _ref_params(seed=1)
    x, y = _batch()
    (loss, m), g = jax.value_and_grad(
        lambda p: ref_small.small_loss(p, REF_MCFG, {"x": x, "y": y}), has_aux=True)(ref)

    port = tree_map(lambda t: t.requires_grad_(), params_from_numpy(ref, "cpu"))
    loss_t, m_t = small.small_loss(port, MCFG, {"x": torch.from_numpy(x),
                                                "y": torch.from_numpy(y)})
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss), **TOL)
    np.testing.assert_allclose(m_t["ce"].item(), float(m["ce"]), **TOL)
    assert float(m_t["acc"]) == float(m["acc"])
    grads = flatten(tree_map(lambda t: t.grad, port))
    assert max_tree_diff(grads, ref_flatten(g)) < 2e-5


# ------------------------------ optimizer ------------------------------------


@pytest.mark.parametrize("scale", [0.1, 30.0])  # under / over the clip norm
def test_clip_and_sgd_update_match_reference(scale):
    ref = _ref_params(seed=2)
    grads = jax.tree.map(lambda a: a * scale, _np_tree(3, ref))
    r_clipped, r_norm = ref_opt.clip_by_global_norm(grads, 10.0)
    r_opt = ref_opt.make_optimizer("sgd", 0.05)
    r_new, r_state = r_opt.update(r_clipped, r_opt.init(ref), ref)

    p_opt = optimizers.make_optimizer("sgd", 0.05)
    assert p_opt.cache_key == r_opt.cache_key
    p_clipped, p_norm = optimizers.clip_by_global_norm(params_from_numpy(grads, "cpu"), 10.0)
    np.testing.assert_allclose(float(p_norm), float(r_norm), **TOL)
    p_new, p_state = p_opt.update(p_clipped, p_opt.init(None), params_from_numpy(ref, "cpu"))
    assert int(p_state["step"]) == int(r_state["step"]) == 1
    assert max_tree_diff(flatten(p_clipped), ref_flatten(r_clipped)) < 2e-5
    assert max_tree_diff(flatten(p_new), ref_flatten(r_new)) < 2e-5


def test_make_small_step_shared_across_callers():
    clear_step_cache()
    opt = optimizers.make_optimizer("sgd", 0.3)
    s1 = make_small_step(MCFG, opt, 0.0)
    s2 = make_small_step(MCFG, optimizers.make_optimizer("sgd", 0.3), 0.0)
    assert s1 is s2  # same (mcfg, optimizer key, prox): one step
    assert make_small_step(MCFG, opt, 0.1) is not s1  # prox changes the key
    stats = step_cache_stats()
    assert stats["hits"] == 1 and stats["misses"] == 2
    uncached = opt._replace(cache_key=None)
    assert make_small_step(MCFG, uncached, 0.0) is not s1
    assert step_cache_stats()["uncacheable"] == 1


# ------------------------------ aggregation ----------------------------------


def test_apply_deltas_matches_reference():
    ref = _ref_params(seed=4)
    deltas = [(_np_tree(10 + i, ref), w) for i, w in enumerate([3.0, 1.0, 6.0])]
    want = ref_agg.apply_deltas(ref, deltas, server_lr=0.7)
    got = aggregation.apply_deltas(
        params_from_numpy(ref, "cpu"),
        [(params_from_numpy(d, "cpu"), w) for d, w in deltas], server_lr=0.7)
    assert max_tree_diff(flatten(got), ref_flatten(want)) < 2e-5


def test_async_aggregator_matches_reference():
    ref = _ref_params(seed=5)
    r_agg, p_agg = ref_agg.AsyncAggregator(buffer_size=2), aggregation.AsyncAggregator(buffer_size=2)
    r_params, p_params = ref, params_from_numpy(ref, "cpu")
    arrivals = [(0, 2.0, 0), (1, 1.0, 0), (2, 5.0, 0), (3, 1.0, 2)]  # stale arrivals
    for seed, w, r0 in arrivals:
        d = _np_tree(20 + seed, ref)
        if r_agg.add(d, w, r0):
            r_params = r_agg.flush(r_params)
        if p_agg.add(params_from_numpy(d, "cpu"), w, r0):
            p_params = p_agg.flush(p_params)
    assert r_agg.server_round == p_agg.server_round == 2
    assert max_tree_diff(flatten(p_params), ref_flatten(r_params)) < 2e-5


# ------------------------------ data -----------------------------------------


def test_data_pipeline_is_the_reference_s_bit_for_bit():
    x, y = make_dataset("femnist", 300, seed=7)
    rx, ry = ref_make_dataset("femnist", 300, seed=7)
    assert np.array_equal(x, rx) and np.array_equal(y, ry)
    parts = dirichlet_partition(y, 6, alpha=0.5, seed=7)
    for a, b in zip(parts, ref_partition(ry, 6, alpha=0.5, seed=7)):
        assert np.array_equal(a, b)
    ds, rds = ClientDataset(x, y, 7, seed=3), RefClientDataset(rx, ry, 7, seed=3)
    for _ in range(60):  # crosses several reshuffles
        a, b = ds.next_batch(), rds.next_batch()
        assert np.array_equal(a["x"], b["x"]) and np.array_equal(a["y"], b["y"])

