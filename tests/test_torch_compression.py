"""Uplink compression of the port against the reference's, on identical
deltas: ``none`` and ``topk`` exactly; ``int8`` bit for bit with the
reference's ``jax.random`` noise injected (the port's own default draws
from a ``torch.Generator``); the legacy and the tree form identical; wire
bytes; a zero leaf; and the port's default noise unbiased."""
import jax
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - dev extra not installed
    from _hypothesis_fallback import given, settings, strategies as st

from repro.fed import compression as ref_comp
from repro_torch.bridge import params_from_numpy
from repro_torch.fed import compression
from repro_torch.tree import tree_leaves

from _torch_worlds import ref_noise


def _delta(seed, zero_leaf=False):
    rng = np.random.default_rng(seed)
    d = {"main": {"layers": [{"w": rng.normal(size=(20, 16)).astype(np.float32) * 0.01,
                              "b": rng.normal(size=(16,)).astype(np.float32)}],
                  "head": {"w": rng.normal(size=(16, 10)).astype(np.float32) * 3.0,
                           "b": rng.normal(size=(10,)).astype(np.float32)}}}
    if zero_leaf:
        d["main"]["head"]["b"] = np.zeros((10,), np.float32)
    return d


def _leaves_equal(a, b):
    la, lb = tree_leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        assert np.array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("method", ["none", "topk", "int8"])
@pytest.mark.parametrize("zero_leaf", [False, True], ids=["dense", "zero-leaf"])
def test_compress_matches_reference(method, zero_leaf):
    delta = _delta(1, zero_leaf)
    seed = 3 * 1000 + 7
    want = ref_comp.compress(delta, method, k_frac=0.05, seed=seed)
    got = compression.compress(params_from_numpy(delta, "cpu"), method, k_frac=0.05, seed=seed,
                               noise=ref_noise)
    assert got["method"] == want["method"]
    for g, w in zip(got["leaves"], want["leaves"]):
        if method == "none":
            assert np.array_equal(g, w)
        elif method == "int8":
            assert g[0].dtype == np.int8 and np.array_equal(g[0], w[0])
            assert g[1] == w[1]
        else:
            for a, b in zip(g, w):
                assert np.array_equal(np.asarray(a), np.asarray(b))
    assert compression.compressed_bytes(got) == ref_comp.compressed_bytes(want)
    _leaves_equal(compression.decompress(got), ref_comp.decompress(want))


@pytest.mark.parametrize("method", ["none", "topk", "int8"])
def test_tree_form_matches_reference_and_the_legacy_form(method):
    delta = _delta(2, zero_leaf=True)
    seed = 11
    want = ref_comp.compress_tree(delta, method, k_frac=0.05, seed=seed)
    port_delta = params_from_numpy(delta, "cpu")
    got = compression.compress_tree(port_delta, method, k_frac=0.05, seed=seed, noise=ref_noise)
    assert compression.is_compressed_tree(got) == ref_comp.is_compressed_tree(want) == (method != "none")
    assert compression.tree_wire_bytes(got) == ref_comp.tree_wire_bytes(want)
    legacy = compression.compress(port_delta, method, k_frac=0.05, seed=seed, noise=ref_noise)
    assert compression.tree_wire_bytes(got) == compression.compressed_bytes(legacy)
    back = compression.decompress_tree(got)
    _leaves_equal(back, ref_comp.decompress_tree(want))
    _leaves_equal(back, jax.tree.leaves(compression.decompress(legacy)))
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want, is_leaf=ref_comp._is_wire_leaf)):
        if method == "int8":
            assert np.array_equal(g.q, w.q) and g.scale == w.scale
        elif method == "topk":
            assert g.shape == w.shape and np.array_equal(g.idx, w.idx)


def test_default_noise_is_seeded_per_leaf_and_client():
    delta = params_from_numpy(_delta(3), "cpu")
    a = compression.compress_tree(delta, "int8", seed=5)
    b = compression.compress_tree(delta, "int8", seed=5)
    c = compression.compress_tree(delta, "int8", seed=6)
    qa, qb, qc = ([l.q for l in tree_leaves(t)] for t in (a, b, c))
    assert all(np.array_equal(x, y) for x, y in zip(qa, qb))
    assert any(not np.array_equal(x, y) for x, y in zip(qa, qc))


def test_bf16_delta_compresses_as_its_f32_widening():
    delta = {"w": torch.randn(6, 5, generator=torch.Generator().manual_seed(0)).bfloat16()}
    wide = {"w": delta["w"].float()}
    for method in ("none", "topk", "int8"):
        a = compression.decompress_tree(compression.compress_tree(delta, method, k_frac=0.2, seed=1))
        b = compression.decompress_tree(compression.compress_tree(wide, method, k_frac=0.2, seed=1))
        assert np.array_equal(a["w"], b["w"]), method


@settings(max_examples=20, deadline=None)
@given(st.integers(min_value=0, max_value=2**20), st.floats(min_value=1e-3, max_value=1e3))
def test_int8_dequantized_mean_is_unbiased(seed, magnitude):
    """E[dequant] = value: over many draws of the port's default noise, the
    mean of each dequantized element is within 5 standard errors (the
    rounding's error is at most one step, ``scale``)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.uniform(-1, 1, size=(64,)) * magnitude).astype(np.float32))
    draws = 200
    deq = np.stack([compression.decompress(compression.compress(
        {"x": x}, "int8", seed=seed * 1000 + i))["x"] for i in range(draws)])
    scale = float(np.abs(x.numpy()).max()) / 127.0
    err = np.abs(deq.mean(0) - x.numpy())
    assert err.max() <= 5 * (0.5 * scale / np.sqrt(draws)) + 1e-6 * magnitude
