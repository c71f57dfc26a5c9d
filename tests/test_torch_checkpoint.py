"""Checkpoints of the port in the reference's format: round trips in f32
and bf16 onto the ``like`` tree's dtypes, keep-k, a torn newest file
skipped, the async writer, and files crossing between the packages bit for
bit in both directions."""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as ref_ckpt
from repro_torch.bridge import flatten, params_from_numpy
from repro_torch.ckpt import checkpoint as ckpt


def _tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"main": {"layers": [{"w": rng.normal(size=(5, 4)).astype(dtype),
                                 "b": rng.normal(size=(4,)).astype(dtype)},
                                {"w": rng.normal(size=(4, 3)).astype(dtype),
                                 "b": rng.normal(size=(3,)).astype(dtype)}],
                     "head": {"w": rng.normal(size=(3, 2)).astype(dtype)}}}


def _bits_equal(port_tree, ref_tree):
    got, want = flatten(port_tree), ref_ckpt._flatten(ref_tree)
    assert list(got) == list(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16], ids=["f32", "bf16"])
def test_round_trip_restores_onto_the_like_tree(tmp_path, dtype):
    tree = params_from_numpy(_tree(0, dtype), "cpu")
    path = str(tmp_path / "a" / "ckpt.npz")
    ckpt.save_pytree(path, tree, {"note": 1})
    like = params_from_numpy(_tree(1, dtype), "cpu")
    back = ckpt.restore_pytree(path, like)
    for a, b in zip(jax.tree.leaves(flatten(back)), jax.tree.leaves(flatten(tree))):
        assert np.array_equal(a, b)
    want_dtype = torch.bfloat16 if dtype is ml_dtypes.bfloat16 else torch.float32
    assert all(t.dtype == want_dtype for t in jax.tree.leaves(
        back, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    with np.load(path) as data:   # bf16 is widened to f32 in the file
        assert all(data[k].dtype == np.float32 for k in data.files)
    meta = ckpt.read_meta(path)
    assert meta["meta"] == {"note": 1} and meta["n_leaves"] == 5


def test_manager_keeps_k_and_skips_a_torn_newest_file(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=2)
    like = params_from_numpy(_tree(0), "cpu")
    for step in (1, 2, 3):
        mgr.save(step, params_from_numpy(_tree(step), "cpu"), {"round": step})
    assert mgr.steps() == [2, 3]
    with open(mgr._path(3), "wb") as f:
        f.write(b"torn")
    step, tree, meta = mgr.restore_latest_with_meta(like)
    assert step == 2 and meta == {"round": 2, "step": 2}
    _bits_equal(tree, _tree(2))
    assert ckpt.CheckpointManager(str(tmp_path / "empty")).restore_latest(like) == (None, like)


def test_async_writer_snapshots_before_queueing(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=3, async_write=True)
    tree = params_from_numpy(_tree(4), "cpu")
    mgr.save(7, tree)
    with torch.no_grad():   # an update after save: the write must not see it
        tree["main"]["head"]["w"].add_(1.0)
    mgr.wait()
    step, back = mgr.restore_latest(params_from_numpy(_tree(0), "cpu"))
    assert step == 7
    _bits_equal(back, _tree(4))
    mgr.close()
    assert mgr._worker is None


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16], ids=["f32", "bf16"])
def test_checkpoints_cross_between_the_packages_bit_for_bit(tmp_path, dtype):
    ref_tree = jax.tree.map(jnp.asarray, _tree(5, dtype))
    ref_ckpt.CheckpointManager(str(tmp_path / "ref"), keep=3).save(4, ref_tree, {"sim_clock": 1.5})
    step, got, meta = ckpt.CheckpointManager(str(tmp_path / "ref")).restore_latest_with_meta(
        params_from_numpy(_tree(0, dtype), "cpu"))
    assert step == 4 and meta == {"sim_clock": 1.5, "step": 4}
    _bits_equal(got, jax.device_get(ref_tree))

    port_tree = params_from_numpy(_tree(6, dtype), "cpu")
    ckpt.CheckpointManager(str(tmp_path / "port"), keep=3).save(9, port_tree, {"comm_bytes": 12})
    step, back, meta = ref_ckpt.CheckpointManager(str(tmp_path / "port")).restore_latest_with_meta(
        jax.tree.map(jnp.asarray, _tree(0, dtype)))
    assert step == 9 and meta == {"comm_bytes": 12, "step": 9}
    assert all(np.asarray(l).dtype == np.dtype(dtype) for l in jax.tree.leaves(back))
    _bits_equal(port_tree, back)
    assert sorted(os.listdir(tmp_path / "port")) == ["ckpt_0000000009.npz",
                                                     "ckpt_0000000009.npz.meta.json"]
