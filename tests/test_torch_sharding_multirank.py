"""The port's sharding rules on real process groups, and the model's
constraints wired where the reference's are.

(i)-(ii) The reference ``device_put``s the tiny dense and MoE configs'
params with its ``tree_shardings`` on a 2 × 2 ``("data", "model")`` mesh
of 4 forced host devices (``fsdp_params=True``, so both axes shard); a
4-rank gloo world distributes the same params with the port's placements,
and rank r's ``to_local()`` must equal device r's shard bit for bit (both
meshes put r at (r // 2, r % 2)).  So must a DTensor activation constrained
by ``with_logical_constraint``, a length-1 decode dim degrading to
replicated, and a decode cache whose seq dim is split over ``("data",
"model")`` (two mesh dims on one tensor dim, data major); a plain tensor
must raise there.  (iii) A ``fake``-backend
world of 256 builds ``make_production_mesh()``: rank 0's local shapes of
qwen1.5-0.5b's and kimi-k2's params equal each global dim ÷
``entry_shards`` of the reference's spec.  Each world runs in a subprocess
of its own (``tests/_torch_sharding_ranks.py``) under a timeout.

Wiring: the port calls ``with_logical_constraint`` as often as the
reference (its function wrapped for the test, the reference unrolled with
``scan_layers=False`` so each layer traces its own call) in a prefill and a
decode step of each family's tiny config; qwen1.5-0.5b at its published
width, run on ``meta``, makes the count ``chip_smoke.py``'s phase 33 holds;
inside a 1 × 1 gloo context every family's logits and cache leaves equal
those outside it bit for bit, and the MoE block gets the context's mesh.
"""
import importlib.util
import os
import pathlib
import pickle
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.dist.sharding as ref_sharding
from repro.configs import registry as ref_registry
from repro.configs.base import SHAPES_BY_NAME as REF_SHAPES
from repro.dist.mesh_utils import axis_sizes as ref_axis_sizes
from repro.dist.mesh_utils import entry_shards as ref_entry_shards
from repro.models import blocks as ref_blocks
from repro.models import encdec as ref_encdec
from repro.models import lm as ref_lm
from repro.models.registry import model_fns as ref_model_fns
from repro.models.registry import shapes_and_axes as ref_shapes_and_axes
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import registry
from repro_torch.dist import sharding as S
from repro_torch.models.registry import model_fns, shapes_and_axes

ROOT = pathlib.Path(__file__).resolve().parent.parent
RANKS = ROOT / "tests" / "_torch_sharding_ranks.py"
sys.path.insert(0, str(ROOT / "tests"))
import _torch_sharding_ranks as W  # noqa: E402

TIMEOUT = 300


class FakeMesh:
    """Just enough mesh for the reference's rule construction."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


def _run(mode, directory):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, str(RANKS), mode, str(directory)], env=env,
                         cwd=str(ROOT), capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, (mode, out.stdout[-3000:], out.stderr[-3000:])


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The reference's shards, then the 4-rank gloo world's, once a module."""
    d = tmp_path_factory.mktemp("shards")
    _run("ref", d)
    _run("port", d)
    with open(d / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    ranks = []
    for r in range(W.WORLD):
        with open(d / f"port{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ref, ranks


# ---------------------------------------------------------------- (i)-(ii)


@pytest.mark.parametrize("name", [n for n, _ in W.ARCHS])
def test_every_rank_holds_the_reference_devices_shard_of_each_param(worlds, name):
    ref, ranks = worlds
    want = ref["params"][name]
    sharded = 0
    for r, got in enumerate(ranks):
        assert not got["errors"], got["errors"]
        assert sorted(got["params"][name]) == sorted(want), r
        for path, leaf in want.items():
            mine = got["params"][name][path]
            assert tuple(mine["spec"]) == tuple(leaf["spec"]) + (None,) * (
                len(mine["spec"]) - len(leaf["spec"])), (path, mine["spec"], leaf["spec"])
            assert mine["local"].dtype == leaf["shards"][r].dtype, path
            np.testing.assert_array_equal(mine["local"], leaf["shards"][r], err_msg=f"{path} r{r}")
            sharded += mine["local"].size < leaf["full"].size
    # both mesh axes shard something: fsdp over "data" and TP/EP over "model"
    specs = {e for leaf in want.values() for e in leaf["spec"] if e is not None}
    assert {"data", "model"} <= specs, specs
    assert sharded > 0


@pytest.mark.parametrize("name", [a[0] for a in W.ACTIVATIONS])
def test_a_constrained_activation_holds_the_reference_devices_shard(worlds, name):
    ref, ranks = worlds
    want = ref["activations"][name]
    for r, got in enumerate(ranks):
        mine = got["activations"][name]
        np.testing.assert_array_equal(mine["local"], want["shards"][r], err_msg=f"{name} r{r}")
        assert mine["full_equal"], name
    if name.startswith("decode residual"):   # seq 1 under act_seq = "model": replicated
        assert ranks[0]["activations"][name]["placements"] == "(Shard(dim=0), Replicate())"
        assert ranks[0]["activations"][name]["local"].shape == (2, 1, 64)
    if name.startswith("decode cache"):   # one dim over both mesh axes, data major
        assert want["spec"][1] == ("data", "model"), want["spec"]
        for got in ranks:
            mine = got["activations"][name]
            assert mine["spec"][1] == ("data", "model"), mine["spec"]
            assert mine["placements"] == "(Shard(dim=1), Shard(dim=1))", mine["placements"]
            assert mine["local"].shape == (1, 2, 4, 16)
        # rank r holds the r-th quarter of the sequence
        for r, got in enumerate(ranks):
            np.testing.assert_array_equal(got["activations"][name]["local"],
                                          want["x"][:, 2 * r:2 * r + 2])


def test_a_plain_tensor_raises_on_the_four_rank_mesh(worlds):
    _, ranks = worlds
    for got in ranks:
        assert got["errors"] == []


# ---------------------------------------------------------------- (iii)


@pytest.fixture(scope="module")
def fake_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("fake")
    _run("fake", d)
    with open(d / "fake.pkl", "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "kimi-k2-1t-a32b"])
def test_production_mesh_local_shapes_are_the_reference_divisions(fake_world, arch):
    assert fake_world["mesh"] == (("data", "model"), (16, 16))
    mesh = FakeMesh((16, 16), ("data", "model"))
    sizes = ref_axis_sizes(mesh)
    cfg = ref_registry.get_config(arch)
    rules = ref_sharding.default_rules(cfg, mesh)
    shapes, axes = ref_shapes_and_axes(ref_model_fns(cfg).init, jax.random.PRNGKey(0))
    got = fake_world["archs"][arch]
    flat = jax.tree_util.tree_flatten_with_path(shapes)
    leaves_axes = jax.tree_util.tree_structure(shapes).flatten_up_to(axes)
    assert len(flat[0]) == len(got)
    split = 0
    for (keypath, sds), ax in zip(flat[0], leaves_axes):
        path = W._path(keypath)
        spec = tuple(ref_sharding.spec_for(ax, rules))
        spec = spec + (None,) * (len(sds.shape) - len(spec))
        want = tuple(d // ref_entry_shards(e, sizes) for d, e in zip(sds.shape, spec))
        global_shape, local_shape, device = got[path]
        assert global_shape == tuple(sds.shape) and device == "meta", path
        assert local_shape == want, (path, spec, local_shape, want)
        split += local_shape != global_shape
    assert split > 0


# ---------------------------------------------------------------- wiring


def _ref_calls(fn):
    """(result, calls of the reference's with_logical_constraint in fn())."""
    calls, real = [0], ref_sharding.with_logical_constraint

    def spy(x, *axes):
        calls[0] += 1
        return real(x, *axes)

    with mock.patch.object(ref_lm, "with_logical_constraint", spy), \
            mock.patch.object(ref_blocks, "with_logical_constraint", spy), \
            mock.patch.object(ref_encdec, "with_logical_constraint", spy):
        out = fn()
    return out, calls[0]


def _port_calls(fn):
    before = S.CALLS["with_logical_constraint"]
    out = fn()
    return out, S.CALLS["with_logical_constraint"] - before


@pytest.mark.parametrize("family,arch", W.FAMILIES)
def test_the_port_constrains_as_often_as_the_reference(family, arch):
    ref_cfg = ref_registry.get_config(arch, reduced=True).replace(scan_layers=False)
    cfg = registry.get_config(arch, reduced=True)
    ref_fns, fns = ref_model_fns(ref_cfg), model_fns(cfg)
    params, _ = ref_fns.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jax.device_get(params)), "cpu")
    b, s = 2, 8
    batch = W._family_inputs(torch, cfg, b, s)
    ref_batch = {k: (v if isinstance(v, int) else jnp.asarray(v.numpy()))
                 for k, v in batch.items()}
    pos = s + cfg.n_vision_tokens
    (ref_logits, ref_cache), ref_pre = _ref_calls(lambda: ref_fns.prefill(params, ref_batch))
    _, ref_dec = _ref_calls(lambda: ref_fns.decode(
        params, ref_cache, {"token": jnp.zeros((b,), jnp.int32), "pos": jnp.int32(pos)}))
    with torch.no_grad():
        (_, cache), pre = _port_calls(lambda: fns.prefill(tparams, batch))
        _, dec = _port_calls(lambda: fns.decode(
            tparams, cache, {"token": torch.zeros((b,), dtype=torch.int64), "pos": pos}))
    assert (pre, dec) == (ref_pre, ref_dec), family
    # embed, a mixer and (but for mamba2's) an FFN residual a layer, the logits
    ffn_layers = sum(g.repeat for g in cfg.groups for sp in g.pattern if sp.ffn != "none")
    assert dec == 2 + cfg.total_layers + ffn_layers, (family, dec)
    assert ref_pre > 0 and ref_dec > 0


def test_qwen_at_its_published_width_makes_the_count_chip_smoke_holds():
    """qwen1.5-0.5b (24 layers) on ``meta``: 50 constraints a prefill and 50
    a decode step, phase 33's ``SHARDING_CONSTRAINTS_A_CALL``."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cfg = registry.get_config("qwen1.5-0.5b")
    fns = model_fns(cfg)
    params, _ = shapes_and_axes(fns.init, torch.Generator())
    with torch.no_grad(), torch.device("meta"):
        tokens = torch.zeros((4, 8), dtype=torch.int64)
        (_, cache), pre = _port_calls(lambda: fns.prefill(params, {"tokens": tokens,
                                                                   "cache_len": 16}))
        (logits, _), dec = _port_calls(lambda: fns.decode(params, cache,
                                                          {"token": tokens[:, 0], "pos": 8}))
    assert logits.shape == (4, cfg.vocab_size)
    assert pre == dec == 2 + 2 * cfg.total_layers == 50
    assert chip_smoke.SHARDING_CONSTRAINTS_A_CALL == pre


@pytest.fixture(scope="module")
def host_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("host")
    _run("host", d)
    with open(d / "host.pkl", "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("family", [f for f, _ in W.FAMILIES])
def test_inside_a_one_device_context_every_output_is_bit_identical(host_world, family):
    assert host_world["mesh"] == (("data", "model"), (1, 1), "gloo")
    got = host_world[family]
    assert got["logits_equal"] and got["cache_equal"] and got["cache_leaves"] > 0, got
    outside, inside = got["calls"]
    assert outside == inside > 0, got["calls"]
    plain_none, ruled_mesh, n_moe = got["moe_meshes"]
    assert plain_none and ruled_mesh, got["moe_meshes"]
    assert (n_moe > 0) == (family == "moe"), n_moe
