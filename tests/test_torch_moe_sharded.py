"""The port's sharded MoE bodies against the reference's, across ranks.

The reference runs ``moe_ffn`` under ``shard_map`` on 4 forced JAX host
devices; the port runs it on 4 gloo ranks (``repro_torch.dist.shard_map``)
over the same numpy params and tokens, each world in a subprocess of its
own (``tests/_torch_moe_ranks.py``) under a timeout.  Both meshes put
rank / device r at (r // n_model, r % n_model) of ``(data, model)``, so
rank r's ``to_local()`` is held against device r's shard.

Cases (``_torch_moe_ranks.CASES``): the 2 × 2, 1 × 4 and 4 × 1 meshes; the
three bodies (EP, EP resident for decode, gather; EP on a mesh whose
"model" axis is 1 takes gather, as the reference's rule says); FSDP on and
off; one and two token chunks; f32 and bf16 compute; a capacity short
enough to drop rows.  Tolerances are the reference's: f32 2e-5, bf16 2e-2;
the aux loss within 2e-5.  The params are placed by ``tree_shardings``
under ``default_rules``; under EP on the 2 × 2 mesh those are the body's
in-specs, so the redistribution is a no-op (asserted).  A plain tensor on
the mesh raises ``TypeError``.

Gradients: the router's, the experts' and the tokens' gradients of
``sum(y * cot) + aux / 2`` through ``torch.autograd`` are held against
``jax.grad`` through the reference's sharded layer (f32 1e-4, bf16 a
relative norm of 2e-2), and keep their inputs' placements.  The
reference's own sharded gradient of ``sum(y * cot)`` is held against its
unsharded one where the body drops no row: JAX's unchecked transposes
give the global gradient there.
"""
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
RANKS = ROOT / "tests" / "_torch_moe_ranks.py"
sys.path.insert(0, str(ROOT / "tests"))
import _torch_moe_ranks as W  # noqa: E402

TIMEOUT = 300
F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
GRADS = dict(rtol=1e-4, atol=1e-4)
BF16_GRAD_REL = 2e-2


def _run(mode, directory):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, str(RANKS), mode, str(directory)], env=env,
                         cwd=str(ROOT), capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, (mode, out.stdout[-3000:], out.stderr[-3000:])


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The reference's shards, then the 4-rank gloo world's, once a module."""
    d = tmp_path_factory.mktemp("moe")
    _run("ref", d)
    _run("port", d)
    with open(d / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    ranks = []
    for r in range(W.WORLD):
        with open(d / f"port{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ref, ranks


@pytest.mark.parametrize("case", W.CASES, ids=[c[0] for c in W.CASES])
def test_every_rank_holds_the_reference_devices_shard(worlds, case):
    name, shape, overrides, resident, seq = case
    ref, ranks = worlds
    want = ref[name]
    tol = BF16 if overrides.get("compute_dtype") == "bfloat16" else F32
    body = W.case_body(overrides, shape, resident)
    for r, got in enumerate(ranks):
        mine = got["cases"][name]
        assert mine["bodies"] == [body], (r, mine["bodies"])
        assert mine["global_shape"] == (W.BATCH, seq, W.LAYER["d_model"])
        assert mine["local"].shape == want["shards"][r].shape
        np.testing.assert_allclose(mine["local"], want["shards"][r], err_msg=f"rank {r}", **tol)
        assert abs(mine["aux"] - want["aux"][r]) <= 2e-5, (r, mine["aux"], want["aux"][r])
    # the tokens split over "data", the output replicated over "model"
    assert ranks[0]["cases"][name]["placements"] == "(Shard(dim=0), Replicate())"


def test_the_short_capacity_case_drops_rows(worlds):
    """At capacity 0.5 the reference's EP output leaves the dropless local
    layer, and the port's follows it there."""
    ref, ranks = worlds
    name = next(c[0] for c in W.CASES if "drops rows" in c[0])
    want = ref[name]
    full = np.concatenate([want["shards"][r] for r in (0, 2)])   # the data shards of model 0
    assert np.abs(full - want["local"]).max() > 0.1
    got = np.concatenate([ranks[r]["cases"][name]["local"] for r in (0, 2)])
    np.testing.assert_allclose(got, full, **F32)


def test_rules_place_ep_params_where_the_body_wants_them(worlds):
    """Under EP (and gather) on the 2 x 2 mesh, ``default_rules`` put the
    expert weights at the body's in-specs, so ``shard_map`` moves none."""
    _, ranks = worlds
    for name, shape, *_ in W.CASES:
        if shape == (2, 2):
            for got in ranks:
                assert all(got["cases"][name]["params_in_place"].values()), name


def test_a_plain_or_grad_requiring_input_is_refused(worlds):
    """A plain tensor is refused; a grad-requiring DTensor is not: it gets
    its gradient (``test_gradients_match_jax_grad``)."""
    _, ranks = worlds
    for got in ranks:
        assert got["errors"]["plain"].startswith("TypeError"), got["errors"]
        assert "distribute it first" in got["errors"]["plain"]
        assert "grad" not in got["errors"]
        first = got["cases"][W.CASES[0][0]]["grads"]
        assert all(np.isfinite(g).all() for g in first["full"].values())


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("case", W.CASES, ids=[c[0] for c in W.CASES])
def test_gradients_match_jax_grad(worlds, case):
    """Every rank's router, expert and token gradients against
    ``jax.grad`` through the reference's sharded ``moe_ffn``."""
    name, _, overrides, _, _ = case
    ref, ranks = worlds
    want = ref[name]["grads"]["sharded"]
    for r, got in enumerate(ranks):
        grads = got["cases"][name]["grads"]
        assert all(grads["placements_kept"].values()), (r, grads["placements_kept"])
        for k, w in want.items():
            g = grads["full"][k]
            assert g.shape == w.shape, (k, g.shape, w.shape)
            assert np.abs(w).max() > 0, k
            if overrides.get("compute_dtype") == "bfloat16":
                assert _rel(g, w) < BF16_GRAD_REL, (r, k, _rel(g, w))
            else:
                np.testing.assert_allclose(g, w, err_msg=f"rank {r} {k}", **GRADS)


@pytest.mark.parametrize("case", [c for c in W.CASES if "drops rows" not in c[0]],
                         ids=[c[0] for c in W.CASES if "drops rows" not in c[0]])
def test_reference_sharded_gradient_is_its_unsharded_gradient(worlds, case):
    """JAX's transposes under ``check_rep=False`` (psum to psum, the output
    cotangent divided over its replicated axes, a replicated input's
    cotangent psummed) give the reference's sharded layer the gradient of
    its unsharded one: no axis-size factor to copy."""
    name, _, overrides, _, _ = case
    ref, _ = worlds
    grads = ref[name]["grads"]
    for k, w in grads["local_y"].items():
        g = grads["sharded_y"][k]
        if overrides.get("compute_dtype") == "bfloat16":
            assert _rel(g, w) < BF16_GRAD_REL, (k, _rel(g, w))
        else:
            np.testing.assert_allclose(g, w, err_msg=k, **GRADS)


def test_the_bodies_reduce_over_the_mesh(worlds):
    """Each body moved data through the mesh collectives: the gather body's
    and EP's weights are all-gathered under FSDP on the 2 x 2 mesh, and
    every body sums its output over "model" where that axis is 2 or 4."""
    _, ranks = worlds
    for name, shape, overrides, resident, seq in W.CASES:
        moved = ranks[0]["cases"][name]["collective_bytes"]
        if shape[1] > 1:
            assert moved["psum"] >= W.BATCH // shape[0] * seq * W.LAYER["d_model"] * 4, name
        if shape == (2, 2) and overrides.get("fsdp_params") and not resident:
            assert moved["all_gather"] > 0, name


def test_shard_map_collectives_follow_the_mesh(worlds):
    """On the 2 x 2 (data, model) mesh (rank r at (r // 2, r % 2)): a tuple
    of axes gathers first axis major, as ``lax.all_gather`` concatenates;
    psum, pmean, axis_index and axis_size; and an input placed (Shard(0),
    Shard(1)) moved to its in-spec by the port's own gathers and cuts."""
    _, ranks = worlds
    full = np.arange(32, dtype=np.float32).reshape(8, 4)
    for r, got in enumerate(ranks):
        d, m = divmod(r, 2)
        data_major, model_major, stacked, total, mean, where = got["collectives"]["gathers"]
        assert data_major == [0.0, 1.0, 2.0, 3.0]
        assert model_major == [0.0, 2.0, 1.0, 3.0]
        assert stacked == [[2.0 * d], [2.0 * d + 1]]
        assert total == [6.0] and mean == [2.0 * d + 0.5]
        assert where == [d, m, 2, 2]
        rows, cols = got["collectives"]["moved"]
        np.testing.assert_array_equal(rows, full[2 * r:2 * r + 2])
        np.testing.assert_array_equal(cols, full[:, 2 * m:2 * m + 2])
