"""A model's prefill and train step on DTensors across ranks, against the
reference's jitted step on 4 forced JAX devices.

The reference (``tests/_torch_train_ranks.py ref``) runs the reduced
qwen1.5-0.5b and olmoe-1b-7b configs' prefill, ``jax.value_and_grad`` of
the loss and one ``make_train_step`` step (AdamW, grad clip 1.0) under
``jax.jit`` with the params, optimizer state and batch placed by
``tree_shardings`` inside ``logical_sharding``, as its dry run places
them; the port (``... port``) runs the same on 4 gloo ranks, the trees
placed by ``sharding.distribute``.  Both meshes put rank / device r at
(r // n_model, r % n_model) of ``(data, model)``, so rank r's
``to_local()`` is held against device r's shard: the placed params bit
for bit, the last-token logits, the loss and metrics, every gradient
leaf, and the params and AdamW moments after the step.  Tolerances are the
reference's: f32 2e-5 (logits, loss), gradients and the step's trees
1e-4 leaf by leaf; bf16 compute 2e-2, relative.  qwen's bf16 trees are
held as one vector (a leaf whose gradient is rounding noise, as the key
bias's, has no relative error of its own); olmoe's bf16 trees also leaf
by leaf, with the reference's top-k choices forced on the port: a bf16
run flips a token's k-th expert where two router probabilities tie
within bf16's rounding, and one flip moves every MoE leaf by ~0.1
(``test_free_bf16_routing_differs_only_at_near_ties`` pins where).

Cases (``_torch_train_ranks.CASES``): the 2 × 2, 1 × 4 and 4 × 1 meshes;
the chunked and the flash route (on the CPU the flash wrapper takes each
rank's local shards to the plain version); the EP and the gather MoE
bodies, each in f32 (the gather body under FSDP) and the gather body in
bf16 too; FSDP on and off; remat none and full; the cross-entropy in one
chunk and over 4 sequence chunks; f32 and bf16 compute.  The
dense cases are also held against the port's own step unsharded.  A
plain batch on the mesh raises ``TypeError``; the scans and the int8
decode raise naming ROADMAP row 9b-iv, flash on a sequence- or
head-dim-sharded q naming row 9b-v.  Each world runs in a subprocess
under a timeout.
"""
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
RANKS = ROOT / "tests" / "_torch_train_ranks.py"
sys.path.insert(0, str(ROOT / "tests"))
import _torch_train_ranks as W  # noqa: E402

TIMEOUT = 400
F32 = dict(rtol=2e-5, atol=2e-5)
GRADS = dict(rtol=1e-4, atol=1e-4)
BF16_REL = 2e-2
#: a free bf16 route may choose another k-th expert than the reference only
#: where the reference's k-th and k+1-th probabilities are this close
#: (bf16 keeps 8 bits of the activations that feed the router)
NEAR_TIE = 2.0 ** -8
CASE_IDS = [c[0] for c in W.CASES]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The reference's world and the 4-rank gloo world, side by side (the
    port starts on the reference's inputs while the reference compiles)."""
    d = tmp_path_factory.mktemp("train")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    procs = {mode: subprocess.Popen([sys.executable, str(RANKS), mode, str(d)], env=env,
                                    cwd=str(ROOT), stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for mode in ("ref", "port")}
    outs = {}
    try:
        for mode, p in procs.items():
            outs[mode] = p.communicate(timeout=TIMEOUT)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    for mode, p in procs.items():
        assert p.returncode == 0, (mode, outs[mode][0][-3000:], outs[mode][1][-3000:])
    with open(d / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    ranks = []
    for r in range(W.WORLD):
        with open(d / f"port{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ref, ranks


def _bf16(overrides):
    return overrides.get("compute_dtype") == "bfloat16"


def _rel(got, want):
    norm = float(np.linalg.norm(want))
    return float(np.linalg.norm(got - want)) / norm if norm else float(np.abs(got).max())


def _bf16_rel(case):
    """A case's bf16 bound: (relative bound, leaf by leaf), or None in f32."""
    if not _bf16(case[3]):
        return None
    return BF16_REL, W.routed(case)


def _hold_trees(got, want, rank, rel, what):
    """Rank ``rank``'s local tree against device ``rank``'s shards: leaf by
    leaf at ``GRADS`` (``rel`` None), else within ``rel = (bound,
    leafwise)`` relative, as one vector and, if ``leafwise``, leaf by leaf."""
    assert sorted(got) == sorted(want), what
    diff = norm = 0.0
    for path, shards in want.items():
        w, g = shards[rank], got[path]
        assert g.shape == w.shape, (what, path, g.shape, w.shape)
        if rel is None:
            np.testing.assert_allclose(g, w, err_msg=f"{what} rank {rank} {path}", **GRADS)
        elif rel[1]:
            assert _rel(g, w) < rel[0], (what, rank, path, _rel(g, w))
        diff += float(np.sum((g - w).astype(np.float64) ** 2))
        norm += float(np.sum(w.astype(np.float64) ** 2))
    if rel is not None:
        assert (diff / norm) ** 0.5 < rel[0], (what, rank, (diff / norm) ** 0.5)


@pytest.mark.parametrize("case", W.CASES, ids=CASE_IDS)
def test_every_rank_holds_the_reference_devices_param_shard(worlds, case):
    ref, ranks = worlds
    want = ref[case[0]]["placed"]
    for r, got in enumerate(ranks):
        mine = got["cases"][case[0]]["placed"]
        assert sorted(mine) == sorted(want)
        for path, shards in want.items():
            np.testing.assert_array_equal(mine[path], shards[r], err_msg=f"rank {r} {path}")


@pytest.mark.parametrize("case", W.CASES, ids=CASE_IDS)
def test_prefill_logits_match_shard_for_shard(worlds, case):
    name, _, _, overrides = case
    ref, ranks = worlds
    want = ref[name]["logits"][""]
    for r, got in enumerate(ranks):
        g = got["cases"][name]["logits"]
        assert g.shape == want[r].shape, (g.shape, want[r].shape)
        if _bf16(overrides):
            assert _rel(g, want[r]) < BF16_REL, (r, _rel(g, want[r]))
        else:
            np.testing.assert_allclose(g, want[r], err_msg=f"rank {r}", **F32)


@pytest.mark.parametrize("case", W.CASES, ids=CASE_IDS)
def test_loss_and_every_gradient_leaf_match_shard_for_shard(worlds, case):
    name, _, _, overrides = case
    ref, ranks = worlds
    want = ref[name]
    tol = dict(rtol=BF16_REL, atol=0) if _bf16(overrides) else F32
    for r, got in enumerate(ranks):
        mine = got["cases"][name]
        np.testing.assert_allclose(mine["loss"], want["loss"], **tol)
        for key in ("ce", "aux", "tokens"):
            np.testing.assert_allclose(mine["metrics"][key], want["metrics"][key],
                                       err_msg=key, **(dict(tol, atol=2e-5)))
        _hold_trees(mine["grads"], want["grads"], r, _bf16_rel(case), "grads")


@pytest.mark.parametrize("case", W.CASES, ids=CASE_IDS)
def test_one_train_step_matches_shard_for_shard(worlds, case):
    """The params and AdamW's moments after one clipped step, each rank's
    shard against the device's; the step's loss and global norm."""
    name, _, _, overrides = case
    ref, ranks = worlds
    want = ref[name]
    tol = dict(rtol=BF16_REL, atol=0) if _bf16(overrides) else F32
    for r, got in enumerate(ranks):
        mine = got["cases"][name]
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(mine["step_metrics"][key], want["step_metrics"][key],
                                       err_msg=key, **tol)
        rel = _bf16_rel(case)
        _hold_trees(mine["params_after"], want["params_after"], r, rel, "params after")
        for k in W.OPT_STATE_KEYS:
            _hold_trees(mine["state_after"][k], want["state_after"][k], r, rel, f"state {k}")


def test_outputs_keep_their_inputs_placements(worlds):
    """The step's params and state come back under their inputs' placements,
    and each gradient under its parameter's (``out_shardings``)."""
    _, ranks = worlds
    for got in ranks:
        for name, mine in got["cases"].items():
            assert mine["placements_kept"], name
            assert mine["grads_placed_like_params"], name


def _unsharded_cases():
    """The dense cases, and the MoE case in bf16 on the 1 x 4 mesh, whose
    gather body sums d_ff's shards over "model" with no token split: there
    the sharded layer is the unsharded one, summed in another order."""
    return [c for c in W.CASES if c[1] == "qwen1.5-0.5b" or c[2] == (1, 4)]


@pytest.mark.parametrize("case", _unsharded_cases(), ids=[c[0] for c in _unsharded_cases()])
def test_the_sharded_step_is_the_unsharded_step(worlds, case):
    """The sharded prefill, gradients and step, gathered whole, against the
    port's own step in one process.  (Elsewhere an MoE model's sharded
    layer is another function: its aux loss is taken a token shard at a
    time and EP keeps rows up to a capacity; ``test_torch_moe_sharded``
    holds the layer's gradients against JAX's sharded and unsharded ones.)"""
    name, _, _, overrides = case
    _, ranks = worlds
    u = ranks[0]["cases"][name]["unsharded"]
    sharded = u["sharded"]
    if _bf16(overrides):
        assert _rel(sharded["logits"], u["logits"]) < BF16_REL
    else:
        np.testing.assert_allclose(sharded["logits"], u["logits"], **F32)
    for what in ("grads", "params_after"):
        want = {k: {0: v} for k, v in u[what].items()}
        _hold_trees(sharded[what], want, 0, _bf16_rel(case), what)


ROUTED = [c for c in W.CASES if W.routed(c)]


@pytest.mark.parametrize("case", ROUTED, ids=[c[0] for c in ROUTED])
def test_free_bf16_routing_differs_only_at_near_ties(worlds, case):
    """Why the bf16 MoE cases take the reference's routing: the port's
    unsharded step, routed free, chooses another top-k set than the
    reference's jitted step only for a few tokens, each with its k-th and
    k+1-th reference probabilities within ``NEAR_TIE``."""
    ref, ranks = worlds
    table = ref[case[0]]["routing"]["step"]
    free = ranks[0]["cases"][case[0]]["free_routing"]
    assert len(free) == len(table) and {key for key, _ in free} == set(table)
    for key, idx in free:
        want_idx, probs = table[key]
        k = idx.shape[-1]
        flipped = np.nonzero((np.sort(idx, -1) != np.sort(want_idx, -1)).any(-1))[0]
        assert len(flipped) <= len(idx) // 32, (key, len(flipped))
        ranked = -np.sort(-probs[flipped], -1)
        gaps = ranked[:, k - 1] - ranked[:, k]
        assert (gaps < NEAR_TIE).all(), (key, gaps)


def test_a_plain_batch_is_refused(worlds):
    _, ranks = worlds
    for got in ranks:
        for name, mine in got["cases"].items():
            assert mine["plain_batch"] and "distribute it first" in mine["plain_batch"], name


@pytest.mark.parametrize("what", ["ssd_scan", "rglru_scan", "flash_decode_int8",
                                  "flash, q sharded on the sequence",
                                  "flash, q sharded on the head dim"])
def test_sharded_operands_of_row_9b_iii_are_refused(worlds, what):
    _, ranks = worlds
    row = "row 9b-v" if what.startswith("flash,") else "row 9b-iv"
    for got in ranks:
        err = got["refusals"][what]
        assert err is not None and row in err, (what, err)
        assert err.startswith("NotImplementedError" if what.startswith("flash,")
                              else "TypeError"), err


class _OneDeviceMesh:
    """Just enough ``DeviceMesh`` for a ``logical_sharding`` context."""

    mesh_dim_names = ("data", "model")
    shape = (1, 1)


def test_remat_recomputes_inside_the_forwards_context_on_another_thread():
    """On the card autograd runs a backward on a device thread of its own,
    where the thread-local context stack is empty; remat's recomputation
    must see the forward's ``logical_sharding`` context all the same."""
    import threading
    import types

    import torch

    from repro_torch.dist import sharding as S
    from repro_torch.models.lm import maybe_remat

    seen = []

    def body(x):
        seen.append(S.current_context())
        return x * x

    with S.logical_sharding(_OneDeviceMesh(), {}) as ctx:
        x = torch.ones(3, requires_grad=True)
        y = maybe_remat(body, types.SimpleNamespace(remat="full"))(x).sum()
    grads = []
    worker = threading.Thread(target=lambda: grads.append(torch.autograd.grad(y, x)[0]))
    worker.start()
    worker.join()
    assert seen == [ctx, ctx]          # the forward, and the recomputation on the thread
    assert grads[0].tolist() == [2.0, 2.0, 2.0]   # d(x·x)/dx at 1
    assert S.current_context() is None
