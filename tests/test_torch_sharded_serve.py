"""A model's serve step on DTensors across ranks, against the reference's
jitted step on 4 forced JAX devices.

The reference (``tests/_torch_serve_ranks.py ref``) serves the reduced
qwen1.5-0.5b and olmoe-1b-7b configs as its dry run places a serve cell:
params by ``tree_shardings``, a ``jax.jit`` prefill of BATCH x SEQ into a
cache of ``decode_cache_len(SEQ)`` slots, the cache ``jax.device_put``
onto ``tree_shardings`` of ``make_cache``'s axes under the ``decode``
shape's ``default_rules``, then STEPS steps of ``jax.jit(serve_step,
in_shardings=(params_sh, cache_sh, batch_sh), out_shardings=(None,
cache_sh))``; the port (``... port``) does the same on 4 gloo ranks, the
prefill's cache moved onto the decode placements by
``sharding.distribute`` and each step writing its slot into every rank's
local shard.  Both meshes put rank / device r at (r // n_model, r %
n_model) of ``(data, model)``, so rank r's ``to_local()`` is held against
device r's shard: the logits and every cache leaf after the prefill and
after each step (the written slots, and zeros past them).  Tolerances
are the reference's: f32 2e-5, bf16 2e-2 relative; the int8 cache's
codes and scales bit for bit.

Also held: each case gathered whole against the port's own decode
unsharded (but the EP body not resident, which drops the rows past its
capacity, as the reference's does: another function than the unsharded
layer); every cache leaf keeping its local storage and placements over
the steps; no decode step handing a collective a tensor as large as one
layer's local k shard (no cache is gathered); a control step from a cache
whose rank 1 holds rank 0's k shards, outside the tolerance; the
in-place write itself, placed alike and replicated, plain and int8, and
through a layer's view of the stacked cache (no collective, the storage
kept); ``int`` of a replicated position (no collective); and a decode
batch that does not fill "data" (batch 2 on 4 x 1), whose rules shard
the cache's sequence over "data" and whose step raises
``NotImplementedError`` naming ROADMAP row 9b-v before any write.  The
decode rules are held against the reference's on the three meshes, for
batches that fill "data" and batches that do not, with no process group.
Each world runs in a subprocess under a timeout.
"""
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
RANKS = ROOT / "tests" / "_torch_serve_ranks.py"
sys.path.insert(0, str(ROOT / "tests"))
import _torch_serve_ranks as W  # noqa: E402

TIMEOUT = 400
F32 = dict(rtol=2e-5, atol=2e-5)
BF16_REL = 2e-2
CASE_IDS = [c[0] for c in W.CASES]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The reference's world and the 4-rank gloo world, side by side."""
    d = tmp_path_factory.mktemp("serve")
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


def _bf16(case):
    return case[3].get("compute_dtype") == "bfloat16"


def _int8(case):
    return bool(case[3].get("kv_cache_quant"))


def _rel(got, want):
    norm = float(np.linalg.norm(want))
    return float(np.linalg.norm(got - want)) / norm if norm else float(np.abs(got).max())


def _hold(got, want, case, what):
    """One array against another at the case's tolerance: bit for bit for an
    int8 cache's leaves, relative 2e-2 in bf16, f32's 2e-5 otherwise."""
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if _int8(case) and "kv/" in what:
        np.testing.assert_array_equal(got, want, err_msg=what)
    elif _bf16(case):
        assert _rel(got, want) < BF16_REL, (what, _rel(got, want))
    else:
        np.testing.assert_allclose(got, want, err_msg=what, **F32)


def _hold_program(ref, ranks, case, program):
    want = ref[case[0]]["programs"][program]
    for r, got in enumerate(ranks):
        mine = got["cases"][case[0]]["programs"][program]
        _hold(mine["logits"], want["logits"][""][r], case, f"{program} logits rank {r}")
        assert sorted(mine["cache"]) == sorted(want["cache"])
        for path, shards in want["cache"].items():
            (g, g_rest), (w, w_rest) = mine["cache"][path], shards[r]
            _hold(g, w, case, f"{program} {path} rank {r}")
            assert g_rest == w_rest, (program, path, r, g_rest, w_rest)   # unwritten slots


@pytest.mark.parametrize("case", W.CASES, ids=CASE_IDS)
def test_prefill_logits_and_placed_cache_match_shard_for_shard(worlds, case):
    ref, ranks = worlds
    _hold_program(ref, ranks, case, "prefill")


@pytest.mark.parametrize("case", W.CASES, ids=CASE_IDS)
def test_every_decode_step_matches_shard_for_shard(worlds, case):
    """Each step's logits and the cache it wrote, rank r against device r."""
    ref, ranks = worlds
    for i in range(W.STEPS):
        _hold_program(ref, ranks, case, f"step {i}")


@pytest.mark.parametrize("case", W.CASES, ids=CASE_IDS)
def test_the_cache_keeps_its_storage_and_placements(worlds, case):
    """Every leaf's local shard is the same storage after the steps as
    before, under the same placements: the writes landed in place."""
    _, ranks = worlds
    for r, got in enumerate(ranks):
        mine = got["cases"][case[0]]
        assert mine["storage_kept"], (r, mine["placements"])
        for p in mine["placements"]:   # batch or KV heads split, never the slots (dim 2)
            assert "Shard" in p and "Shard(dim=2)" not in p, p


def _unsharded_cases():
    return [c for c in W.CASES if not (c[1] == "olmoe-1b-7b" and c[3].get("moe_resident_serve")
                                       is False)]


@pytest.mark.parametrize("case", _unsharded_cases(), ids=[c[0] for c in _unsharded_cases()])
def test_the_sharded_decode_is_the_unsharded_decode(worlds, case):
    """The last step's logits and the whole cache, gathered, against the
    port's own prefill and steps in one process."""
    _, ranks = worlds
    u = ranks[0]["cases"][case[0]]["unsharded"]
    _hold(u["sharded"]["logits"], u["logits"], case, "logits")
    for path, want in u["cache"].items():
        _hold(u["sharded"]["cache"][path], want, case, path)


@pytest.mark.parametrize("case", W.CASES, ids=CASE_IDS)
def test_a_neighbours_k_shard_fails_the_hold(worlds, case):
    """The first step from a cache whose rank 1 holds rank 0's k shards:
    the k leaves leave the tolerance, and so do the logits in f32 (at
    random init one token's attention over near-uniform scores moves bf16
    logits by ~1.5e-2 only, inside bf16's bound)."""
    ref, ranks = worlds
    want = ref[case[0]]["programs"]["step 0"]
    diff = norm = 0.0
    for r, got in enumerate(ranks):
        mine = got["cases"][case[0]]["control"]
        diff += float(np.sum((mine["logits"] - want["logits"][""][r]).astype(np.float64) ** 2))
        norm += float(np.sum(want["logits"][""][r].astype(np.float64) ** 2))
    logits = (diff / norm) ** 0.5
    if not _bf16(case):
        assert logits > F32["rtol"] * 100, logits
    k_paths = [p for p in want["cache"] if p.endswith("/k")]
    g = ranks[1]["cases"][case[0]]["control"]["cache"]
    for path in k_paths:
        gap = _rel(g[path][0], want["cache"][path][1][0])
        assert gap > (BF16_REL if _bf16(case) else F32["rtol"]) * 10, (path, gap)


@pytest.mark.parametrize("case", W.CASES, ids=CASE_IDS)
def test_a_decode_step_gathers_no_cache(worlds, case):
    """Every tensor a decode step hands a collective (the embedding's and
    the projections' sums, an FSDP weight's gather, the resident body's
    tokens) is smaller than one layer's local k shard."""
    _, ranks = worlds
    for got in ranks:
        mine = got["cases"][case[0]]
        for calls, largest in mine["collectives_a_step"]:
            assert calls > 0 and largest < mine["k_layer_local_bytes"], \
                (calls, largest, mine["k_layer_local_bytes"])


WRITES = [f"{kind}, {how}" for kind in ("plain", "int8")
          for how in ("new placed alike", "new placed replicated", "through the layer view")]


@pytest.mark.parametrize("what", WRITES)
def test_the_write_lands_in_each_ranks_local_shard(worlds, what):
    """``update_cache`` on a cache split on batch and KV heads: the slot
    holds the new values (gathered, against the plain write), each leaf's
    local storage and placements are kept, and the write issues no
    collective; through ``lm._layer``'s view the stacked cache's layer is
    written and the other left as it was."""
    _, ranks = worlds
    for got in ranks:
        check = got["write_checks"][what]
        assert check["equal"] and check["storage_kept"], check
        assert check.get("collectives", 0) == 0, check


@pytest.mark.parametrize("how", ["slots", "head dim", "unlike"])
def test_the_decode_attention_refuses_what_it_would_gather(worlds, how):
    """k and v split on the slots (a sequence-sharded cache) or the head dim
    (the GQA fallback), or unlike each other: ``attention_reference`` on
    DTensors raises naming ROADMAP row 9b-v rather than move the cache."""
    _, ranks = worlds
    for got in ranks:
        err = got["write_checks"][f"attention, k and v split on the {how}"]
        assert err is not None and err.startswith("NotImplementedError"), err
        assert "row 9b-v" in err, err


def test_a_replicated_position_is_read_with_no_collective(worlds):
    _, ranks = worlds
    for got in ranks:
        assert got["write_checks"]["int(pos)"] == {"value": 17, "collectives": 0}


def test_a_sequence_sharded_cache_is_refused_before_any_write(worlds):
    """Batch 2 on 4 x 1 does not fill "data": the rules shard the cache's
    sequence over it (``cache_seq``), and the step raises before writing."""
    _, ranks = worlds
    for got in ranks:
        row = got["refused"]
        assert row["rules"] == {"act_batch": None, "kvheads": None, "cache_seq": "data"}, row
        assert all("Shard(dim=2)" in p for p in row["placements"]), row["placements"]
        assert row["error"] is not None and row["error"].startswith("NotImplementedError"), row
        assert "a decode write into cache leaf" in row["error"], row["error"]   # the write's own
        assert "row 9b-v" in row["error"], row["error"]
        assert row["cache_unchanged"], row


class FakeMesh:
    """Just enough mesh for the rules (no devices touched)."""

    def __init__(self, shape):
        self.axis_names = ("data", "model")
        self.devices = np.empty(shape)


RULE_CASES = [(arch, shape, batch) for arch in ("qwen1.5-0.5b", "olmoe-1b-7b")
              for shape in ((2, 2), (1, 4), (4, 1)) for batch in (8, 2)]


def _axes_leaves(tree):
    """The axis tuples of an axes tree, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _axes_leaves(tree[k])]
    if isinstance(tree, tuple) and all(a is None or isinstance(a, str) for a in tree):
        return [tree]
    return [a for t in tree for a in _axes_leaves(t)]


def _rules_and_specs(arch, shape, batch):
    from repro.configs.base import InputShape as RefShape
    from repro.configs.registry import get_config as ref_get_config
    from repro.dist import sharding as R
    from repro.models.registry import model_fns as ref_model_fns
    from repro.models.registry import shapes_and_axes as ref_shapes_and_axes
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.dist import sharding as S
    from repro_torch.models.registry import decode_cache_len, model_fns, shapes_and_axes

    mesh, n = FakeMesh(shape), decode_cache_len(W.SEQ)
    ref_cfg, cfg = ref_get_config(arch, reduced=True), get_config(arch, reduced=True)
    ref_rules = R.default_rules(ref_cfg, mesh, RefShape("d", W.SEQ, batch, "decode"))
    rules = S.default_rules(cfg, mesh, InputShape("d", W.SEQ, batch, "decode"))
    _, ref_axes = ref_shapes_and_axes(lambda: ref_model_fns(ref_cfg).make_cache(batch, n))
    _, axes = shapes_and_axes(model_fns(cfg).make_cache, batch, n)
    ref_specs = [tuple(R.spec_for(ax, ref_rules)) for ax in _axes_leaves(ref_axes)]
    specs = [tuple(S.spec_for(ax, rules)) for ax in _axes_leaves(axes)]
    return (ref_rules, rules), (ref_specs, specs)


@pytest.mark.parametrize("arch,shape,batch", RULE_CASES)
def test_decode_rules_match_the_reference(arch, shape, batch):
    """The whole rule dict, ``act_batch``, ``kvheads`` and ``cache_seq``
    among it: a batch that does not fill "data" shards the cache's
    sequence over it."""
    (ref_rules, rules), _ = _rules_and_specs(arch, shape, batch)
    assert rules == ref_rules
    fills = shape[0] == 1 or batch % shape[0] == 0
    assert rules["cache_seq"] == (None if fills else "data")
    assert rules["act_batch"] == ("data" if shape[0] > 1 and fills else None)


@pytest.mark.parametrize("arch,shape,batch", RULE_CASES)
def test_decode_cache_specs_match_the_reference(arch, shape, batch):
    """Every cache leaf's spec under the decode rules, entry for entry."""
    _, (ref_specs, specs) = _rules_and_specs(arch, shape, batch)
    assert specs == ref_specs and len(specs) == 2
