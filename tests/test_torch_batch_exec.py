"""The port's BatchedExecutor against the reference's, on twin worlds (the
same shards and shuffle seeds built once per package) and bridged params.

* ragged waves against the reference's ``gmm_impl="pallas"`` wave, within
  the reference's own ragged-vs-sequential bound (1e-5,
  tests/test_batch_exec.py:128);
* dense and seq waves and ``train_local`` against the reference's;
* the port's own invariants: zero-row clients, the envelope cache, the
  seq wave identical to ``train_local``;
* dense waves of the cnn, resnet, lstm and the MLP with its local tower
  (``torch.func.vmap`` of the step), ragged MLP waves under adamw and
  adafactor, and an adafactor wave against its clients trained one by one.
"""
import jax
import numpy as np
import pytest

from repro.ckpt.checkpoint import _flatten as ref_flatten
from repro.fed.batch_exec import BatchedExecutor as RefBatchedExecutor
from repro.fed.client import make_small_step as ref_make_small_step
from repro.models.small import init_small as ref_init_small
from repro.optim.optimizers import make_optimizer as ref_make_optimizer
from repro_torch.bridge import flatten, params_from_numpy
from repro_torch.fed.batch_exec import BatchedExecutor
from repro_torch.fed.client import make_small_step
from repro_torch.optim.optimizers import make_optimizer

from _torch_worlds import MCFG, REF_MCFG, kind_cfgs, max_tree_diff, twin_clients

LR = 0.1
OPT, REF_OPT = make_optimizer("sgd", LR), ref_make_optimizer("sgd", LR)


def _params(seed):
    ref = jax.device_get(ref_init_small(jax.random.PRNGKey(seed), REF_MCFG))
    return ref, params_from_numpy(ref, "cpu")


def _compare(ref_res, port_res, tol):
    assert len(ref_res) == len(port_res)
    for (rd, rn, rm), (pd, pn, pm) in zip(ref_res, port_res):
        assert float(rn) == pn
        assert max_tree_diff(flatten(pd), ref_flatten(rd)) < tol
        assert rm.keys() == pm.keys()
        for k in rm:
            assert pm[k] == pytest.approx(rm[k], abs=tol), k


def _wave_pair(batch_sizes, seed, steps, round_idx=0, prox_mu=0.0, **ref_kw):
    ref_cl, port_cl = twin_clients(batch_sizes, seed=seed)
    ref_p, port_p = _params(seed)
    ref_ex = RefBatchedExecutor(REF_MCFG, REF_OPT, prox_mu, **ref_kw)
    port_ex = BatchedExecutor(MCFG, OPT, prox_mu, device="cpu")
    ref_res = ref_ex.run_wave(ref_p, ref_cl, steps, round_idx=round_idx)
    port_res = port_ex.run_wave(port_p, port_cl, steps, round_idx=round_idx)
    return ref_ex, port_ex, ref_res, port_res


def test_ragged_wave_matches_reference_pallas_wave():
    ref_ex, port_ex, ref_res, port_res = _wave_pair(
        [2, 4, 6, 8], seed=7, steps=3, round_idx=1, gmm_impl="pallas")
    assert ref_ex.last_wave["mode"] == port_ex.last_wave["mode"] == "ragged"
    assert port_ex.stats.ragged_clients == 4
    _compare(ref_res, port_res, 1e-5)


def test_ragged_wave_with_prox_term_matches_reference():
    ref_ex, port_ex, ref_res, port_res = _wave_pair(
        [3, 5, 2], seed=8, steps=2, prox_mu=0.3)
    assert ref_ex.last_wave["mode"] == port_ex.last_wave["mode"] == "ragged"
    _compare(ref_res, port_res, 1e-5)


def test_dense_wave_matches_reference():
    ref_ex, port_ex, ref_res, port_res = _wave_pair([4] * 5, seed=5, steps=3,
                                                    round_idx=2)
    assert ref_ex.last_wave["mode"] == port_ex.last_wave["mode"] == "dense"
    assert port_ex.stats.dense_clients == 5
    _compare(ref_res, port_res, 1e-5)


def test_seq_wave_matches_reference_and_is_identical_to_train_local():
    ref_ex, port_ex, ref_res, port_res = _wave_pair([4], seed=3, steps=3)
    assert ref_ex.last_wave["mode"] == port_ex.last_wave["mode"] == "seq"
    assert port_ex.stats.seq_clients == 1
    _compare(ref_res, port_res, 1e-5)
    _, port_cl = twin_clients([4], seed=3)
    _, port_p = _params(3)
    own = port_cl[0].train_local(port_p, make_small_step(MCFG, OPT), OPT, n_steps=3)
    assert max_tree_diff(flatten(own[0]), flatten(port_res[0][0])) == 0.0
    assert own[2] == port_res[0][2]


@pytest.mark.parametrize("prox_mu", [0.0, 0.2])
def test_train_local_matches_reference(prox_mu):
    ref_cl, port_cl = twin_clients([5, 3], seed=11)
    ref_p, port_p = _params(11)
    ref_step = ref_make_small_step(REF_MCFG, REF_OPT, prox_mu)
    port_step = make_small_step(MCFG, OPT, prox_mu)
    for rc, pc in zip(ref_cl, port_cl):
        rd, rn, rm = rc.train_local(ref_p, ref_step, REF_OPT, n_steps=4)
        pd, pn, pm = pc.train_local(port_p, port_step, OPT, n_steps=4)
        assert rn == pn
        assert max_tree_diff(flatten(pd), ref_flatten(jax.device_get(rd))) < 1e-5
        for k in rm:
            assert pm[k] == pytest.approx(rm[k], abs=1e-5)


def test_ragged_zero_example_client_gets_exact_zero_delta():
    _, port_cl = twin_clients([4, 0, 6], seed=9)
    _, port_p = _params(9)
    ex = BatchedExecutor(MCFG, OPT, device="cpu")
    res = ex.run_wave(port_p, port_cl, 2)
    assert ex.last_wave["mode"] == "ragged"
    delta, n_seen, metrics = res[1]
    assert n_seen == 0
    assert all(v == 0.0 for v in metrics.values())
    assert all(not np.any(v) for v in flatten(delta).values())
    # the populated clients still match their sequential runs
    _, seq_cl = twin_clients([4, 0, 6], seed=9)
    step = make_small_step(MCFG, OPT)
    for i in (0, 2):
        d, n, _ = seq_cl[i].train_local(port_p, step, OPT, n_steps=2)
        assert n == res[i][1]
        assert max_tree_diff(flatten(d), flatten(res[i][0])) < 1e-5


def test_wave_program_cache_reused_across_row_splits():
    """Group sizes are device data, so two ragged waves with the same
    (clients, steps, rows, width) envelope but different per-client row
    splits share ONE wave program."""
    ex = BatchedExecutor(MCFG, OPT, device="cpu")
    _, cl = twin_clients([2, 4, 6, 8], seed=1)     # 20 rows/step
    _, params = _params(1)
    ex.run_wave(params, cl, 2)
    _, cl = twin_clients([8, 6, 4, 2], seed=2)     # same envelope, new split
    ex.run_wave(params, cl, 2)
    assert ex.stats.compiles == 1
    assert ex.stats.cache_hits == 1
    assert ex.last_wave["cache_hit"] is True


def test_empty_wave_returns_empty():
    ex = BatchedExecutor(MCFG, OPT, device="cpu")
    _, params = _params(0)
    assert ex.run_wave(params, [], 3) == []
    assert ex.stats.waves == 0


# ------------------------------ the other client models and optimizers -------


def _kind_wave_pair(kind, kw, batch_sizes, seed, steps, opt_name, lr=0.05, wd=0.0,
                    **ref_kw):
    ref_mcfg, mcfg = kind_cfgs(kind, **kw)
    ref_cl, port_cl = twin_clients(batch_sizes, seed=seed, mcfg=mcfg)
    ref_p = jax.device_get(ref_init_small(jax.random.PRNGKey(seed), ref_mcfg))
    ref_ex = RefBatchedExecutor(ref_mcfg, ref_make_optimizer(opt_name, lr, wd), **ref_kw)
    port_ex = BatchedExecutor(mcfg, make_optimizer(opt_name, lr, wd), device="cpu")
    ref_res = ref_ex.run_wave(ref_p, ref_cl, steps, round_idx=1)
    port_res = port_ex.run_wave(params_from_numpy(ref_p, "cpu"), port_cl, steps, round_idx=1)
    return ref_ex, port_ex, ref_res, port_res


DENSE_KINDS = [("cnn", {}, "sgd"), ("resnet", {}, "momentum"), ("lstm", {}, "sgd"),
               ("lstm", {}, "adafactor"), ("mlp", {"extra_local_model": True}, "momentum"),
               ("cnn", {"extra_local_model": True}, "sgd")]


@pytest.mark.parametrize("kind,kw,opt_name", DENSE_KINDS,
                         ids=[f"{k}{'+local' if kw else ''}-{o}" for k, kw, o in DENSE_KINDS])
def test_dense_wave_of_each_client_model_matches_reference(kind, kw, opt_name):
    """The vmapped dense program (``build_step_fn`` mapped over the client
    axis) against the reference's vmapped wave."""
    ref_ex, port_ex, ref_res, port_res = _kind_wave_pair(kind, kw, [4] * 3, seed=6, steps=3,
                                                         opt_name=opt_name)
    assert ref_ex.last_wave["mode"] == port_ex.last_wave["mode"] == "dense"
    assert port_ex.stats.dense_clients == 3
    _compare(ref_res, port_res, 1e-5)


@pytest.mark.parametrize("opt_name,wd", [("adamw", 0.01), ("adafactor", 0.0)])
def test_ragged_wave_with_other_optimizers_matches_reference(opt_name, wd):
    ref_ex, port_ex, ref_res, port_res = _kind_wave_pair(
        "mlp", {}, [2, 4, 6, 8], seed=7, steps=3, opt_name=opt_name, wd=wd, gmm_impl="pallas")
    assert ref_ex.last_wave["mode"] == port_ex.last_wave["mode"] == "ragged"
    _compare(ref_res, port_res, 1e-5)


@pytest.mark.parametrize("batch_sizes", [[4, 4, 4], [2, 4, 6]], ids=["dense", "ragged"])
def test_adafactor_wave_updates_each_client_alone(batch_sizes):
    """An adafactor wave against the same clients trained one by one.  The
    clients' inputs differ in scale by 400x, so their update RMS differ and
    an RMS clip shared over the client axis (the rule applied to the stacked
    tree) would move every client's delta."""
    scales = [0.05, 1.0, 20.0]
    opt = make_optimizer("adafactor", 0.5)
    _, port_cl = twin_clients(batch_sizes, seed=12, scales=scales)
    _, params = _params(12)
    ex = BatchedExecutor(MCFG, opt, device="cpu")
    res = ex.run_wave(params, port_cl, 3)
    assert ex.last_wave["mode"] == ("dense" if len(set(batch_sizes)) == 1 else "ragged")
    _, seq_cl = twin_clients(batch_sizes, seed=12, scales=scales)
    step = make_small_step(MCFG, opt)
    for i, c in enumerate(seq_cl):
        d, n, m = c.train_local(params, step, opt, n_steps=3)
        assert n == res[i][1]
        assert max_tree_diff(flatten(d), flatten(res[i][0])) < 1e-5
