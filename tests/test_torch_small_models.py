"""The paper's client models in the port against the reference, on bridged
parameters and identical numpy inputs: every kind (mlp, cnn, resnet, lstm)
with and without the local tower, and the cnn at 3 layers on 8x8 and 10x10
images (10 -> 5 -> 2 -> 1 floors an odd size): logits and loss within
2e-5, accuracy equal, grads within 1e-4; the init laws; the lstm's
out-of-range tokens (NaN) and negative tokens (wrapped), as ``jnp.take``
gives them.  The optimizers are in tests/test_torch_optimizers.py.
"""
import jax
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _flatten as ref_flatten
from repro.models import small as ref_small
from repro_torch.bridge import flatten, params_from_numpy
from repro_torch.models import small
from repro_torch.tree import tree_map

from _torch_worlds import kind_cfgs, max_tree_diff

TOL = dict(rtol=2e-5, atol=2e-5)

MODEL_CASES = [(kind, {"extra_local_model": extra})
               for kind in ("mlp", "cnn", "resnet", "lstm") for extra in (False, True)]
MODEL_CASES += [("cnn", {"n_layers": 3}), ("cnn", {"n_layers": 3, "image_size": 10})]


def _model_id(case):
    kind, kw = case
    return kind + "".join(f"-{k}={v}" for k, v in kw.items())


def _inputs(cfg, n=6, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.kind == "lstm":
        x = rng.integers(0, cfg.vocab_size, size=(n, cfg.seq_len)).astype(np.int32)
    else:
        x = rng.normal(size=(n, cfg.image_size, cfg.image_size, cfg.channels)).astype(np.float32)
    return x, rng.integers(0, cfg.n_classes, size=n).astype(np.int32)


def _ref_params(cfg, seed=0):
    return jax.device_get(ref_small.init_small(jax.random.PRNGKey(seed), cfg))


def _ref_loss_grads(ref_cfg, params, x, y):
    (loss, m), g = jax.value_and_grad(
        lambda p: ref_small.small_loss(p, ref_cfg, {"x": x, "y": y}), has_aux=True)(params)
    return loss, m, g


def _port_loss_grads(cfg, params, x, y):
    port = tree_map(lambda t: t.requires_grad_(), params_from_numpy(params, "cpu"))
    loss, m = small.small_loss(port, cfg, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    loss.backward()
    return loss, m, tree_map(lambda t: t.grad, port)


@pytest.mark.parametrize("case", MODEL_CASES, ids=_model_id)
def test_small_model_matches_reference(case):
    kind, kw = case
    ref_cfg, cfg = kind_cfgs(kind, **kw)
    params = _ref_params(ref_cfg, seed=1)
    x, y = _inputs(cfg)
    want_logits = np.asarray(ref_small.small_apply(params, ref_cfg, x))
    got_logits = small.small_apply(params_from_numpy(params, "cpu"), cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got_logits.detach().numpy(), want_logits, **TOL)

    loss, m, g = _ref_loss_grads(ref_cfg, params, x, y)
    loss_t, m_t, g_t = _port_loss_grads(cfg, params, x, y)
    np.testing.assert_allclose(loss_t.item(), float(loss), **TOL)
    np.testing.assert_allclose(m_t["ce"].item(), float(m["ce"]), **TOL)
    assert float(m_t["acc"]) == float(m["acc"])
    assert set(m_t) == set(m)
    assert max_tree_diff(flatten(g_t), ref_flatten(g)) < 1e-4
    if kw.get("extra_local_model"):
        # the local tower trains on its own CE: its grads are not zero
        assert any(np.abs(v).max() > 0 for k, v in flatten(g_t).items() if k.startswith("local"))


@pytest.mark.parametrize("case", MODEL_CASES[::2] + [("mlp", {"extra_local_model": True})],
                         ids=_model_id)
def test_init_small_follows_the_reference_init_laws(case):
    kind, kw = case
    ref_cfg, cfg = kind_cfgs(kind, **kw)
    want = ref_flatten(_ref_params(ref_cfg))
    got = flatten(small.init_small(3, cfg, device="cpu"))
    again = flatten(small.init_small(3, cfg, device="cpu"))
    assert list(got) == list(want)
    assert max_tree_diff(got, again) == 0.0  # seeded
    for k, a in want.items():
        b = got[k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k.endswith("/b"):
            assert not b.any(), k
        elif k.endswith("embed"):
            assert abs(float(b.std()) - 0.1) < 0.02, k
        else:   # uniform in ±1/√fan_in: dense (in, out), conv HWIO
            bound = 1.0 / np.sqrt(np.prod(a.shape[:-1]))
            assert bound >= np.abs(b).max() > 0.5 * bound, k
    if cfg.extra_local_model:
        # the local tower is a second draw: same shapes, other numbers
        for k in got:
            if k.startswith("main/") and not k.endswith("/b"):
                assert not np.array_equal(got[k], got["local/" + k[5:]]), k


def test_lstm_out_of_range_tokens_match_reference():
    """``jnp.take`` fills a token past the table with NaN and wraps a
    negative one once; the port's clamped gather and NaN mask do the same,
    where plain indexing would assert on the card."""
    ref_cfg, cfg = kind_cfgs("lstm")
    params = _ref_params(ref_cfg, seed=2)
    x, _ = _inputs(cfg, n=6, seed=3)
    v = cfg.vocab_size
    x[1, 2] = v            # one past the table: NaN
    x[2, 0] = v + 7        # NaN
    x[3, 4] = -1           # the last row
    x[4, 1] = -v           # row 0
    x[5, 3] = -v - 1       # past the wrap: NaN
    want = np.asarray(ref_small.small_apply(params, ref_cfg, x))
    got = small.small_apply(params_from_numpy(params, "cpu"), cfg, torch.from_numpy(x)).numpy()
    assert np.isnan(want[[1, 2, 5]]).all() and np.isfinite(want[[0, 3, 4]]).all()
    np.testing.assert_allclose(got, want, equal_nan=True, **TOL)
