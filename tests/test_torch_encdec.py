"""The port's encoder-decoder (whisper) against the reference's, on the CPU.

The reference's weights bridged into the port; the reference with
``attn_impl="pallas"`` (its flash kernel interpreted on the CPU), the port
on its plain versions.  The init tree, ``encode``, prefill and greedy
decode on last-token logits and every cache leaf (``kv`` and ``cross``),
the sinusoid tables, the routes the prefill's attentions take, and the
checkpoint keys of the params and caches.  Tolerances are the reference's:
f32 2e-5, bf16 compute 2e-2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _flatten
from repro.configs import registry as ref_registry
from repro.models import encdec as ref_ed
from repro.models import layers as ref_L
from repro.models.registry import make_serve_step as ref_make_serve_step
from repro.models.registry import model_fns as ref_model_fns
from repro_torch.bridge import flatten, params_from_numpy
from repro_torch.configs import registry
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import encdec
from repro_torch.models import layers as L
from repro_torch.models.registry import WHISPER_ENC_LEN, make_serve_step, model_fns

ARCH = "whisper-base"
F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
SIN = dict(rtol=2e-6, atol=2e-6)
PROMPT, FRAMES, STEPS = 24, 40, 8


def _cfgs(**over):
    over = dict(over, attn_impl="pallas")
    return (ref_registry.get_config(ARCH, reduced=True).replace(**over),
            registry.get_config(ARCH, reduced=True).replace(**over))


def _params(ref_cfg, seed=0):
    """The reference's weights, randomized further so biases and norm scales
    are not all zeros and ones, as numpy and as the port's tensors."""
    params, _ = ref_ed.init_encdec(jax.random.PRNGKey(seed), ref_cfg)
    rng = np.random.default_rng(seed)
    host = jax.tree.map(np.asarray, jax.device_get(params))
    host = jax.tree.map(lambda a: a + rng.normal(scale=0.02, size=a.shape).astype(a.dtype)
                        if a.ndim <= 3 else a, host)
    return host, params_from_numpy(host, "cpu")


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    frames = rng.normal(size=(2, FRAMES, cfg.d_model)).astype(np.float32)
    return tokens, frames


def _close(got: torch.Tensor, want, tol, what):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want).astype(np.float32), **tol,
                               err_msg=what)


def test_init_keeps_the_reference_tree_shapes_dtypes_and_axes():
    ref_cfg, cfg = _cfgs()
    ref_params, ref_axes = ref_ed.init_encdec(jax.random.PRNGKey(0), ref_cfg)
    params, axes = encdec.init_encdec(torch.Generator().manual_seed(0), cfg, device="cpu")
    want, got = _flatten(ref_params), flatten(params)
    assert list(got) == list(want)
    for key in want:
        assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype, key
    assert axes == ref_axes
    enc = params["enc"]["blocks"]
    assert enc["mixer"]["wq"].shape[0] == cfg.n_enc_layers and "cross" not in enc
    assert abs(float(enc["mixer"]["wq"].std()) - 0.02) < 2e-3


@pytest.mark.parametrize("d", [64, 512])
def test_sinusoids_match_the_reference(d):
    """Within 2e-6 where a position is below 16.  Beyond, the angle p·scale
    carries the f32 rounding of ``exp`` in the scale: XLA's and torch's
    ``exp`` differ by one ulp on some of the same f32 arguments (5 of 32 at
    d = 64, 25 of 256 at d = 512), so a row at position p is held within
    2e-6 + p·2^-22, two ulps of the scale times p."""
    for seq in (1, 16):
        _close(L.sinusoidal_positions(seq, d), ref_L.sinusoidal_positions(seq, d), SIN,
               f"table S={seq}")
    pos = np.array([0, 1, 7, 15, 23, 24, 31, 1499, 2080], dtype=np.int32)
    tol = 2e-6 + pos[:, None] * 2.0 ** -22
    got = L.sinusoid_at(torch.from_numpy(pos), d, torch.float32).numpy()
    want = np.asarray(ref_ed._sinusoid_at(jnp.asarray(pos), d, jnp.float32))
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()
    rows = np.arange(1500)[:, None]
    got = L.sinusoidal_positions(1500, d).numpy()
    assert (np.abs(got - np.asarray(ref_L.sinusoidal_positions(1500, d)))
            <= 2e-6 + rows * 2.0 ** -22).all()
    np.testing.assert_array_equal(got[pos[:-1]], L.sinusoid_at(
        torch.from_numpy(pos[:-1]), d).numpy())
    got = L.sinusoidal_positions(16, d, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _close(got, ref_L.sinusoidal_positions(16, d, jnp.bfloat16), SIN, "bf16 table")


def test_encode_matches_the_reference():
    ref_cfg, cfg = _cfgs()
    host, params = _params(ref_cfg)
    _, frames = _inputs(cfg)
    want = ref_ed.encode(jax.tree.map(jnp.asarray, host), jnp.asarray(frames), ref_cfg)
    with torch.no_grad():
        got = encdec.encode(params, torch.from_numpy(frames), cfg)
    assert got.shape == (2, FRAMES, cfg.d_model) and got.dtype == torch.float32
    _close(got, want, F32, "encoder output")


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_prefill_and_greedy_decode_match_the_reference(compute_dtype):
    tol = F32 if compute_dtype == "float32" else BF16
    ref_cfg, cfg = _cfgs(compute_dtype=compute_dtype)
    host, params = _params(ref_cfg)
    tokens, frames = _inputs(cfg)
    cache_len = PROMPT + STEPS + 1
    batch = {"tokens": tokens, "frames": frames, "cache_len": cache_len}
    ref_params = jax.tree.map(jnp.asarray, host)
    want_logits, want_cache = ref_model_fns(ref_cfg).prefill(
        ref_params, {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                     for k, v in batch.items()})
    with torch.no_grad():
        logits, cache = model_fns(cfg).prefill(params, {
            "tokens": torch.from_numpy(tokens).long(), "frames": torch.from_numpy(frames),
            "cache_len": cache_len})
    _close(logits, want_logits, tol, "prefill logits")
    want_flat, got_flat = _flatten(want_cache), flatten(cache)
    assert list(got_flat) == list(want_flat)
    assert any(key.endswith("cross/k") for key in got_flat)
    for key in want_flat:
        assert got_flat[key].shape == want_flat[key].shape, key
        _close(torch.from_numpy(got_flat[key]), want_flat[key], tol, f"prefill cache {key}")

    # greedy decode, each side on its own tokens; where the reference's best
    # two logits are closer than the tolerance, both sides take its token
    ref_step = jax.jit(ref_make_serve_step(ref_cfg))
    step = make_serve_step(cfg)
    ref_cache = want_cache
    want_tok = np.asarray(jnp.argmax(want_logits, -1))
    tok = torch.argmax(logits, -1)
    for i in range(STEPS):
        top2 = np.sort(np.asarray(want_logits, np.float32), -1)[:, -2:]
        near_tie = (top2[:, 1] - top2[:, 0]) <= 2 * tol["atol"]
        assert np.array_equal(tok.numpy()[~near_tie], want_tok[~near_tie]), i
        tok = torch.from_numpy(want_tok.astype(np.int64))
        want_logits, ref_cache = ref_step(ref_params, ref_cache,
                                          {"token": jnp.asarray(want_tok),
                                           "pos": jnp.int32(PROMPT + i)})
        with torch.no_grad():
            logits, cache = step(params, cache, {"token": tok, "pos": PROMPT + i})
        _close(logits, want_logits, tol, f"decode step {i} logits")
        want_tok = np.asarray(jnp.argmax(want_logits, -1))
        tok = torch.argmax(logits, -1)
    for key, want in _flatten(ref_cache).items():
        _close(torch.from_numpy(flatten(cache)[key]), want, tol, f"decode cache {key}")


def test_prefill_sends_self_attention_to_flash_and_cross_attention_to_chunked(monkeypatch):
    """Every encoder self-attention goes through the flash route with
    ``causal=False`` and every decoder self-attention with ``causal=True``;
    each cross-attention goes through ``attention_chunked`` (the reference
    fixes ``impl="chunked"`` there), never through the kernel."""
    _, cfg = _cfgs()
    calls = []
    real_flash, real_chunked = fa_ops.flash_attention, L.attention_chunked

    def flash(q, k, v, *a, **kw):
        calls.append(("flash", kw["causal"]))
        return real_flash(q, k, v, *a, **kw)

    def chunked(q, k, v, *a, **kw):
        calls.append(("chunked", kw["causal"]))
        return real_chunked(q, k, v, *a, **kw)

    monkeypatch.setattr(fa_ops, "flash_attention", flash)
    monkeypatch.setattr(L, "attention_chunked", chunked)
    params, _ = encdec.init_encdec(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens, frames = _inputs(cfg)
    with torch.no_grad():
        model_fns(cfg).prefill(params, {"tokens": torch.from_numpy(tokens).long(),
                                        "frames": torch.from_numpy(frames)})
    assert calls == ([("flash", False)] * cfg.n_enc_layers
                     + [("flash", True), ("chunked", False)] * cfg.total_layers)


def test_bridge_carries_the_encoder_and_cross_leaves_under_checkpoint_keys():
    """``enc/blocks/...``, ``enc/norm``, ``groups/.../norm_c``,
    ``groups/.../cross/...`` and the ``cross`` cache leaves keep the
    checkpoint's keys, shapes and dtypes, and the bridge carries the
    reference's weights exactly."""
    ref_cfg, cfg = _cfgs()
    ref_params, _ = ref_ed.init_encdec(jax.random.PRNGKey(0), ref_cfg)
    ref_cache, ref_cache_axes = ref_model_fns(ref_cfg).make_cache(2, 20)
    cache, cache_axes = model_fns(cfg).make_cache(2, 20, device="cpu")
    want = _flatten(ref_params)
    for key in ("enc/blocks/mixer/wq", "enc/blocks/ffn/w1", "enc/norm/scale",
                "groups/g0/p0/norm_c/scale", "groups/g0/p0/cross/wk"):
        assert key in want, key
    bridged = flatten(params_from_numpy(jax.device_get(ref_params), "cpu"))
    assert list(bridged) == list(want)
    for key in want:
        np.testing.assert_array_equal(bridged[key], want[key])
    want_c, got_c = _flatten(ref_cache), flatten(cache)
    assert list(got_c) == list(want_c)
    for key in want_c:
        assert got_c[key].shape == want_c[key].shape and got_c[key].dtype == want_c[key].dtype
    assert got_c["g0/[0]/cross/k"].shape[2] == WHISPER_ENC_LEN
    assert cache_axes == ref_cache_axes
    # the cross cache is never quantized, as the reference's
    ref_q, _ = ref_model_fns(ref_cfg.replace(kv_cache_quant=True)).make_cache(2, 20)
    got_q, _ = model_fns(cfg.replace(kv_cache_quant=True)).make_cache(2, 20, device="cpu")
    assert list(flatten(got_q)) == list(_flatten(ref_q))
    assert flatten(got_q)["g0/[0]/cross/k"].dtype == np.float32


def test_training_and_input_specs_raise_naming_the_roadmap():
    """The loss is ported: ``fns.loss`` gives the reference's value (its
    gradients are held in tests/test_torch_train.py); ``input_specs`` still
    raises, naming the roadmap's row."""
    ref_cfg, cfg = _cfgs(attn_impl="chunked")
    host, params = _params(ref_cfg)
    tokens, frames = _inputs(cfg)
    want, want_m = ref_model_fns(ref_cfg).loss(jax.tree.map(jnp.asarray, host),
                                               {"frames": frames, "tokens": tokens})
    got, got_m = model_fns(cfg).loss(params, {"frames": torch.from_numpy(frames),
                                             "tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(got), float(want), **F32)
    for key in ("ce", "aux", "tokens"):
        np.testing.assert_allclose(float(got_m[key]), float(want_m[key]), **F32, err_msg=key)
    with pytest.raises(NotImplementedError, match="queue 1 row 9"):
        model_fns(cfg).input_specs(None)
