"""The port's LM serving path against the reference's, on the CPU.

Configs equal field for field; the reference's weights bridged into the
port; ``lm_prefill`` with ``attn_impl``, ``ssm_impl`` and ``rglru_impl`` set
to ``"pallas"`` (the reference's Pallas kernels interpreted on the CPU, the
port's plain versions) on last-token logits and every cache leaf; greedy
decode steps on tokens and logits; the checkpoint keys of params and
caches; the layers the path runs; and the serve entry point end to end.
The dense family (qwen, gemma3), the moe family (olmoe), the ssm family
(mamba2), the hybrid family (recurrentgemma) and the vlm family
(internvl2, a prefix of patch embeddings); the encoder-decoder is held in
``tests/test_torch_encdec.py``.  Tolerances are the reference's: f32 2e-5, bf16
compute 2e-2."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _flatten
from repro.configs import registry as ref_registry
from repro.models import layers as ref_L
from repro.models import lm as ref_lm
from repro.models.registry import make_serve_step as ref_make_serve_step
from repro_torch.bridge import flatten, params_from_numpy
from repro_torch.configs import registry
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.grouped_matmul import ops as gmm_ops
from repro_torch.kernels.rglru_scan import ops as lru_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch.serve import serve
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.registry import make_serve_step, model_fns

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)

# (arch, overrides, tolerance): qwen in f32, in bf16 compute and with an
# int8 KV cache; gemma3 with a window of 8, GQA 4:2, ring caches and groups
# of two specs; mamba2 (SSD chunk 16 against a prompt of 24: a ragged tail)
# in f32 and bf16 compute; recurrentgemma (RG-LRU, RG-LRU, MQA local
# attention with a window of 8 and a ring cache); olmoe (8 experts, top 2,
# every expert product through the grouped matmul's "pallas" route) in f32
# and bf16 compute; internvl2 (GQA 4:2, 4 patch embeddings through vis_proj
# in front of the prompt, decode from PROMPT + 4) in f32 and bf16 compute
CASES = {
    "qwen-f32": ("qwen1.5-0.5b", {}, F32),
    "qwen-bf16": ("qwen1.5-0.5b", {"compute_dtype": "bfloat16"}, BF16),
    "qwen-int8kv": ("qwen1.5-0.5b", {"kv_cache_quant": True}, F32),
    "gemma3": ("gemma3-27b", {}, F32),
    "mamba2": ("mamba2-1.3b", {}, F32),
    "mamba2-bf16": ("mamba2-1.3b", {"compute_dtype": "bfloat16"}, BF16),
    "recurrentgemma": ("recurrentgemma-9b", {}, F32),
    "olmoe": ("olmoe-1b-7b", {}, F32),
    "olmoe-bf16": ("olmoe-1b-7b", {"compute_dtype": "bfloat16"}, BF16),
    "internvl2": ("internvl2-26b", {}, F32),
    "internvl2-bf16": ("internvl2-26b", {"compute_dtype": "bfloat16"}, BF16),
}
KERNEL_ROUTES = dict(attn_impl="pallas", ssm_impl="pallas", rglru_impl="pallas",
                     moe_gmm_impl="pallas")
PROMPT, STEPS = 24, 8


def _cfgs(arch, overrides):
    over = dict(overrides, **KERNEL_ROUTES)
    return (ref_registry.get_config(arch, reduced=True).replace(**over),
            registry.get_config(arch, reduced=True).replace(**over))


def _params(ref_cfg, seed=0):
    """The reference's weights, randomized further so biases and norm scales
    are not all zeros and ones, as numpy and as the port's tensors."""
    params, _ = ref_lm.init_lm(jax.random.PRNGKey(seed), ref_cfg)
    rng = np.random.default_rng(seed)
    host = jax.tree.map(np.asarray, jax.device_get(params))
    host = jax.tree.map(lambda a: a + rng.normal(scale=0.02, size=a.shape).astype(a.dtype)
                        if a.ndim <= 3 and "float" in a.dtype.name else a, host)
    return host, params_from_numpy(host, "cpu")


def _close(got: torch.Tensor, want, tol, what):
    want = np.asarray(want)
    if want.dtype == np.int8:   # int8 cache values: the same rounding on both sides
        np.testing.assert_array_equal(got.numpy(), want, err_msg=what)
        return
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), **tol,
                               err_msg=what)


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("reduced", [False, True])
def test_configs_equal_the_reference_field_for_field(reduced):
    assert set(registry.ARCH_IDS) == set(ref_registry.ARCH_IDS)
    for arch in ref_registry.ARCH_IDS:
        want = ref_registry.get_config(arch, reduced=reduced)
        got = registry.get_config(arch, reduced=reduced)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), arch
        assert got.param_count() == want.param_count(), arch


# ---------------------------------------------------------------- init


@pytest.mark.parametrize("case", ["qwen-f32", "gemma3", "mamba2", "recurrentgemma", "olmoe",
                                  "internvl2"])
def test_init_keeps_the_reference_tree_shapes_dtypes_and_axes(case):
    arch, over, _ = CASES[case]
    ref_cfg, cfg = _cfgs(arch, over)
    ref_params, ref_axes = ref_lm.init_lm(jax.random.PRNGKey(0), ref_cfg)
    params, axes = lm.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    want, got = _flatten(ref_params), flatten(params)
    assert list(got) == list(want)
    for key in want:
        assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype, key
    assert axes == ref_axes
    # the init laws: std 0.02, output projections 0.02/√(2·layers), zero biases
    emb = params["tok"]["embedding"]
    assert abs(float(emb.std()) - 0.02) < 2e-3
    wo = params["groups"]["g0"]["p0"]["mixer"]["wo"]
    assert abs(float(wo.std()) - 0.02 / np.sqrt(2.0 * cfg.total_layers)) < 2e-3


# ---------------------------------------------------------------- prefill / decode


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_greedy_decode_match_the_reference(case):
    arch, over, tol = CASES[case]
    ref_cfg, cfg = _cfgs(arch, over)
    host, params = _params(ref_cfg)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    # a VLM's patch embeddings go in front of the prompt, and decode follows them
    nv = cfg.n_vision_tokens
    patches = rng.normal(size=(2, nv, cfg.d_model)).astype(np.float32) if nv else None
    start = PROMPT + nv
    cache_len = start + STEPS + 1

    want_logits, want_cache = ref_lm.lm_prefill(
        jax.tree.map(jnp.asarray, host), jnp.asarray(tokens), ref_cfg, cache_len=cache_len,
        prefix_embeds=None if patches is None else jnp.asarray(patches))
    with torch.no_grad():
        logits, cache = lm.lm_prefill(
            params, torch.from_numpy(tokens).long(), cfg, cache_len=cache_len,
            prefix_embeds=None if patches is None else torch.from_numpy(patches))
    _close(logits, want_logits, tol, "prefill logits")
    want_flat, got_flat = _flatten(want_cache), flatten(cache)
    assert list(got_flat) == list(want_flat)
    for key in want_flat:
        _close(torch.from_numpy(got_flat[key]), want_flat[key], tol, f"prefill cache {key}")

    # greedy decode, each side on its own tokens; where the reference's best
    # two logits are closer than the tolerance, both sides take its token
    ref_step = jax.jit(ref_make_serve_step(ref_cfg))
    step = make_serve_step(cfg)
    ref_cache, ref_params = want_cache, jax.tree.map(jnp.asarray, host)
    want_tok = np.asarray(jnp.argmax(want_logits, -1))
    tok = torch.argmax(logits, -1)
    for i in range(STEPS):
        top2 = np.sort(np.asarray(want_logits, np.float32), -1)[:, -2:]
        near_tie = (top2[:, 1] - top2[:, 0]) <= 2 * tol["atol"]
        assert np.array_equal(tok.numpy()[~near_tie], want_tok[~near_tie]), (case, i)
        tok = torch.from_numpy(want_tok.astype(np.int64))
        want_logits, ref_cache = ref_step(ref_params, ref_cache,
                                          {"token": jnp.asarray(want_tok), "pos": start + i})
        with torch.no_grad():
            logits, cache = step(params, cache, {"token": tok, "pos": start + i})
        _close(logits, want_logits, tol, f"decode step {i} logits")
        want_tok = np.asarray(jnp.argmax(want_logits, -1))
        tok = torch.argmax(logits, -1)
    for key, want in _flatten(ref_cache).items():
        _close(torch.from_numpy(flatten(cache)[key]), want, tol, f"decode cache {key}")


def test_prefill_runs_the_flash_attention_route_once_per_layer(monkeypatch):
    _, cfg = _cfgs("gemma3-27b", {})
    calls = []
    real = fa_ops.flash_attention

    def spy(q, k, v, *a, **kw):
        calls.append(kw.get("window"))
        return real(q, k, v, *a, **kw)

    monkeypatch.setattr(fa_ops, "flash_attention", spy)
    params, _ = lm.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    with torch.no_grad():
        lm.lm_prefill(params, torch.zeros((1, 16), dtype=torch.long), cfg, cache_len=20)
    assert calls == [8, None, 8, None]   # (local, global) x 2, in layer order


# ---------------------------------------------------------------- keys


def test_flatten_keys_equal_the_checkpoint_keys_for_params_and_caches():
    ref_cfg, cfg = _cfgs("gemma3-27b", {"kv_cache_quant": True})
    ref_params, _ = ref_lm.init_lm(jax.random.PRNGKey(0), ref_cfg)
    ref_cache, _ = ref_lm.make_lm_cache(ref_cfg, 2, 20)
    params, _ = lm.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    cache, _ = model_fns(cfg).make_cache(2, 20, device="cpu")
    for want, got in ((_flatten(ref_params), flatten(params)),
                      (_flatten(ref_cache), flatten(cache))):
        assert list(got) == list(want)
        for key in want:
            assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype, key
    # the bridge gives the port the reference's weights exactly
    bridged = flatten(params_from_numpy(jax.device_get(ref_params), "cpu"))
    for key, want in _flatten(ref_params).items():
        np.testing.assert_array_equal(bridged[key], want)


def _check_bridged_leaves(arch, leaves):
    ref_cfg, cfg = _cfgs(arch, {})
    ref_params, _ = ref_lm.init_lm(jax.random.PRNGKey(0), ref_cfg)
    ref_cache, _ = ref_lm.make_lm_cache(ref_cfg, 2, 20)
    params, _ = lm.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    cache, _ = model_fns(cfg).make_cache(2, 20, device="cpu")
    assert leaves <= {key.split("/")[-1] for key in _flatten(ref_params)}
    for want, got in ((_flatten(ref_params), flatten(params)),
                      (_flatten(ref_cache), flatten(cache))):
        assert list(got) == list(want)
        for key in want:
            assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype, key
    bridged = flatten(params_from_numpy(jax.device_get(ref_params), "cpu"))
    for key, want in _flatten(ref_params).items():
        np.testing.assert_array_equal(bridged[key], want)
    return _flatten(ref_params)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_bridge_carries_the_recurrent_leaves_under_checkpoint_keys(arch):
    """The recurrent mixers' own leaves (``a_log``, ``dt_bias``, ``d_skip``,
    ``conv_*``; ``lam``, ``ba``, ``bi``, ``conv``) and caches (``conv``,
    ``ssm``; ``conv``, ``h``) keep the checkpoint's keys, shapes and dtypes,
    and the bridge carries the reference's weights exactly."""
    _check_bridged_leaves(arch, {"a_log", "dt_bias", "d_skip", "conv_x", "conv_b", "conv_c"}
                          if arch.startswith("mamba2") else {"lam", "ba", "bi", "conv"})


def test_bridge_carries_the_moe_leaves_under_checkpoint_keys():
    """The MoE FFN's leaves (``router`` in f32; ``wg``, ``wu`` (L, E, d, f) and
    ``wd`` (L, E, f, d) in the param dtype) keep the checkpoint's keys, shapes
    and dtypes, and the bridge carries the reference's weights exactly."""
    flat = _check_bridged_leaves("olmoe-1b-7b", {"router", "wg", "wu", "wd"})
    cfg = registry.get_config("olmoe-1b-7b", reduced=True)
    layers, e, d, f = cfg.total_layers, cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    ffn = "groups/g0/p0/ffn/"
    assert flat[ffn + "router"].shape == (layers, d, e) and flat[ffn + "router"].dtype == np.float32
    assert flat[ffn + "wg"].shape == flat[ffn + "wu"].shape == (layers, e, d, f)
    assert flat[ffn + "wd"].shape == (layers, e, f, d)


def test_serve_sends_every_moe_product_down_the_gmm_route(monkeypatch):
    """``serve`` runs each MoE layer's three expert products through the
    grouped matmul's kernel route (``moe_gmm_impl="pallas"``) whatever the
    config says, in the prefill and in every decode step."""
    calls = []
    real = gmm_ops.grouped_matmul

    def spy(x, w, gs):
        calls.append(int(gs.sum()))
        return real(x, w, gs)

    monkeypatch.setattr(gmm_ops, "grouped_matmul", spy)
    cfg = registry.get_config("olmoe-1b-7b", reduced=True).replace(moe_gmm_impl="dense")
    out = serve(cfg, batch=2, prompt_len=12, decode_steps=3, device="cpu", log=lambda *a: None)
    assert out["tokens"].shape == (2, 4)
    layers, k = cfg.total_layers, cfg.top_k
    assert calls == [2 * 12 * k] * 3 * layers + [2 * k] * 3 * layers * 3


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_serve_sends_every_prefill_scan_down_the_kernel_route(arch, monkeypatch):
    """``serve`` runs each recurrent layer's prefill scan with ``impl="pallas"``
    whatever the config says, once a layer, and steps decode in plain torch."""
    calls = []
    for mod, name in ((ssd_ops, "ssd"), (lru_ops, "rglru_scan")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append((_name, kw.get("impl")))
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    cfg = registry.get_config(arch, reduced=True)
    assert (cfg.ssm_impl, cfg.rglru_impl) == ("chunked", "associative")
    out = serve(cfg, batch=2, prompt_len=12, decode_steps=3, device="cpu", log=lambda *a: None)
    assert out["tokens"].shape == (2, 4)
    n_scans = sum(spec.mixer in ("mamba2", "rglru") for g in cfg.groups for spec in g.pattern
                  for _ in range(g.repeat))
    name = "ssd" if arch.startswith("mamba2") else "rglru_scan"
    assert calls == [(name, "pallas")] * n_scans


# ---------------------------------------------------------------- layers


def test_attention_impls_match_the_reference_with_cache_positions():
    """reference and chunked attention with invalid slots (-1), a ring of
    positions, a window and GQA, against the reference's layers."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 5, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, 11, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 11, 2, 8)).astype(np.float32)
    qpos = np.broadcast_to(np.arange(14, 19), (2, 5)).astype(np.int32)
    kpos = np.broadcast_to(np.array([11, 12, 13, 14, 15, 16, 17, 18, 8, 9, -1]), (2, 11))
    kpos = kpos.astype(np.int32)
    args_j = [jnp.asarray(a) for a in (q, k, v, qpos, kpos)]
    args_t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (q, k, v, qpos, kpos)]
    for window in (None, 6):
        want = ref_L.attention_reference(*args_j, window=window)
        got = L.attention_reference(*args_t, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        want = ref_L.attention_chunked(*args_j, window=window, chunk=4)
        got = L.attention_chunked(*args_t, window=window, chunk=4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("ring", [False, True])
def test_cache_helpers_match_the_reference(ring):
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(2, 13, 2, 8)) * 3).astype(np.float32)
    for pos in (0, 5, 12, 30):
        np.testing.assert_array_equal(L.cache_positions(8, pos, ring).numpy(),
                                      np.asarray(ref_L.cache_positions(8, jnp.int32(pos), ring)))
    size = 8 if ring else 16
    for quantized in (False, True):
        want = ref_L.prefill_cache_from_kv(jnp.asarray(x), jnp.asarray(x), size, ring=ring,
                                           quantized=quantized)
        got = L.prefill_cache_from_kv(torch.from_numpy(x), torch.from_numpy(x), size,
                                      ring=ring, quantized=quantized)
        for key in want:
            np.testing.assert_array_equal(flatten(got)[key], _flatten(want)[key])
    kq, ks = L.quantize_kv(torch.from_numpy(x))
    np.testing.assert_allclose(L.dequantize_kv(kq, ks).numpy(), x, atol=float(np.abs(x).max()) / 100)


# ---------------------------------------------------------------- serve


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "whisper-base", "internvl2-26b"])
def test_serve_runs_end_to_end_on_the_cpu(arch):
    lines = []
    cfg = registry.get_config(arch, reduced=True)
    out = serve(cfg, batch=2, prompt_len=16, decode_steps=4, device="cpu",
                log=lambda *a: lines.append(" ".join(map(str, a))))
    assert out["tokens"].shape == (2, 5) and out["tokens"].dtype == torch.int64
    assert int(out["tokens"].min()) >= 0 and int(out["tokens"].max()) < 512
    assert all(torch.isfinite(lg.float()).all() for lg in out["logits"])
    assert [line.split(":")[0] for line in lines] == ["prefill", "decode", "sample token ids"]
    assert lines[0].startswith("prefill: 2×16 tokens in ")
    assert lines[1].startswith("decode: 4 steps × batch 2 in ")
    # greedy: each generated token is the argmax of its step's logits
    for i, lg in enumerate(out["logits"]):
        assert torch.equal(torch.argmax(lg, -1), out["tokens"][:, i])
    # the stubs the model takes, f32 normals, returned for the twins
    frames, patches = out["frames"], out["patch_embeds"]
    assert (frames is not None) == cfg.is_encdec
    assert (patches is not None) == bool(cfg.n_vision_tokens)
    if frames is not None:
        assert frames.shape == (2, 16, cfg.d_model) and frames.dtype == torch.float32
    if patches is not None:
        assert patches.shape == (2, cfg.n_vision_tokens, cfg.d_model)
        assert patches.dtype == torch.float32


def test_serve_decodes_a_vlm_after_its_prefix_in_a_cache_that_holds_it(monkeypatch):
    """``serve`` decodes a VLM from position ``prompt_len + n_vision_tokens``
    and sizes its caches to hold the prefix, the prompt and every step (the
    reference sizes them without the prefix: a reference defect)."""
    seen = []
    real = lm.lm_decode_step

    def spy(params, cache, token, pos, cfg):
        seen.append((pos, cache["g0"][0]["kv"]["k"].shape[2]))
        return real(params, cache, token, pos, cfg)

    monkeypatch.setattr(lm, "lm_decode_step", spy)
    cfg = registry.get_config("internvl2-26b", reduced=True)
    serve(cfg, batch=2, prompt_len=16, decode_steps=3, device="cpu", log=lambda *a: None)
    n = 16 + cfg.n_vision_tokens
    assert seen == [(n + i, n + 3 + 1) for i in range(3)]
