"""The port's LM training against the reference's, on the CPU.

The reference's weights bridged into the port (randomized further so
biases and norm scales are not all zeros and ones); every config reduced,
in f32, on its own routes (``attn_impl="chunked"``, ``ssm_impl="chunked"``,
``rglru_impl="associative"``, ``moe_gmm_impl="ragged"``), as the
reference trains.  Held: the loss and every gradient leaf of
``jax.value_and_grad`` for each family (dense, moe, ssm, hybrid, vlm and
the encoder-decoder; loss 2e-5, grads 1e-4, the reference's tolerances),
``chunked_ce`` against the unchunked loss, remat ``full`` and ``dots``
against ``none``, one ``make_train_step`` step (adamw with clip, adafactor),
the token data bit for bit, and ``launch/train.py``'s rounds against the
reference's ``main`` (losses 1e-4 relative, ``comm_MB`` exact) with a
checkpoint resume.  Under ``attn_impl="pallas"`` (the reference's Pallas
forward interpreted, its custom VJP; the port's flash route, on the CPU its
plain version) the dense, moe, hybrid, vlm and encoder-decoder families'
loss and gradients too, at 128 positions (the Pallas kernel's row tile)."""
import contextlib
import functools
import io
import re
import shutil
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _flatten
from repro.configs import registry as ref_registry
from repro.data import pipeline as ref_pipeline
from repro.data import synthetic as ref_synthetic
from repro.launch import train as ref_train
from repro.models import lm as ref_lm
from repro.models.registry import make_train_step as ref_make_train_step
from repro.models.registry import model_fns as ref_model_fns
from repro_torch.bridge import flatten, params_from_numpy, params_to_numpy
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data.pipeline import TokenDataset
from repro_torch.data.synthetic import make_lm_tokens
from repro_torch.kernels.grouped_matmul import ops as gmm_ops
from repro_torch.launch import train as port_train
from repro_torch.models import lm
from repro_torch.models.registry import make_train_step, model_fns, value_and_grad

LOSS = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
SEQ, FRAMES = 24, 40

# the six families, and gemma3 (local/global pattern, window 8, GQA 4:2)
FAMILIES = {
    "dense": "qwen1.5-0.5b",
    "moe": "olmoe-1b-7b",
    "ssm": "mamba2-1.3b",
    "hybrid": "recurrentgemma-9b",
    "vlm": "internvl2-26b",
    "encdec": "whisper-base",
    "dense-local-global": "gemma3-27b",
}


def _cfgs(arch, **over):
    return (ref_registry.get_config(arch, reduced=True).replace(**over),
            registry.get_config(arch, reduced=True).replace(**over))


@functools.cache
def _arch_params(arch):
    fns = ref_model_fns(ref_registry.get_config(arch, reduced=True))
    host = jax.tree.map(np.asarray, jax.jit(lambda k: fns.init(k)[0])(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    return jax.tree.map(lambda a: a + rng.normal(scale=0.02, size=a.shape).astype(a.dtype), host)


def _host_params(ref_cfg):
    """The reference's init of ``ref_cfg``'s arch, randomized further (the
    same numpy tree for every test of an arch; nothing writes to it)."""
    return _arch_params(ref_cfg.name)


def _batch(cfg, b=2, seed=1, seq=SEQ, frames=FRAMES):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, seq)).astype(np.int32)}
    if cfg.n_vision_tokens:
        batch["patch_embeds"] = rng.normal(
            size=(b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        batch["frames"] = rng.normal(size=(b, frames, cfg.d_model)).astype(np.float32)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _ref_value_and_grad(ref_cfg, host, batch):
    fn = jax.jit(jax.value_and_grad(ref_model_fns(ref_cfg).loss, has_aux=True))
    (loss, metrics), grads = fn(jax.tree.map(jnp.asarray, host),
                                jax.tree.map(jnp.asarray, batch))
    return float(loss), jax.tree.map(np.asarray, metrics), _flatten(grads)


def _port_value_and_grad(cfg, host, batch):
    (loss, metrics), grads = value_and_grad(model_fns(cfg).loss, params_from_numpy(host, "cpu"),
                                            _torch(batch))
    return float(loss), metrics, flatten(grads)


def _assert_trees_close(got, want, tol, what):
    assert list(got) == list(want), what
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **tol, err_msg=f"{what}: {key}")


# ---------------------------------------------------------------- loss and grads


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_grads_match_the_reference(family):
    ref_cfg, cfg = _cfgs(FAMILIES[family])
    host, batch = _host_params(ref_cfg), _batch(cfg)
    want_loss, want_metrics, want = _ref_value_and_grad(ref_cfg, host, batch)
    got_loss, got_metrics, got = _port_value_and_grad(cfg, host, batch)
    np.testing.assert_allclose(got_loss, want_loss, **LOSS)
    for key in ("ce", "aux", "tokens"):
        np.testing.assert_allclose(float(got_metrics[key]), float(want_metrics[key]), **LOSS,
                                   err_msg=key)
    _assert_trees_close(got, want, GRAD, family)
    # every leaf gets a gradient; the loss reaches every leaf of these trees
    assert all(np.any(g != 0) for g in got.values()), [k for k, g in got.items() if not g.any()]


# the Pallas kernel's row tile: every attention of these batches spans 128
# positions (a VLM's patch prefix included; whisper's frames too)
PALLAS_POSITIONS = 128


@pytest.mark.parametrize("family", ["dense", "moe", "hybrid", "vlm", "encdec"])
def test_loss_and_grads_under_the_flash_route_match_the_reference(family):
    """``attn_impl="pallas"``: every self-attention through the flash route
    (the hybrid's windowed, the encoder's bidirectional); whisper's
    cross-attention stays on ``attention_chunked`` in both packages."""
    ref_cfg, cfg = _cfgs(FAMILIES[family], attn_impl="pallas")
    host = _host_params(ref_cfg)
    batch = _batch(cfg, seq=PALLAS_POSITIONS - cfg.n_vision_tokens, frames=PALLAS_POSITIONS)
    want_loss, _, want = _ref_value_and_grad(ref_cfg, host, batch)
    got_loss, _, got = _port_value_and_grad(cfg, host, batch)
    np.testing.assert_allclose(got_loss, want_loss, **LOSS)
    _assert_trees_close(got, want, GRAD, f"{family}, pallas")


@pytest.mark.parametrize("positions", [SEQ, PALLAS_POSITIONS])
def test_loss_and_grads_under_the_ssd_route_match_the_reference(positions):
    """``ssm_impl="pallas"``: mamba2's scan through the reference's custom
    VJP (its Pallas forward interpreted, the vjp of ``ssd_chunked``) and
    through the port's CPU route (``ssd_chunked`` with torch's autograd)."""
    ref_cfg, cfg = _cfgs(FAMILIES["ssm"], ssm_impl="pallas")
    host, batch = _host_params(ref_cfg), _batch(cfg, seq=positions)
    want_loss, _, want = _ref_value_and_grad(ref_cfg, host, batch)
    got_loss, _, got = _port_value_and_grad(cfg, host, batch)
    np.testing.assert_allclose(got_loss, want_loss, **LOSS)
    _assert_trees_close(got, want, GRAD, f"ssm, pallas, {positions} positions")


def test_a_vlm_without_its_prefix_gets_zero_vis_proj_grads():
    """jax.grad gives zeros for a leaf the loss does not reach; so must the port."""
    ref_cfg, cfg = _cfgs("internvl2-26b")
    host = _host_params(ref_cfg)
    batch = {"tokens": _batch(cfg)["tokens"]}
    want_loss, _, want = _ref_value_and_grad(ref_cfg, host, batch)
    got_loss, _, got = _port_value_and_grad(cfg, host, batch)
    np.testing.assert_allclose(got_loss, want_loss, **LOSS)
    _assert_trees_close(got, want, GRAD, "vlm without prefix")
    assert not got["vis_proj"].any()


def test_the_loss_mask_weighs_tokens_as_the_reference():
    ref_cfg, cfg = _cfgs("qwen1.5-0.5b")
    host, batch = _host_params(ref_cfg), _batch(cfg)
    batch["loss_mask"] = (np.random.default_rng(3).random((2, SEQ)) < 0.5).astype(np.float32)
    want_loss, want_metrics, want = _ref_value_and_grad(ref_cfg, host, batch)
    got_loss, got_metrics, got = _port_value_and_grad(cfg, host, batch)
    np.testing.assert_allclose(got_loss, want_loss, **LOSS)
    assert float(got_metrics["tokens"]) == float(want_metrics["tokens"])
    _assert_trees_close(got, want, GRAD, "loss_mask")


# ---------------------------------------------------------------- chunked CE


@pytest.mark.parametrize("chunk", [8, 12, 7, 48])
def test_chunked_ce_equals_the_unchunked_loss(chunk):
    """Chunks of 8 and 12 split the 24 positions; 7 does not divide them
    and 48 exceeds them, and both fall back to one chunk, as the reference."""
    ref_cfg, cfg = _cfgs("qwen1.5-0.5b")
    host, batch = _host_params(ref_cfg), _batch(cfg)
    params = params_from_numpy(host, "cpu")
    rng = np.random.default_rng(4)
    hidden = rng.normal(size=(2, SEQ, cfg.d_model)).astype(np.float32)
    targets = batch["tokens"]
    mask = (rng.random((2, SEQ)) < 0.8).astype(np.float32)
    args = [torch.from_numpy(a) for a in (hidden, targets, mask)]
    whole = lm.chunked_ce(params, *args, cfg)
    parts = lm.chunked_ce(params, *args, cfg.replace(loss_chunk=chunk))
    want = ref_lm.chunked_ce(jax.tree.map(jnp.asarray, host), hidden, targets, mask,
                             ref_cfg.replace(loss_chunk=chunk))
    for got, whole_v, want_v in zip(parts, whole, want):
        np.testing.assert_allclose(float(got), float(whole_v), rtol=1e-6)
        np.testing.assert_allclose(float(got), float(want_v), **LOSS)
    (_, _), g_whole = value_and_grad(model_fns(cfg).loss, params, _torch(batch))
    (_, _), g_parts = value_and_grad(model_fns(cfg.replace(loss_chunk=chunk)).loss, params,
                                     _torch(batch))
    _assert_trees_close(flatten(g_parts), flatten(g_whole), dict(rtol=1e-5, atol=1e-7),
                        f"chunk {chunk}")


# ---------------------------------------------------------------- remat


@contextlib.contextmanager
def _count_grouped_matmuls():
    """Count the calls of the grouped matmul's two products (on the CPU
    their plain versions; on the card the launches of ``gmm``/``tgmm``)."""
    calls = {"gmm": 0, "tgmm": 0}
    real = {name: getattr(gmm_ops, name) for name in calls}

    def counted(name):
        def call(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return call

    with mock.patch.object(gmm_ops, "gmm", counted("gmm")), \
            mock.patch.object(gmm_ops, "tgmm", counted("tgmm")):
        yield calls


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("family", ["dense", "moe", "hybrid", "encdec"])
def test_remat_gives_the_gradients_of_none(family, remat):
    """Recomputing a layer body (every op, or every op but the matrix
    products) gives ``none``'s gradients bit for bit on the CPU; under
    ``full`` an MoE layer runs its three expert products again in the
    backward (so does ``dots``: the products are no aten ops): 9 ``gmm``
    calls (forward, recompute, dx) and 3 ``tgmm`` a layer, the counts the
    card's launches must show."""
    ref_cfg, cfg = _cfgs(FAMILIES[family])
    host, batch = _host_params(ref_cfg), _batch(cfg)
    params = params_from_numpy(host, "cpu")
    counts = {}
    grads = {}
    for mode in ("none", remat):
        with _count_grouped_matmuls() as calls:
            (loss, _), g = value_and_grad(model_fns(cfg.replace(remat=mode)).loss, params,
                                          _torch(batch))
        counts[mode], grads[mode] = dict(calls), flatten(g)
    _assert_trees_close(grads[remat], grads["none"], dict(rtol=0, atol=0), remat)
    n_moe = sum(g.repeat for g in cfg.groups for s in g.pattern if s.ffn == "moe")
    assert counts["none"] == {"gmm": 6 * n_moe, "tgmm": 3 * n_moe}
    assert counts[remat] == {"gmm": 9 * n_moe, "tgmm": 3 * n_moe}


def test_remat_full_runs_the_layer_bodies_again_in_the_backward():
    ref_cfg, cfg = _cfgs("qwen1.5-0.5b")
    params = params_from_numpy(_host_params(ref_cfg), "cpu")
    batch = _torch(_batch(cfg))
    calls = []
    real = lm.block_apply

    def spy(*a, **kw):
        calls.append(kw["mode"])
        return real(*a, **kw)

    with mock.patch.object(lm, "block_apply", spy):
        value_and_grad(model_fns(cfg.replace(remat="full")).loss, params, batch)
        assert calls == ["full"] * (2 * cfg.total_layers)
        calls.clear()
        with torch.no_grad():     # no backward to come: nothing is recomputed
            model_fns(cfg.replace(remat="full")).loss(params, batch)
        assert calls == ["full"] * cfg.total_layers


# ---------------------------------------------------------------- train step


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "olmoe-1b-7b", "kimi-k2-1t-a32b"])
def test_train_step_matches_the_reference(arch):
    """One step: adamw with clip 1.0 (qwen, olmoe), adafactor (kimi).  The
    step's new params, its optimizer state and its metrics."""
    ref_cfg, cfg = _cfgs(arch)
    assert cfg.optimizer == ("adafactor" if arch.startswith("kimi") else "adamw")
    assert cfg.grad_clip == 1.0
    host, batch = _host_params(ref_cfg), _batch(cfg)
    ref_step, ref_opt = ref_make_train_step(ref_cfg)
    ref_params = jax.tree.map(jnp.asarray, host)
    want_p, want_s, want_m = jax.jit(ref_step)(ref_params, ref_opt.init(ref_params),
                                               jax.tree.map(jnp.asarray, batch))
    step, opt = make_train_step(cfg)
    params = params_from_numpy(host, "cpu")
    before = flatten(params)
    got_p, got_s, got_m = step(params, opt.init(params), _torch(batch))
    assert all(np.array_equal(v, before[k]) for k, v in flatten(params).items())  # inputs kept
    for key in ("loss", "ce", "aux", "grad_norm", "tokens"):
        np.testing.assert_allclose(float(got_m[key]), float(want_m[key]), **LOSS, err_msg=key)
    _assert_trees_close(flatten(got_p), _flatten(want_p), GRAD, f"{arch} params")
    _assert_trees_close(flatten(got_s), _flatten(want_s), GRAD, f"{arch} optimizer state")
    assert any(not np.array_equal(v, before[k]) for k, v in flatten(got_p).items())


def test_two_train_steps_lower_the_loss_on_the_batch():
    _, cfg = _cfgs("qwen1.5-0.5b")
    step, opt = make_train_step(cfg)
    params, _ = model_fns(cfg).init(torch.Generator().manual_seed(0), "cpu")
    state = opt.init(params)
    batch = _torch(_batch(cfg, b=4))
    losses = []
    for _ in range(3):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    assert losses[2] < losses[0] and all(np.isfinite(losses)), losses
    assert int(state["step"]) == 3


# ---------------------------------------------------------------- data


def test_token_data_is_the_reference_bit_for_bit():
    want = ref_synthetic.make_lm_tokens(50_000, 512, seed=7)
    got = make_lm_tokens(50_000, 512, seed=7)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    a, b = ref_pipeline.TokenDataset(want, 32, 4, seed=3), TokenDataset(got, 32, 4, seed=3)
    for _ in range(5):
        x, y = a.next_batch(), b.next_batch()
        assert list(x) == list(y) == ["tokens"]
        assert y["tokens"].dtype == x["tokens"].dtype and np.array_equal(y["tokens"], x["tokens"])


def test_build_silos_is_the_reference_bit_for_bit():
    want = ref_train.build_silos(3, 512, 32, 4, seed=1)
    got = port_train.build_silos(3, 512, 32, 4, seed=1)
    assert [(s["id"], s["budget"]) for s in got] == [(s["id"], s["budget"]) for s in want]
    for s, r in zip(got, want):
        assert np.array_equal(s["data"].tokens, r["data"].tokens)
        assert np.array_equal(s["data"].next_batch()["tokens"], r["data"].next_batch()["tokens"])


def test_qwen_100m_is_the_reference_example_config():
    import dataclasses

    cfg = port_train.train_config("qwen-100m")
    want = ref_registry.get_config("qwen1.5-0.5b").replace(
        name="qwen-100m", d_model=512, n_heads=8, n_kv_heads=8, d_ff=1408,
        groups=(), n_layers=8, loss_chunk=64, remat="none")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert 95e6 < cfg.param_count() < 110e6


# ---------------------------------------------------------------- federated rounds

ROUNDS = ["--arch", "qwen1.5-0.5b", "--reduced", "--rounds", "2", "--silos", "3",
          "--local-steps", "2", "--batch", "4", "--seq", "32"]
_ROUND = re.compile(r"round (\d+): loss=(\S+) sim_round_s=\S+ sim_clock_s=\S+ wall_s=\S+ "
                    r"comm_MB=(\S+)")


def _ref_main(argv):
    """The reference's ``main`` under ``argv``: its printed lines."""
    out = io.StringIO()
    with mock.patch.object(sys, "argv", ["train"] + argv), contextlib.redirect_stdout(out):
        ref_train.main()
    return out.getvalue().splitlines()


def _rounds(lines):
    return [(int(m[1]), float(m[2]), m[3]) for m in map(_ROUND.match, lines) if m]


def _ref_init():
    cfg = ref_registry.get_config("qwen1.5-0.5b", reduced=True)
    params, _ = ref_model_fns(cfg).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, jax.device_get(params))


def _port_run(**kw):
    lines = []
    cfg = port_train.train_config("qwen1.5-0.5b", reduced=True)
    res = port_train.train(cfg, rounds=2, silos=3, local_steps=2, batch=4, seq=32,
                           device="cpu", log=lambda *a: lines.append(" ".join(map(str, a))),
                           **kw)
    return res, lines


@pytest.mark.parametrize("compression", ["none", "topk"])
def test_federated_rounds_match_the_reference_main(compression):
    want = _ref_main(ROUNDS + ["--compression", compression])
    res, got = _port_run(compression=compression, init_params=_ref_init())
    assert got[0] == want[0] and got[-1] == want[-1] == "done."
    w, g = _rounds(want), _rounds(got)
    assert [r[0] for r in g] == [r[0] for r in w] == [1, 2]
    for (_, gl, gc), (_, wl, wc) in zip(g, w):
        np.testing.assert_allclose(gl, wl, rtol=1e-4)
        assert gc == wc
    for h, (_, loss, comm) in zip(res["history"], g):
        assert f"{h['loss']:.4f}" == f"{loss:.4f}" and f"{h['comm_bytes'] / 1e6:.1f}" == comm
        assert set(h["phase_s"]) == set(port_train.PHASES)
    n = sum(p.size for p in jax.tree.leaves(_ref_init()))
    per_upload = 4 * n if compression == "none" else 8 * sum(
        max(1, int(p.size * 0.01)) for p in jax.tree.leaves(_ref_init()))
    assert [h["comm_bytes"] for h in res["history"]] == [3 * per_upload, 6 * per_upload]


def test_a_checkpoint_resume_equals_an_uninterrupted_run(tmp_path):
    """Two rounds checkpointed; the checkpoint holds the run's params bit for
    bit.  A resume restores them and the round index and runs rounds 3-4
    with the silos and the sampling RNG started again from their seeds (the
    reference's semantics), so it equals a run from the same params in
    memory, bit for bit on the CPU; and the reference's ``main`` resumed
    from a copy of the port's checkpoint prints the same rounds."""
    ckpt, copy = tmp_path / "port", tmp_path / "ref"
    first, _ = _port_run(init_params=_ref_init(), ckpt_dir=str(ckpt))
    shutil.copytree(ckpt, copy)
    step, restored = CheckpointManager(str(ckpt)).restore_latest(first["params"])
    assert step == 2
    for k, v in flatten(restored).items():
        assert np.array_equal(v, flatten(first["params"])[k]), k
    resumed, lines = _port_run(ckpt_dir=str(ckpt))
    assert resumed["start_round"] == 2 and [h["round"] for h in resumed["history"]] == [3, 4]
    assert [m[1] for m in map(_ROUND.match, lines) if m] == ["3", "4"]
    straight, _ = _port_run(init_params=params_to_numpy(first["params"]))
    for a, b in zip(resumed["history"], straight["history"]):
        assert a["loss"] == b["loss"] and a["comm_bytes"] == b["comm_bytes"]
    for k, v in flatten(resumed["params"]).items():
        assert np.array_equal(v, flatten(straight["params"])[k]), k
    want = _rounds(_ref_main(ROUNDS + ["--ckpt-dir", str(copy)]))
    assert [r[0] for r in want] == [3, 4]
    for (_, wl, wc), h in zip(want, resumed["history"]):
        np.testing.assert_allclose(h["loss"], wl, rtol=1e-4)
        assert f"{h['comm_bytes'] / 1e6:.1f}" == wc
