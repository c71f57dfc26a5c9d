"""The port's MoE FFN against the reference's, on the CPU.

``repro_torch.models.moe`` (``route``, ``moe_ffn``) against
``repro.models.moe`` (``route``, ``_moe_local``) on the same numpy inputs,
for each ``gmm_impl``: ``"ragged"`` (``lax.ragged_dot`` against the port's
``grouped_matmul``), ``"pallas"`` (the reference's Pallas kernel,
interpreted on the CPU, against the same) and ``"dense"`` (the reference's
one-hot oracle against the port's plain per-group loop).  Tolerances are the
reference's: f32 2e-5, bf16 2e-2; the routing (top-k indices, group sizes)
must be equal exactly, the aux loss within 2e-5.  The ``gmm`` kernel is held
against the plain loop on the card by tests/test_torch_kernels_cuda.py and
chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.kernels.grouped_matmul import ops as ref_gmm_ops
from repro.models import moe as ref_moe
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import registry
from repro_torch.kernels.grouped_matmul import ops as gmm_ops
from repro_torch.kernels.grouped_matmul import ref as gmm_ref
from repro_torch.models import moe

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
ARCH = "olmoe-1b-7b"
IMPLS = ["ragged", "pallas", "dense"]


def _cfgs(dtype):
    over = dict(compute_dtype=dtype, param_dtype="float32")
    return (ref_registry.get_config(ARCH, reduced=True).replace(**over),
            registry.get_config(ARCH, reduced=True).replace(**over))


def _inputs(cfg, b, s, seed=0, starve=0):
    """Reference weights as numpy and a (b, s, d) input; the first
    ``starve`` experts score -100 · x[..., 0] with x[..., 0] >= 3, so no
    token picks them."""
    params, _ = ref_moe.init_moe(jax.random.PRNGKey(seed), cfg)
    host = jax.tree.map(np.asarray, jax.device_get(params))
    host["router"] = host["router"] * 50.0       # routing scores that matter
    x = np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)).astype(np.float32)
    if starve:
        host["router"][:, :starve] = 0.0
        host["router"][0, :starve] = -100.0
        x[..., 0] = np.abs(x[..., 0]) + 3.0
    return host, x


def _ref(host, x, cfg, impl):
    sizes = []
    real = ref_gmm_ops.grouped_matmul

    def spy(xs, w, gs, impl="ragged", **kw):
        sizes.append(np.asarray(gs))
        return real(xs, w, gs, impl=impl, **kw)

    cd = jnp.dtype(cfg.compute_dtype)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_gmm_ops, "grouped_matmul", spy)
        out, aux = ref_moe._moe_local(*(jnp.asarray(host[k]) for k in ("router", "wg", "wu", "wd")),
                                      jnp.asarray(x).astype(cd), cfg, impl)
    return np.asarray(out.astype(jnp.float32)), float(aux), sizes


def _port(host, x, cfg, impl, monkeypatch):
    sizes = []
    fn = gmm_ref.grouped_matmul_ref if impl == "dense" else gmm_ops.grouped_matmul
    name = "grouped_matmul_ref" if impl == "dense" else "grouped_matmul"
    mod = gmm_ref if impl == "dense" else gmm_ops

    def spy(xs, w, gs):
        sizes.append(gs.numpy().copy())
        return fn(xs, w, gs)

    monkeypatch.setattr(mod, name, spy)
    params = params_from_numpy(host, "cpu")
    xt = torch.from_numpy(x).to(getattr(torch, cfg.compute_dtype))
    with torch.no_grad():
        out, aux = moe.moe_ffn(params, xt, cfg, gmm_impl=impl)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    return out.float().numpy(), float(aux), sizes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("b,s,starve", [(2, 12, 0), (1, 2, 0), (2, 9, 3)],
                         ids=["tokens", "two-tokens-empty-experts", "starved-experts"])
def test_moe_ffn_matches_the_reference(b, s, starve, impl, dtype, monkeypatch):
    ref_cfg, cfg = _cfgs(dtype)
    host, x = _inputs(ref_cfg, b, s, seed=b * 10 + s, starve=starve)
    want, want_aux, want_sizes = _ref(host, x, ref_cfg, impl)
    got, aux, sizes = _port(host, x, cfg, impl, monkeypatch)
    assert len(sizes) == len(want_sizes) == 3        # wg, wu, wd
    for g, w in zip(sizes, want_sizes):
        np.testing.assert_array_equal(g, w)
    assert sizes[0].sum() == b * s * cfg.top_k
    if starve or b * s * cfg.top_k < cfg.n_experts:
        assert (sizes[0] == 0).any()                 # the case has empty experts
    np.testing.assert_allclose(got, want, **(F32 if dtype == "float32" else BF16))
    assert abs(aux - want_aux) <= 2e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_matches_the_reference(dtype):
    ref_cfg, cfg = _cfgs(dtype)
    host, x = _inputs(ref_cfg, 3, 7, seed=4)
    xf = x.reshape(-1, cfg.d_model)
    want = ref_moe.route(jnp.asarray(host["router"]),
                         jnp.asarray(xf).astype(jnp.dtype(dtype)), ref_cfg)
    got = moe.route(torch.from_numpy(host["router"]),
                    torch.from_numpy(xf).to(getattr(torch, dtype)), cfg)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))   # top-k indices
    for g, w in ((got[0], want[0]), (got[2], want[2])):                 # top-k probs, probs
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


def test_init_moe_keeps_the_reference_tree():
    ref_cfg, cfg = _cfgs("float32")
    want, want_axes = ref_moe.init_moe(jax.random.PRNGKey(0), ref_cfg)
    got, axes = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    assert axes == want_axes
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype), key
    std_out = 0.02 / np.sqrt(2.0 * cfg.total_layers)
    assert abs(float(got["wd"].std()) - std_out) < 0.1 * std_out
    assert abs(float(got["wg"].std()) - 0.02) < 2e-3


class _Mesh:
    """Just enough ``DeviceMesh`` for ``moe_ffn``'s choice of path and
    ``shard_map``'s checks, with no process group behind it."""

    def __init__(self, shape, names=("data", "model")):
        self.mesh_dim_names = names
        self.shape = shape


def test_moe_ffn_refuses_a_mesh_of_more_than_one_device():
    """A mesh of one device runs the local path, gradients included.  On a
    larger one the sharded body refuses, before any collective, a plain
    tensor (``TypeError``: it was never distributed), one that requires
    grad too.  The bodies themselves, and their gradients, run on gloo
    ranks in ``tests/test_torch_moe_sharded.py``."""
    _, cfg = _cfgs("float32")
    host, x = _inputs(ref_registry.get_config(ARCH, reduced=True), 1, 4)
    params = params_from_numpy(host, "cpu")
    xt = torch.from_numpy(x)
    with torch.no_grad():
        one, _ = moe.moe_ffn(params, xt, cfg, mesh=_Mesh((1, 1)))
        none, _ = moe.moe_ffn(params, xt, cfg)
        torch.testing.assert_close(one, none, rtol=0, atol=0)
        for impl in ("gather", "ep"):
            with pytest.raises(TypeError, match="distribute it first"):
                moe.moe_ffn(params, xt, cfg.replace(moe_impl=impl), mesh=_Mesh((2, 2)))
    grads = []
    for mesh in (_Mesh((1, 1)), None):
        live = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
        xg = xt.clone().requires_grad_()
        y, aux = moe.moe_ffn(live, xg, cfg, mesh=mesh)
        grads.append(torch.autograd.grad(y.sum() + aux, [*live.values(), xg]))
    for a, b in zip(*grads):
        assert torch.isfinite(a).all() and float(a.abs().max()) > 0
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(TypeError, match="distribute it first"):
        moe.moe_ffn(params, xt.clone().requires_grad_(), cfg, mesh=_Mesh((2, 2)))
    with pytest.raises(ValueError):
        moe.moe_ffn(params, xt, cfg, gmm_impl="megablocks")
