"""The port's logical-axis sharding rules against the reference's, on the
CPU with no process group: ``default_rules`` dict for dict, and for every
param tensor (and every cache tensor at decode shapes) its logical axes,
its shape on ``meta`` (``shapes_and_axes``) against the reference's
``eval_shape``, and its ``spec_for`` entry for entry, over every
architecture × {16 × 16, 2 × 16 × 16} × (no shape and each runnable
shape); the DTensor placements those specs give; ``opt_state_axes`` for
all five optimizers; the seven named cases of
``tests/test_sharding_rules.py``; and ``with_logical_constraint`` outside a
context and on plain tensors.  Meshes are the reference tests' FakeMesh,
so the rules build for 256 and 512 devices with nothing started.
"""
import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import cell_is_runnable
from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as ref_get_config
from repro.dist import sharding as R
from repro.models.registry import decode_cache_len as ref_decode_cache_len
from repro.models.registry import model_fns as ref_model_fns
from repro.models.registry import shapes_and_axes as ref_shapes_and_axes
from repro.optim.optimizers import opt_state_axes as ref_opt_state_axes
from repro_torch.configs.base import SHAPES, SHAPES_BY_NAME
from repro_torch.configs.registry import get_config
from repro_torch.dist import sharding as S
from repro_torch.dist.mesh_utils import axis_sizes, entry_shards, mesh_size, validate_spec
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.registry import decode_cache_len, model_fns, shapes_and_axes
from repro_torch.optim.optimizers import make_optimizer, opt_state_axes
from repro_torch.tree import tree_leaves, tree_map


class FakeMesh:
    """Just enough mesh for rule construction (no devices touched)."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


MESH = FakeMesh((16, 16), ("data", "model"))
MESH3 = FakeMesh((2, 16, 16), ("pod", "data", "model"))
MESHES = {"16x16": MESH, "2x16x16": MESH3}
SHAPE_NAMES = [None] + [s.name for s in SHAPES]
OPTIMIZERS = ("sgd", "momentum", "adam", "adamw", "adafactor")
ACT_AXES = (("act_batch", "act_seq", None), ("act_batch", None, "vocab"),
            ("act_batch", "cache_seq", "kvheads", "head"))


def _dtype_name(dt) -> str:
    return str(dt).split(".")[-1]


def _ref_leaves(shapes, axes):
    """{path: (shape, dtype, axes)} of a reference (ShapeDtypeStructs, axes) pair."""
    flat, tdef = jax.tree_util.tree_flatten_with_path(shapes)
    out = {}
    for (keypath, sds), ax in zip(flat, tdef.flatten_up_to(axes)):
        path = "/".join(f"[{k.idx}]" if hasattr(k, "idx") else str(k.key) for k in keypath)
        out[path] = (tuple(sds.shape), _dtype_name(sds.dtype), ax)
    return out


def _port_leaves(tensors, axes):
    """{path: (shape, dtype, axes)} of the port's (meta tensors, axes) pair."""
    out = {}

    def walk(t, ax, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], ax[k], path + (str(k),))
        elif isinstance(t, (list, tuple)):
            for i, x in enumerate(t):
                walk(x, ax[i], path + (f"[{i}]",))
        else:
            assert t.device.type == "meta", path
            out["/".join(path)] = (tuple(t.shape), _dtype_name(t.dtype), ax)

    walk(tensors, axes, ())
    return out


_TRACES = {}


def _traces(arch, what, shape=None):
    """(reference leaves, port leaves, reference axes, port axes, reference
    shapes, port meta tensors) of the params (``what="params"``) or of the
    decode cache at ``shape``, memoised: param traces are shape-independent."""
    key = (arch, what, shape.name if shape is not None else None)
    if key not in _TRACES:
        ref_fns, fns = ref_model_fns(ref_get_config(arch)), model_fns(get_config(arch))
        if what == "params":
            ref = ref_shapes_and_axes(ref_fns.init, jax.random.PRNGKey(0))
            port = shapes_and_axes(fns.init, torch.Generator().manual_seed(0))
        else:
            n = ref_decode_cache_len(shape.seq_len)
            assert decode_cache_len(shape.seq_len) == n
            ref = ref_shapes_and_axes(lambda: ref_fns.make_cache(shape.global_batch, n))
            port = shapes_and_axes(fns.make_cache, shape.global_batch, n)
        _TRACES[key] = (_ref_leaves(*ref), _port_leaves(*port), ref[1], port[1], ref[0],
                        port[0])
    return _TRACES[key]


def _cases():
    for arch in ARCH_IDS:
        for mesh_name in sorted(MESHES):
            for shape in SHAPE_NAMES:
                if shape is None or cell_is_runnable(arch, shape)[0]:
                    yield arch, mesh_name, shape


def _legal_placements(spec, placements, mesh, tensor_shape):
    """Each placement a Replicate or a Shard of a real dim; the mesh dims
    sharding one tensor dim are exactly its entry's axes, in mesh order."""
    names, sizes = mesh.axis_names, axis_sizes(mesh)
    assert len(placements) == len(names)
    spec = tuple(spec) + (None,) * (len(tensor_shape) - len(spec))
    for dim, entry in enumerate(spec):
        want = [names.index(a) for a in ((entry,) if isinstance(entry, str) else entry or ())]
        got = [i for i, p in enumerate(placements) if isinstance(p, Shard) and p.dim == dim]
        assert got == want == sorted(want), (spec, placements)
        n = 1
        for i in got:
            n *= sizes[names[i]]
        assert n == entry_shards(entry, sizes)
    for p in placements:
        assert isinstance(p, (Shard, Replicate)), p
        assert not isinstance(p, Shard) or p.dim < len(tensor_shape), (spec, placements)


@pytest.mark.parametrize("arch,mesh_name,shape_name", list(_cases()))
def test_rules_axes_shapes_specs_and_placements_equal_the_reference(arch, mesh_name, shape_name):
    mesh = MESHES[mesh_name]
    shape = SHAPES_BY_NAME[shape_name] if shape_name else None
    ref_shape = next(s for s in REF_SHAPES if s.name == shape_name) if shape_name else None
    rules = S.default_rules(get_config(arch), mesh, shape)
    assert rules == R.default_rules(ref_get_config(arch), mesh, ref_shape)
    sizes = axis_sizes(mesh)
    traces = [_traces(arch, "params")]
    if shape is not None and shape.kind == "decode":
        traces.append(_traces(arch, "cache", shape))
    for ref, port, ref_axes, port_axes, _, _ in traces:
        assert port_axes == ref_axes
        assert port.keys() == ref.keys()
        for path, (tshape, dtype, axes) in port.items():
            assert (tshape, dtype, axes) == ref[path], path
            spec = S.spec_for(axes, rules)
            assert tuple(spec) == tuple(R.spec_for(axes, rules)), (path, spec)
            validate_spec(spec, sizes, tshape)
            _legal_placements(spec, S.spec_to_placements(spec, mesh), mesh, tshape)
    for axes in ACT_AXES:   # activations, as the reference's property test takes them
        spec = S.spec_for(axes, rules)
        assert tuple(spec) == tuple(R.spec_for(axes, rules)), axes
        _legal_placements(spec, S.spec_to_placements(spec, mesh), mesh, (1,) * len(axes))
    # the shardings of the whole tree at once, the optimizer step's None too
    shardings = S.tree_shardings({"params": traces[0][3], "step": None}, mesh, rules)
    assert shardings["step"].placements == (Replicate(),) * len(mesh.axis_names)
    assert tuple(shardings["step"].spec) == ()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shapes_and_axes_allocate_nothing(arch):
    """Every leaf on meta (asserted while walked): the reference tree's
    count of parameters (kimi-k2's ~1 T among them) with no storage."""
    ref, port, _, _, _, _ = _traces(arch, "params")
    n = sum(int(np.prod(shape)) for shape, _, _ in port.values())
    assert n == sum(int(np.prod(shape)) for shape, _, _ in ref.values())
    assert arch != "kimi-k2-1t-a32b" or n > 10 ** 12


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_opt_state_axes_equal_the_reference(name):
    factored = 0
    for arch in ARCH_IDS:
        _, _, ref_axes, port_axes, ref_shapes, tensors = _traces(arch, "params")
        got = opt_state_axes(name, port_axes, tensors)
        assert got == ref_opt_state_axes(name, ref_axes, ref_shapes), (arch, name)
        factored += str(got).count("'vr'")
    if name == "adafactor":
        assert factored > len(ARCH_IDS)   # >= 128 x 128 leaves take vr/vc
    # the optimizer's own state has the axes tree's structure (qwen1.5-0.5b's
    # params on meta, adafactor's factored leaves among them)
    cfg = get_config("qwen1.5-0.5b")
    _, _, _, axes, _, tensors = _traces(cfg.name, "params")
    state = make_optimizer(name, 1e-3).init(tensors)
    state_axes = opt_state_axes(name, axes, tensors)
    leaves = []
    tree_map(lambda ax, t: leaves.append((ax, t)), state_axes, state,
             is_leaf=S._is_axes_leaf)
    assert len(leaves) == len(tree_leaves(state))
    for ax, t in leaves:
        assert ax is None or len(ax) == t.dim(), (ax, t.shape)
    shardings = S.tree_shardings(state_axes, MESH, S.default_rules(cfg, MESH))
    assert shardings["step"].placements == (Replicate(), Replicate())


def _named_cases():
    return {
        "spec dedup prevents double use": lambda spec_for, rules_for: (
            spec_for(("embed", "qheads", "head"),
                     {"qheads": "model", "head": "model", "embed": None}),
            (None, "model", None)),
        "kv fallback to head dim": lambda spec_for, rules_for: (
            spec_for(("embed", "kvheads", "head"), rules_for("mistral-nemo-12b", MESH)),
            ("data", None, "model")),
        "vocab replicated when not divisible": lambda spec_for, rules_for: (
            (tuple(spec_for(("vocab", "embed"), rules_for("mamba2-1.3b", MESH))),
             spec_for(("vocab", "embed"), rules_for("gemma3-27b", MESH))[0]),
            ((None, None), "model")),
        "long decode shards cache on sequence": lambda spec_for, rules_for: (
            spec_for(("act_batch", "cache_seq", "kvheads", "head"),
                     rules_for("gemma3-27b", MESH, "long_500k")),
            (None, "data", "model", None)),
        "decode32k keeps batch sharding": lambda spec_for, rules_for: (
            tuple(spec_for(("act_batch", "cache_seq", "kvheads", "head"),
                           rules_for("gemma3-27b", MESH, "decode_32k")))[:2],
            ("data", None)),
        "multipod batch axes": lambda spec_for, rules_for: (
            spec_for(("act_batch", None, None), rules_for("kimi-k2-1t-a32b", MESH3))[0],
            ("pod", "data")),
        "moe ep rules": lambda spec_for, rules_for: (
            (tuple(spec_for(("expert", "expert_embed", "expert_mlp"),
                            rules_for("kimi-k2-1t-a32b", MESH))),
             tuple(spec_for(("expert", "expert_embed", "expert_mlp"),
                            rules_for("olmoe-1b-7b", MESH, moe_impl="gather")))),
            (("model", None, "data"), ("data", None, "model"))),
    }


@pytest.mark.parametrize("case", sorted(_named_cases()))
def test_the_reference_named_rule_cases_hold_for_the_port(case):
    fn = _named_cases()[case]

    def port_rules(arch, mesh, shape=None, **over):
        cfg = get_config(arch).replace(**over) if over else get_config(arch)
        return S.default_rules(cfg, mesh, SHAPES_BY_NAME[shape] if shape else None)

    def ref_rules(arch, mesh, shape=None, **over):
        cfg = ref_get_config(arch).replace(**over) if over else ref_get_config(arch)
        return R.default_rules(cfg, mesh,
                               next(s for s in REF_SHAPES if s.name == shape) if shape else None)

    got, want = fn(S.spec_for, port_rules)
    ref_got, _ = fn(lambda *a: tuple(R.spec_for(*a)), ref_rules)
    norm = lambda v: tuple(v) if isinstance(v, S.PartitionSpec) else v  # noqa: E731
    assert norm(got) == want
    assert norm(got) == norm(ref_got)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_spec_dedup_exhaustive_pairs_equal_the_reference(mesh_name):
    mesh = MESHES[mesh_name]
    cfg, ref_cfg = get_config("kimi-k2-1t-a32b"), ref_get_config("kimi-k2-1t-a32b")
    rules = S.default_rules(cfg, mesh, SHAPES_BY_NAME["decode_32k"])
    ref_rules = R.default_rules(ref_cfg, mesh, next(s for s in REF_SHAPES
                                                    if s.name == "decode_32k"))
    names = sorted(rules, key=str)
    for a in names:
        for b in names:
            spec = S.spec_for((a, b), rules)
            assert tuple(spec) == tuple(R.spec_for((a, b), ref_rules)), (a, b)
            validate_spec(spec, axis_sizes(mesh))
            S.spec_to_placements(spec, mesh)


@pytest.mark.parametrize("spec,why", [
    (S.P(("model", "data")), "out of the mesh's order"),
    (S.P(None, ("model", "pod")), "out of the mesh's order"),
    (S.P("data", "data"), "twice"),
    (S.P("expert"), "names mesh axis"),
])
def test_a_spec_without_a_plain_shard_form_raises(spec, why):
    with pytest.raises(ValueError, match=why):
        S.spec_to_placements(spec, MESH3)


def test_mesh_ordered_multi_axis_entries_shard_one_dim_over_each_mesh_dim():
    assert S.spec_to_placements(S.P(("pod", "data"), None, "model"), MESH3) == (
        Shard(0), Shard(0), Shard(2))
    assert S.spec_to_placements(S.P(None, ("data", "model")), MESH) == (Shard(1), Shard(1))
    assert S.spec_to_placements(S.P(), MESH) == (Replicate(), Replicate())
    assert mesh_size(MESH3) == 512


def test_with_logical_constraint_outside_and_on_plain_tensors():
    x = torch.ones(4, 8, 16)
    before = S.CALLS["with_logical_constraint"]
    assert S.current_context() is None
    assert S.with_logical_constraint(x, "act_batch", "act_seq", None) is x
    one = FakeMesh((1, 1), ("data", "model"))
    with S.logical_sharding(one, S.default_rules(get_config("qwen1.5-0.5b"), one)) as ctx:
        assert S.current_context() is ctx and ctx.n_devices == 1
        assert S.with_logical_constraint(x, "act_batch", "act_seq", None) is x
        with S.logical_sharding(MESH, S.default_rules(get_config("qwen1.5-0.5b"), MESH)):
            with pytest.raises(TypeError, match="256 devices"):
                S.with_logical_constraint(x, "act_batch", "act_seq", None)
        assert S.current_context() is ctx
    assert S.current_context() is None
    assert S.CALLS["with_logical_constraint"] == before + 3


def test_the_shape_safe_degrade_is_the_reference():
    sizes = axis_sizes(MESH3)
    for spec, shape in (((("pod", "data"), "model"), (64, 1)), (("data", None), (3, 5)),
                        (("model",), (32, 7)), ((None, ("data", "model")), (2, 512))):
        got = S._shape_safe(S.P(*spec), shape, sizes)
        assert tuple(got) == tuple(R._shape_safe(jax.sharding.PartitionSpec(*spec), shape,
                                                 sizes)), (spec, shape)
    with pytest.raises(ValueError, match="logical axes for rank"):
        S._shape_safe(S.P("data", None), (4,), sizes)


def test_make_host_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()
    assert not torch.distributed.is_initialized()
