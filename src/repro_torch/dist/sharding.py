"""Logical-axis sharding: MaxText-style rules → ``PartitionSpec`` → DTensor
placements.  The port of ``repro.dist.sharding``.

The model code never names mesh axes.  Parameters, caches and activations
are annotated with *logical* axis names ("embed", "qheads", "act_batch",
…); a *rules* dict maps each logical axis to zero or more physical mesh
axes; ``spec_for`` resolves a tuple of logical axes into a
``PartitionSpec``, degrading duplicates so each physical axis is used at
most once per spec (first dim wins, later dims replicate).
``spec_to_placements`` turns a spec into one DTensor ``Placement`` per dim
of a ``torch.distributed.device_mesh.DeviceMesh``: a mesh axis named in the
entry of tensor dim ``d`` becomes ``Shard(d)``, every other ``Replicate()``.

``default_rules(cfg, mesh, shape)`` derives the production layout from the
model config + mesh geometry, rule for rule the reference's:

* ZeRO-3 / FSDP: "embed" (and per-expert "expert_mlp" under EP) over the
  batch axes when ``cfg.fsdp_params``.
* Tensor parallel over "model": attention heads, MLP hidden, vocab, SSD
  inner width, RG-LRU width — each only when the dimension divides the
  axis; GQA configs whose ``n_kv_heads`` cannot fill the model axis fall
  back to sharding the head dim instead.
* Batch data parallel over ("pod", "data"); decode shapes whose batch is
  too small for the data axis shard the KV cache on *sequence* instead
  (split-KV / flash-decoding layout).
* MoE: expert-parallel ("expert" over "model", ZeRO-3 on the expert FFN
  dim) vs all-gather ("expert" over batch axes, FFN dim over "model").

``logical_sharding(mesh, rules)`` installs a context in which
``with_logical_constraint`` inside model code redistributes a ``DTensor`` to
the placements its axes resolve to; outside any context it is a no-op,
which is what keeps single-device runs mesh-free.  Inside one, a plain
tensor passes unchanged on a mesh of one device and raises ``TypeError`` on
a larger one, so a model that was never distributed cannot pass as
sharded.  ``CALLS`` counts every call, in a context or not.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

from repro_torch.dist.mesh_utils import axis_sizes, entry_axes, entry_shards, mesh_size
from repro_torch.tree import tree_map

Rule = Union[str, Tuple[str, ...], None]
Rules = Dict[str, Rule]
AxesLike = Optional[Tuple[Optional[str], ...]]

#: calls of ``with_logical_constraint``, in a context or not
CALLS = {"with_logical_constraint": 0}


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name, or
    a tuple of names (the dim split over those axes, major first) — the
    entries of ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "PartitionSpec(" + ", ".join(map(repr, self)) + ")"


P = PartitionSpec


# --------------------------------------------------------------------------
# Logical axes -> PartitionSpec -> placements
# --------------------------------------------------------------------------


def spec_for(axes: AxesLike, rules: Rules) -> PartitionSpec:
    """Resolve logical ``axes`` into a PartitionSpec under ``rules``.

    Each physical mesh axis is used at most once per spec: when two logical
    axes of one tensor map to the same physical axis, the leftmost dim keeps
    it and later dims drop the already-used axis — down to the still-free
    subset for multi-axis rules, to replicated when nothing is left.
    ``None`` axes (and axes with no rule) are replicated.  ``axes=None`` or
    ``()`` → fully replicated.
    """
    if axes is None:
        return P()
    used: set = set()
    entries = []
    for ax in axes:
        rule = rules.get(ax) if ax is not None else None
        if isinstance(rule, str):
            rule = (rule,)
        entry = None
        if rule:
            free = tuple(a for a in rule if a is not None and a not in used)
            if free:
                used.update(free)
                entry = free[0] if len(free) == 1 else free
        entries.append(entry)
    return P(*entries)


def spec_to_placements(spec, mesh) -> Tuple[Any, ...]:
    """One DTensor placement per dim of ``mesh`` (a DeviceMesh, or any
    object with ``axis_names``): ``Shard(d)`` on each mesh dim that the
    entry of tensor dim ``d`` names, ``Replicate()`` on the rest.

    DTensor splits a tensor dim sharded over several mesh dims in mesh-dim
    order, so an entry must list its axes in the mesh's order
    (``("pod", "data")`` on a ``("pod", "data", "model")`` mesh); one that
    does not has no plain-``Shard`` form and raises ``ValueError``, as does
    an axis the mesh lacks or one named twice."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(axis_sizes(mesh))
    order = {a: i for i, a in enumerate(names)}
    placements = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        idx = []
        for a in entry_axes(entry):
            if a not in order:
                raise ValueError(f"{spec!r} names mesh axis {a!r}; the mesh has {names}")
            idx.append(order[a])
        if idx != sorted(idx):
            raise ValueError(
                f"{spec!r}: entry {entry!r} of dim {dim} lists its mesh axes out of the "
                f"mesh's order {names}; DTensor splits a dim over mesh dims in mesh order, "
                f"so this entry has no plain Shard form")
        for i in idx:
            if placements[i].is_shard():
                raise ValueError(f"{spec!r} uses mesh axis {names[i]!r} twice")
            placements[i] = Shard(dim)
    return tuple(placements)


def _is_axes_leaf(x: Any) -> bool:
    return x is None or (
        isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)
    )


@dataclass(frozen=True)
class NamedSharding:
    """Where one tensor lives: ``distribute_tensor(t, mesh, placements)``."""

    mesh: Any
    spec: PartitionSpec
    placements: Tuple[Any, ...]


def tree_shardings(axes_tree: Any, mesh, rules: Rules) -> Any:
    """Map a tree of logical-axis tuples to ``NamedSharding``s.

    ``None`` leaves (axis-less state like optimizer step counters) resolve
    to fully-replicated shardings.
    """
    def one(ax):
        spec = spec_for(ax, rules)
        return NamedSharding(mesh, spec, spec_to_placements(spec, mesh))

    return tree_map(one, axes_tree, is_leaf=_is_axes_leaf)


def distribute(tree: Any, shardings: Any) -> Any:
    """The port's ``jax.device_put(tree, shardings)``: every tensor of
    ``tree`` placed as a DTensor under the ``NamedSharding`` of
    ``shardings`` at its place (``tree_shardings``' output; one sharding
    may stand for a whole subtree, as a JAX prefix does).  Every rank holds
    the same full tensor, as every JAX process holds the same host array,
    and keeps its own shard of it: nothing is sent (``src_data_rank=None``).
    A tensor that is already a DTensor is moved to the placements."""
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor

    def place(sh, sub):
        def one(t):
            if not isinstance(t, torch.Tensor):
                return t
            if isinstance(t, DTensor):
                return t.redistribute(sh.mesh, sh.placements)
            return distribute_tensor(t, sh.mesh, sh.placements, src_data_rank=None)

        return tree_map(one, sub)

    return tree_map(place, shardings, tree, is_leaf=lambda x: isinstance(x, NamedSharding))


def batch_shardings(batch: Any, mesh, rules: Rules) -> Any:
    """A ``NamedSharding`` for each array of a batch: its leading dim over
    the rules' ``act_batch``, the rest replicated (the reference's dry run
    places a batch by ``_BATCH_AXES``, ``("act_batch", None, ...)``)."""
    def one(t):
        axes = ("act_batch",) + (None,) * (t.dim() - 1) if t.dim() else ()
        spec = spec_for(axes, rules)
        return NamedSharding(mesh, spec, spec_to_placements(spec, mesh))

    return tree_map(one, batch)


# --------------------------------------------------------------------------
# Context: mesh + rules active while the model runs
# --------------------------------------------------------------------------


class ShardingContext:
    __slots__ = ("mesh", "rules", "sizes", "n_devices", "_dtensor", "_placements")

    def __init__(self, mesh, rules: Rules):
        from torch.distributed.tensor import DTensor

        self.mesh = mesh
        self.rules = dict(rules)
        self.sizes = axis_sizes(mesh)
        self.n_devices = mesh_size(mesh)
        self._dtensor = DTensor
        self._placements: Dict[Tuple[Any, ...], Tuple[Any, ...]] = {}

    def constrain(self, x, axes: Tuple[Optional[str], ...]):
        if not isinstance(x, self._dtensor):
            if self.n_devices == 1:
                return x
            raise TypeError(
                f"with_logical_constraint{axes} got a plain {type(x).__name__} of shape "
                f"{tuple(x.shape)} on a mesh of {self.n_devices} devices: distribute it first")
        key = (axes, tuple(x.shape))
        placements = self._placements.get(key)
        if placements is None:   # resolved once per (axes, shape) in this context
            spec = _shape_safe(spec_for(axes, self.rules), key[1], self.sizes)
            placements = self._placements[key] = spec_to_placements(spec, self.mesh)
        if tuple(x.placements) == placements:
            return x
        return x.redistribute(self.mesh, placements)


_LOCAL = threading.local()


def _stack():
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def current_context() -> Optional[ShardingContext]:
    stack = _stack()
    return stack[-1] if stack else None


@contextmanager
def logical_sharding(mesh, rules: Rules):
    """Activate ``rules`` on ``mesh`` for ``with_logical_constraint``.  On
    a mesh of more than one device the block also runs under DTensor's
    ``implicit_replication``: a plain tensor the model makes inside a step
    (positions, masks, RoPE tables, zeros) meets the DTensors as a
    replicated one, as a constant does inside ``jax.jit``.  A plain
    *input* still raises (``require_distributed``)."""
    import contextlib

    ctx = ShardingContext(mesh, rules)
    replicate = contextlib.nullcontext()
    if ctx.n_devices > 1:
        from torch.distributed.tensor.experimental import implicit_replication

        replicate = implicit_replication()
    _stack().append(ctx)
    try:
        with replicate:
            yield ctx
    finally:
        _stack().pop()


@contextmanager
def use_context(ctx: Optional[ShardingContext]):
    """``ctx`` (a context ``logical_sharding`` made, or None) active on this
    thread inside the block.  The stack is thread-local, and on the card
    autograd runs a backward on a device thread of its own: remat's
    recomputation re-enters the forward's context through this
    (``models.lm.maybe_remat``)."""
    if ctx is None:
        yield None
        return
    _stack().append(ctx)
    try:
        yield ctx
    finally:
        _stack().pop()


def require_distributed(what: str, *tensors) -> None:
    """``TypeError`` where a step's input is a plain tensor inside a
    context on a mesh of more than one device (``implicit_replication``
    would take it as replicated: a batch that was never placed)."""
    ctx = current_context()
    if ctx is None or ctx.n_devices == 1:
        return
    for t in tensors:
        if t is not None and not isinstance(t, ctx._dtensor):
            raise TypeError(
                f"{what} got a plain {type(t).__name__} of shape {tuple(t.shape)} on a mesh "
                f"of {ctx.n_devices} devices: distribute it first")


def with_logical_constraint(x, *axes: Optional[str]):
    """Constrain ``x`` to the placements its logical ``axes`` resolve to.

    A no-op outside a ``logical_sharding`` context, so model code runs
    unchanged on one device.  Inside one, a ``DTensor`` is redistributed;
    entries whose shard count does not divide the corresponding dim (e.g. a
    length-1 decode step under sequence sharding) degrade to replicated
    rather than erroring, and never to DTensor's uneven shards.  A plain
    tensor passes on a mesh of one device and raises ``TypeError`` on a
    larger one.  No call launches anything on a one-device mesh.
    """
    CALLS["with_logical_constraint"] += 1
    ctx = current_context()
    if ctx is None:
        return x
    return ctx.constrain(x, axes)


def _shape_safe(spec: PartitionSpec, shape: Tuple[int, ...],
                sizes: Dict[str, int]) -> PartitionSpec:
    if len(tuple(spec)) > len(shape):
        raise ValueError(f"{len(tuple(spec))} logical axes for rank-{len(shape)} array")
    entries = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    out = []
    for dim, entry in zip(shape, entries):
        n = entry_shards(entry, sizes)
        out.append(entry if n > 1 and dim % n == 0 else None)
    return P(*out)


def is_dtensor(*tensors) -> bool:
    """Whether any of ``tensors`` is a DTensor."""
    from torch.distributed.tensor import DTensor

    return any(isinstance(t, DTensor) for t in tensors)


def refuse_dtensor(what: str, *tensors) -> None:
    """``TypeError`` where a kernel wrapper that takes no DTensor yet is
    handed one, before it reads any ``data_ptr()``: the SSM and RG-LRU
    scans and the int8 decode on sharded operands are ROADMAP queue 1 row
    9b-iv."""
    if is_dtensor(*tensors):
        raise TypeError(f"{what} takes no DTensor: sharded {what} is ROADMAP queue 1 row 9b-iv")


# --------------------------------------------------------------------------
# Default production rules
# --------------------------------------------------------------------------


def default_rules(cfg, mesh, shape=None) -> Rules:
    """Derive the logical→physical rule set for ``cfg`` on ``mesh``.

    ``shape`` (an ``InputShape``) refines activation/cache placement per
    workload; with ``shape=None`` the rules cover parameters only plus a
    generic batch layout.
    """
    sizes = axis_sizes(mesh)
    batch_axes = tuple(a for a in cfg.logical_batch_axes if sizes.get(a, 1) > 1)
    n_batch = 1
    for a in batch_axes:
        n_batch *= sizes[a]
    n_model = sizes.get("model", 1)
    tp = cfg.use_tp and n_model > 1
    head_dim = cfg.resolved_head_dim

    def fits(dim: int, n: int) -> bool:
        return n > 1 and dim > 0 and dim % n == 0

    batch_rule: Rule = None
    if batch_axes:
        batch_rule = batch_axes[0] if len(batch_axes) == 1 else batch_axes

    rules: Rules = {
        # never sharded: scan/stack dims, conv taps, encoder context
        "layers": None,
        "conv": None,
        "enc_seq": None,
        # replicated unless a clause below says otherwise
        "head": None,
        "lru_out": None,
        "expert_embed": None,
        "act_seq": None,
        "cache_seq": None,
    }

    # ---- parameters --------------------------------------------------
    fsdp = cfg.fsdp_params and fits(cfg.d_model, n_batch)
    rules["embed"] = batch_rule if fsdp else None
    rules["qheads"] = "model" if tp and fits(cfg.n_heads, n_model) else None
    rules["kvheads"] = "model" if tp and fits(cfg.n_kv_heads, n_model) else None
    if tp and rules["kvheads"] is None and fits(head_dim, n_model):
        # GQA fallback: too few KV heads to fill the model axis — shard the
        # head dim; per-tensor dedup keeps wq on "qheads" where possible.
        rules["head"] = "model"
    rules["vocab"] = "model" if tp and fits(cfg.vocab_size, n_model) else None
    rules["mlp"] = "model" if tp and fits(cfg.d_ff, n_model) else None
    # SSD (mamba2) / RG-LRU inner widths are tensor-parallel when they divide
    rules["inner"] = "model" if tp and fits(cfg.d_inner, n_model) else None
    rules["ssd_heads"] = "model" if tp and fits(cfg.n_ssm_heads, n_model) else None
    rules["lru"] = "model" if tp and fits(cfg.resolved_lru_width, n_model) else None

    # ---- MoE experts -------------------------------------------------
    if cfg.n_experts:
        fsdp_rule = batch_rule if cfg.fsdp_params else None
        ep = cfg.moe_impl == "ep" and n_model > 1 and cfg.n_experts % n_model == 0
        if ep:
            # expert-parallel + ZeRO-3 on the per-expert FFN dim
            rules["expert"] = "model"
            rules["expert_mlp"] = (
                fsdp_rule if fsdp_rule and fits(cfg.d_ff_expert, n_batch) else None
            )
        else:
            # all-gather impl: experts ZeRO-3 over batch axes, TP on d_ff
            rules["expert"] = (
                fsdp_rule if fsdp_rule and fits(cfg.n_experts, n_batch) else None
            )
            rules["expert_mlp"] = (
                "model" if tp and fits(cfg.d_ff_expert, n_model) else None
            )

    # ---- activations / caches ----------------------------------------
    act_batch: Rule = batch_rule
    if shape is not None and (n_batch <= 1 or shape.global_batch % n_batch != 0):
        act_batch = None
    rules["act_batch"] = act_batch

    if (
        cfg.act_seq_shard
        and n_model > 1
        and (shape is None or shape.kind != "decode")
    ):
        # Megatron-SP residual stream (whisper uses this with TP off: the
        # otherwise-idle model axis still shards activations)
        rules["act_seq"] = "model"

    if shape is not None and shape.kind == "decode":
        seq_axes = []
        if act_batch is None and sizes.get("data", 1) > 1:
            # batch too small for the data axis (long_500k): shard the KV
            # cache on sequence so the context still spreads over the pod
            seq_axes.append("data")
        if cfg.decode_cache_seq_shard and n_model > 1:
            seq_axes.append("model")  # split-KV / flash-decoding
        if seq_axes:
            rules["cache_seq"] = seq_axes[0] if len(seq_axes) == 1 else tuple(seq_axes)

    return rules
