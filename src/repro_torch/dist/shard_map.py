"""``shard_map`` over a ``DeviceMesh``: the port's counterpart of
``jax.shard_map`` for the sharded bodies (the MoE layer's, the client
wave's).

``shard_map(body, mesh, in_specs, out_specs)`` returns a function of
DTensors on ``mesh``.  Each input (a tensor, or a tree of them under one
spec) is redistributed to the placements its in-spec resolves to
(``spec_to_placements``) and handed to ``body`` as ``to_local()``; the
body's outputs are wrapped with ``DTensor.from_local`` under the
out-specs.  A plain tensor on a mesh of more than one device raises
``TypeError``, as ``with_logical_constraint`` does: a model that was never
distributed cannot pass as sharded.

While the body runs, the collectives of this module act on its mesh, so a
body reads line for line like the reference's ``lax`` one:
``axis_index(name)``, ``axis_size(name)``, ``psum(x, axes)``,
``pmean(x, axes)``, ``pmax(x, axes)`` (a constant) and
``all_gather(x, axes, dim, tiled=True)``; ``flat_index(axes)`` is the
block of a dim split over ``axes`` that the rank holds.  A tuple
of axes is the flattened sub-mesh, its first axis major (what
``lax.all_gather(x, ("pod", "data"), tiled=True)`` concatenates); one
process group is made for each axis tuple and kept.

Gradients follow JAX's transposes under ``check_rep=False`` (the
reference runs its bodies unchecked, ``_SHMAP_NOCHECK``): ``psum``'s
transpose is ``psum`` over the same axes; a tiled ``all_gather``'s is the
reduce-scatter of the cotangent over its axes (``psum_scatter``); an
output's cotangent is divided by the size of the mesh axes its out-spec
leaves replicated; an input's is summed over the mesh axes its in-spec
leaves replicated (a replicated router's gradient is psum-reduced), then
moved back to the input's placements.  For a body whose replicated
outputs really are replicated this is the gradient of the global
function.

Collectives run through ``torch.distributed``'s ``all_reduce``,
``all_gather_into_tensor`` and ``reduce_scatter_tensor`` on the group;
``COLLECTIVE_BYTES`` counts what each rank handed them.  On the card's
world of several ranks on one device the group's backend is
``repro_torch.dist.staged_gloo``.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Callable, Dict, Sequence, Tuple, Union

from repro_torch.dist.mesh_utils import axis_sizes, entry_axes, mesh_size
from repro_torch.dist.sharding import PartitionSpec, spec_to_placements
from repro_torch.tree import tree_map

Axes = Union[str, Tuple[str, ...]]

#: bytes each collective was handed (input bytes a rank, summed over calls)
COLLECTIVE_BYTES = {"psum": 0, "all_gather": 0, "reduce_scatter": 0}

_LOCAL = threading.local()
#: (mesh, axes) -> (process group, its ranks in flattened order); the key
#: holds the mesh, so no later mesh can take its place
_GROUPS: Dict[Tuple[Any, Tuple[str, ...]], Tuple[Any, Tuple[int, ...]]] = {}


def _active():
    mesh = getattr(_LOCAL, "mesh", None)
    if mesh is None:
        raise RuntimeError("mesh collectives run only inside a shard_map body")
    return mesh


@contextmanager
def _on(mesh):
    saved = getattr(_LOCAL, "mesh", None)
    _LOCAL.mesh = mesh
    try:
        yield
    finally:
        _LOCAL.mesh = saved


def axis_index(name: str) -> int:
    """This rank's coordinate along mesh axis ``name``."""
    mesh = _active()
    return mesh.get_coordinate()[mesh.mesh_dim_names.index(name)]


def axis_size(name: str) -> int:
    """The number of devices along mesh axis ``name``."""
    return axis_sizes(_active())[name]


def _group(mesh, axes: Tuple[str, ...]):
    """(process group, its ranks in flattened order, first axis major) of
    the sub-mesh over ``axes`` that holds this rank: the mesh's own group
    for one axis, the world's for every axis of a mesh over the whole
    world, else one made once per mesh and axes by every rank together."""
    key = (mesh, axes)
    got = _GROUPS.get(key)
    if got is None:
        import torch.distributed as dist

        names = tuple(mesh.mesh_dim_names)
        rest = [n for n in names if n not in axes]
        grid = mesh.mesh.permute(*[names.index(n) for n in (*rest, *axes)])
        orders = [tuple(int(r) for r in row) for row in grid.reshape(-1, _size(mesh, axes)).tolist()]
        me = dist.get_rank()
        order = next(o for o in orders if me in o)
        if len(axes) == 1:
            group = mesh.get_group(axes[0])
        elif not rest and mesh.mesh.numel() == dist.get_world_size():
            group = dist.group.WORLD
        else:
            group, _ = dist.new_subgroups_by_enumeration([sorted(o) for o in orders])
        got = _GROUPS[key] = (group, order)
    return got


def _size(mesh, axes: Tuple[str, ...]) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _psum(mesh, names: Tuple[str, ...], x):
    """``x`` summed over the ranks of ``names`` (no autograd)."""
    import torch.distributed as dist

    group, _ = _group(mesh, names)
    COLLECTIVE_BYTES["psum"] += x.numel() * x.element_size()
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def _all_gather(mesh, names: Tuple[str, ...], x, dim: int, tiled: bool):
    """``x`` of every rank of ``names`` in flattened order (no autograd)."""
    import torch
    import torch.distributed as dist

    n = _size(mesh, names)
    group, order = _group(mesh, names)
    COLLECTIVE_BYTES["all_gather"] += x.numel() * x.element_size()
    src = x.detach().contiguous().reshape(-1) if x.dim() == 0 else x.detach().contiguous()
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather_into(out, src, group=group)
    # the group's ranks come ascending; the sub-mesh's order may differ
    chunks = out.chunk(n, dim=0)
    ascending = sorted(order)
    chunks = [chunks[ascending.index(r)].reshape(x.shape) for r in order]
    return torch.cat(chunks, dim=dim) if tiled else torch.stack(chunks, dim=dim)


def _reduce_scatter(mesh, names: Tuple[str, ...], x, dim: int):
    """``lax.psum_scatter(x, names, scatter_dimension=dim, tiled=True)``:
    ``x`` summed over the ranks of ``names``, and of the sum this rank's
    slice along ``dim`` (the i-th of n in flattened order for the rank at
    position i; no autograd)."""
    import torch
    import torch.distributed as dist

    n = _size(mesh, names)
    group, order = _group(mesh, names)
    COLLECTIVE_BYTES["reduce_scatter"] += x.numel() * x.element_size()
    chunks = x.detach().movedim(dim, 0).chunk(n, dim=0)
    # the group reduces the j-th block of dim 0 into its j-th rank, ascending
    blocks = torch.cat([chunks[order.index(r)] for r in sorted(order)]).contiguous()
    out = blocks.new_empty((blocks.shape[0] // n, *blocks.shape[1:]))
    scatter_from = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    scatter_from(out, blocks, group=group)
    return out.movedim(0, dim)


def _autograd():
    """The collectives as ``autograd.Function``s with JAX's transposes under
    ``check_rep=False`` (built once, on first use, so importing this module
    imports no torch)."""
    global _FNS
    if _FNS is not None:
        return _FNS
    import torch

    class Psum(torch.autograd.Function):
        """psum; its transpose is psum over the same axes."""

        @staticmethod
        def forward(ctx, x, mesh, names):
            ctx.mesh, ctx.names = mesh, names
            return _psum(mesh, names, x)

        @staticmethod
        def backward(ctx, g):
            return _psum(ctx.mesh, ctx.names, g), None, None

    class AllGather(torch.autograd.Function):
        """all_gather; its transpose is a reduce-scatter over the same axes
        (``psum_scatter``), of the stacked form at a new dim."""

        @staticmethod
        def forward(ctx, x, mesh, names, dim, tiled):
            ctx.mesh, ctx.names, ctx.dim, ctx.tiled = mesh, names, dim, tiled
            return _all_gather(mesh, names, x, dim, tiled)

        @staticmethod
        def backward(ctx, g):
            out = _reduce_scatter(ctx.mesh, ctx.names, g, ctx.dim)
            return (out if ctx.tiled else out.squeeze(ctx.dim)), None, None, None, None

    class Move(torch.autograd.Function):
        """An input's local shard moved from its placements to its
        in-spec's.  The transpose: the body's cotangent summed over the mesh
        axes the in-spec leaves replicated (JAX psums a replicated input's
        cotangent), then moved back to the input's placements."""

        @staticmethod
        def forward(ctx, local, have, want, mesh, unmentioned):
            ctx.have, ctx.want, ctx.mesh, ctx.unmentioned = have, want, mesh, unmentioned
            return _moved(local.detach(), have, want, mesh)

        @staticmethod
        def backward(ctx, g):
            if ctx.unmentioned and _size(ctx.mesh, ctx.unmentioned) > 1:
                g = _psum(ctx.mesh, ctx.unmentioned, g)
            return _moved(g, ctx.want, ctx.have, ctx.mesh), None, None, None, None

    class OutScale(torch.autograd.Function):
        """The identity; its transpose divides by the size of the mesh axes
        the out-spec leaves replicated (JAX's unchecked ``shard_map``)."""

        @staticmethod
        def forward(ctx, t, n):
            ctx.n = n
            return t.view_as(t)

        @staticmethod
        def backward(ctx, g):
            return g / ctx.n, None

    _FNS = {"psum": Psum, "all_gather": AllGather, "move": Move, "out_scale": OutScale}
    return _FNS


_FNS = None


def psum(x, axes: Axes):
    """The sum of ``x`` over the ranks of ``axes`` (``lax.psum``); its
    gradient is psum over the same axes.  Over no axes it is ``x``, inside
    a body or not, so a body runs as it is on plain tensors."""
    names = entry_axes(axes)
    if not names:
        return x
    mesh = _active()
    if _size(mesh, names) == 1:
        return x
    return _autograd()["psum"].apply(x, mesh, names)


def mesh_sum(mesh, x):
    """``x`` summed over every rank of ``mesh`` in one all-reduce, outside
    any body (no gradient)."""
    names = tuple(mesh.mesh_dim_names)
    return _psum(mesh, names, x) if _size(mesh, names) > 1 else x.detach()


def pmax(x, axes: Axes):
    """The elementwise max of ``x`` over the ranks of ``axes``
    (``lax.pmax``), as a constant: it carries no gradient (a log-sum-exp's
    shift, whose gradient is zero).  Over no axes it is ``x`` detached."""
    import torch.distributed as dist

    names = entry_axes(axes)
    if not names:
        return x.detach()
    mesh = _active()
    out = x.detach().clone()
    if _size(mesh, names) == 1:
        return out
    group, _ = _group(mesh, names)
    COLLECTIVE_BYTES["psum"] += out.numel() * out.element_size()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def flat_index(axes: Axes) -> int:
    """This rank's position in the flattened sub-mesh of ``axes``, first
    axis major (the block of a dim split over ``axes`` that it holds); 0
    over no axes."""
    idx = 0
    for a in entry_axes(axes):
        idx = idx * axis_size(a) + axis_index(a)
    return idx


def pmean(x, axes: Axes):
    """The mean of ``x`` over the ranks of ``axes`` (``lax.pmean``)."""
    return psum(x, axes) / _size(_active(), entry_axes(axes))


def all_gather(x, axes: Axes, dim: int = 0, tiled: bool = True):
    """``x`` of every rank of ``axes``, in flattened order (first axis
    major), concatenated along ``dim`` (``tiled``) or stacked at it; its
    gradient is the reduce-scatter of the cotangent over the same axes."""
    mesh, names = _active(), entry_axes(axes)
    if _size(mesh, names) == 1:
        return x if tiled else x.unsqueeze(dim)
    return _autograd()["all_gather"].apply(x, mesh, names, dim, tiled)


def _unmentioned(spec, mesh) -> Tuple[str, ...]:
    """The mesh axes that no entry of ``spec`` names."""
    named = {a for entry in spec for a in entry_axes(entry)}
    return tuple(a for a in mesh.mesh_dim_names if a not in named)


def _local(x, spec, mesh, n_devices: int, dtensor):
    """``x``'s local shard under ``spec``'s placements, differentiably."""
    if not isinstance(x, dtensor):
        if n_devices == 1:
            return x
        raise TypeError(
            f"shard_map got a plain {type(x).__name__} of shape {tuple(x.shape)} for "
            f"{spec!r} on a mesh of {n_devices} devices: distribute it first")
    if any(p.is_partial() for p in x.placements):   # a pending sum: reduced first
        from torch.distributed.tensor import Replicate

        x = x.redistribute(mesh, [Replicate() if p.is_partial() else p for p in x.placements])
    have, want = tuple(x.placements), spec_to_placements(spec, mesh)
    local = x.to_local()
    if not local.requires_grad:
        return _moved(local, have, want, mesh)
    return _autograd()["move"].apply(local, have, want, mesh, _unmentioned(spec, mesh))


def _moved(local, have, want, mesh):
    """A local shard under placements ``have`` moved to ``want`` through
    this module's collectives (DTensor's own redistribution gathers through
    functional collectives, which gloo does not run on CUDA tensors): each
    mesh dim that stops sharding is all-gathered, inner dims first, then
    each that starts is cut, outer dims first, as ``Shard`` splits."""
    if have == want:
        return local
    if any(p.is_partial() for p in (*have, *want)):
        raise NotImplementedError(f"shard_map moves no Partial placement ({have} -> {want})")
    from torch.distributed.tensor import Replicate

    names = tuple(mesh.mesh_dim_names)
    have = list(have)
    for i in reversed(range(len(names))):
        if have[i].is_shard() and have[i] != want[i]:
            local = _all_gather(mesh, (names[i],), local, have[i].dim, True)
            have[i] = Replicate()
    for i, p in enumerate(want):
        if p.is_shard() and have[i] != p:
            local = local.chunk(mesh.size(i), dim=p.dim)[mesh.get_coordinate()[i]]
    return local


def shard_map(body: Callable, mesh, in_specs: Sequence[PartitionSpec],
              out_specs: Union[PartitionSpec, Sequence[PartitionSpec]]) -> Callable:
    """``body`` run on every rank's local shards (see the module docstring).
    ``in_specs`` holds one spec an argument, applied to every tensor of a
    tree; ``out_specs`` one spec, or one an output of a tuple."""
    from torch.distributed.tensor import DTensor

    n_devices = mesh_size(mesh)

    def wrapped(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} arguments for {len(in_specs)} in_specs")
        # one spec for every tensor of an argument's tree, as a JAX spec prefix
        local = [tree_map(lambda t, s=spec: _local(t, s, mesh, n_devices, DTensor), a)
                 for a, spec in zip(args, in_specs)]
        with _on(mesh):
            outs = body(*local)

        def wrap(tree, spec):
            placements = spec_to_placements(spec, mesh)
            n = _size(mesh, _unmentioned(spec, mesh))

            def one(t):
                if n > 1 and t.requires_grad:
                    t = _autograd()["out_scale"].apply(t, n)
                return DTensor.from_local(t, mesh, placements, run_check=False)

            return tree_map(one, tree)

        if isinstance(out_specs, PartitionSpec):
            return wrap(outs, out_specs)
        return tuple(wrap(o, spec) for o, spec in zip(outs, out_specs))

    return wrapped
