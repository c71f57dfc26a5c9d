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
``pmean(x, axes)`` and ``all_gather(x, axes, dim, tiled=True)``.  A tuple
of axes is the flattened sub-mesh, its first axis major (what
``lax.all_gather(x, ("pod", "data"), tiled=True)`` concatenates); one
process group is made for each axis tuple and kept.

Forward only: with grad mode on, an input that requires grad raises
``NotImplementedError`` (ROADMAP queue 1 row 9b-ii), so no reduction the
gradient would need can go missing silently.

Collectives run through ``torch.distributed``'s ``all_reduce`` and
``all_gather_into_tensor`` on the group, which gloo runs on CUDA tensors
too; ``COLLECTIVE_BYTES`` counts what each rank handed them.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Callable, Dict, Sequence, Tuple, Union

from repro_torch.dist.mesh_utils import axis_sizes, entry_axes, mesh_size
from repro_torch.dist.sharding import PartitionSpec, spec_to_placements
from repro_torch.tree import tree_leaves, tree_map

Axes = Union[str, Tuple[str, ...]]

#: bytes each collective was handed (input bytes a rank, summed over calls)
COLLECTIVE_BYTES = {"psum": 0, "all_gather": 0}

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


def psum(x, axes: Axes):
    """The sum of ``x`` over the ranks of ``axes`` (``lax.psum``)."""
    import torch.distributed as dist

    mesh, names = _active(), entry_axes(axes)
    if _size(mesh, names) == 1:
        return x
    group, _ = _group(mesh, names)
    COLLECTIVE_BYTES["psum"] += x.numel() * x.element_size()
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def pmean(x, axes: Axes):
    """The mean of ``x`` over the ranks of ``axes`` (``lax.pmean``)."""
    return psum(x, axes) / _size(_active(), entry_axes(axes))


def all_gather(x, axes: Axes, dim: int = 0, tiled: bool = True):
    """``x`` of every rank of ``axes``, in flattened order (first axis
    major), concatenated along ``dim`` (``tiled``) or stacked at it."""
    import torch
    import torch.distributed as dist

    mesh, names = _active(), entry_axes(axes)
    n = _size(mesh, names)
    if n == 1:
        return x if tiled else x.unsqueeze(dim)
    group, order = _group(mesh, names)
    COLLECTIVE_BYTES["all_gather"] += x.numel() * x.element_size()
    src = x.contiguous().reshape(-1) if x.dim() == 0 else x.contiguous()
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather_into(out, src, group=group)
    # the group's ranks come ascending; the sub-mesh's order may differ
    chunks = out.chunk(n, dim=0)
    ascending = sorted(order)
    chunks = [chunks[ascending.index(r)].reshape(x.shape) for r in order]
    return torch.cat(chunks, dim=dim) if tiled else torch.stack(chunks, dim=dim)


def _grad_inputs(args) -> bool:
    import torch

    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tree_leaves(args))


def _local(x, spec, mesh, n_devices: int, dtensor):
    """``x``'s local shard under ``spec``'s placements."""
    if not isinstance(x, dtensor):
        if n_devices == 1:
            return x
        raise TypeError(
            f"shard_map got a plain {type(x).__name__} of shape {tuple(x.shape)} for "
            f"{spec!r} on a mesh of {n_devices} devices: distribute it first")
    return _moved(x.to_local(), tuple(x.placements), spec_to_placements(spec, mesh), mesh)


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
    with _on(mesh):
        for i in reversed(range(len(names))):
            if have[i].is_shard() and have[i] != want[i]:
                local = all_gather(local, names[i], dim=have[i].dim)
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
        if _grad_inputs(args):
            raise NotImplementedError(
                "shard_map is forward only: gradients through the sharded bodies are "
                "ROADMAP queue 1 row 9b-ii")
        # one spec for every tensor of an argument's tree, as a JAX spec prefix
        local = [tree_map(lambda t, s=spec: _local(t, s, mesh, n_devices, DTensor), a)
                 for a, spec in zip(args, in_specs)]
        with _on(mesh):
            outs = body(*local)

        def wrap(tree, spec):
            placements = spec_to_placements(spec, mesh)
            return tree_map(lambda t: DTensor.from_local(t, mesh, placements, run_check=False),
                            tree)

        if isinstance(out_specs, PartitionSpec):
            return wrap(outs, out_specs)
        return tuple(wrap(o, spec) for o, spec in zip(outs, out_specs))

    return wrapped
