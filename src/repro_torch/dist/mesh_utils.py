"""Mesh introspection helpers shared by the sharding rules and tests: a copy
of ``repro.dist.mesh_utils``.

Everything here works on *anything mesh-shaped*: a
``torch.distributed.device_mesh.DeviceMesh`` (``mesh_dim_names`` and
``shape``), or any object exposing ``axis_names`` plus a ``devices``
ndarray (the tests' FakeMesh, so rule construction never needs a process
group).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

PhysAxis = Union[str, Tuple[str, ...], None]


def axis_sizes(mesh) -> Dict[str, int]:
    """{mesh axis name: size} for a DeviceMesh or mesh-shaped object."""
    dim_names = getattr(mesh, "mesh_dim_names", None)
    if dim_names is not None:   # torch's DeviceMesh
        return dict(zip(dim_names, (int(s) for s in mesh.shape)))
    if not hasattr(mesh, "axis_names"):
        raise ValueError(f"{mesh!r} names no axes (a DeviceMesh needs mesh_dim_names)")
    names = tuple(mesh.axis_names)
    devices = getattr(mesh, "devices", None)
    if devices is not None:
        return dict(zip(names, devices.shape))
    return {k: int(v) for k, v in dict(mesh.shape).items()}


def mesh_size(mesh) -> int:
    n = 1
    for s in axis_sizes(mesh).values():
        n *= s
    return n


def entry_axes(entry: PhysAxis) -> Tuple[str, ...]:
    """Flatten one PartitionSpec entry to its physical axis names."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(a for a in entry if a is not None)


def spec_axes(spec) -> Tuple[str, ...]:
    """All physical axes used by a PartitionSpec, in order of appearance."""
    out = []
    for entry in spec:
        out.extend(entry_axes(entry))
    return tuple(out)


def entry_shards(entry: PhysAxis, sizes: Dict[str, int]) -> int:
    """Number of shards one spec entry splits its dimension into."""
    n = 1
    for a in entry_axes(entry):
        n *= sizes.get(a, 1)
    return n


def validate_spec(
    spec, sizes: Dict[str, int], shape: Optional[Tuple[int, ...]] = None
) -> None:
    """Raise if ``spec`` reuses a physical axis or (given ``shape``) asks for
    a non-divisible split.  Used by the property tests and debug asserts."""
    used = spec_axes(spec)
    if len(used) != len(set(used)):
        raise ValueError(f"physical axis reused in {spec}: {used}")
    for a in used:
        if a not in sizes:
            raise ValueError(f"{spec} names unknown mesh axis {a!r} (mesh {sizes})")
    if shape is not None:
        if len(tuple(spec)) > len(shape):
            raise ValueError(f"spec {spec} longer than shape {shape}")
        for dim, entry in zip(shape, tuple(spec)):
            n = entry_shards(entry, sizes)
            if n > 1 and dim % n != 0:
                raise ValueError(
                    f"dim {dim} not divisible by {n} shards ({entry} in {spec})"
                )
