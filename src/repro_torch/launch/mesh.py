"""Device meshes with the production axis names.  The port of
``repro.launch.mesh``: ``torch.distributed.device_mesh.DeviceMesh``es over
a ``torch.distributed`` world.

FUNCTIONS, not module-level constants, so importing this module never
starts a process group.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import DeviceLike, resolve_device

#: the process-group backend of each device type; no other pairing
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def world_backend(device_type: str, world_size: int, ranks_per_device: int = 1) -> str:
    """The process-group backend of a world, by name: ``gloo`` on the CPU,
    ``nccl`` for one rank a CUDA device, and ``staged_gloo``
    (``repro_torch.dist.staged_gloo``: gloo on host copies) for several
    ranks on one CUDA device, where NCCL refuses to run and gloo, handed
    CUDA tensors, crashes in DTensor's functional all-gather."""
    if device_type == "cpu":
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"no process-group backend for device type {device_type!r}")
    if ranks_per_device > 1 and world_size > 1:
        return "staged_gloo"
    return "nccl"


def init_world(rank: int, world_size: int, init_method: str, device_type: str,
               ranks_per_device: int = 1) -> str:
    """Start this rank's default process group on the backend
    ``world_backend`` names (registering ``staged_gloo`` first where it is
    the one); returns the backend's name.  If it cannot start it raises:
    nothing falls back to another backend."""
    backend = world_backend(device_type, world_size, ranks_per_device)
    if backend == "staged_gloo":
        from repro_torch.dist import staged_gloo

        staged_gloo.register()
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return backend


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """The single-pod 16×16 ``("data", "model")`` mesh, or the multi-pod
    2×16×16 ``("pod", "data", "model")`` one, over a world of 256 (512)
    ranks the caller has already initialised; any other world raises."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError(f"make_production_mesh needs an initialised world of {n} ranks")
    if dist.get_world_size() != n:
        raise ValueError(f"the {shape} mesh needs a world of {n} ranks, "
                         f"not {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device: DeviceLike = None) -> DeviceMesh:
    """A 1×1 ``("data", "model")`` mesh of this process's device: the card
    unless ``device="cpu"`` is asked for (``None`` without a card raises).
    Where no default process group exists it starts a world of one on an
    in-process ``HashStore``, ``nccl`` for the card and ``gloo`` for the
    CPU; if that backend cannot start it raises (nothing falls back)."""
    dev = resolve_device(device)
    if dev.type not in _BACKENDS:
        raise ValueError(f"no process-group backend for device {dev}")
    if not dist.is_initialized():
        dist.init_process_group(_BACKENDS[dev.type], store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != 1:
        raise ValueError(f"make_host_mesh is a world of one; this world has "
                         f"{dist.get_world_size()} ranks")
    return init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data", "model"))
