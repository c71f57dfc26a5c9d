"""``staged_gloo``: a process-group backend for a world of several ranks on
one CUDA device, each collective staged through a host buffer and run by
gloo.

NCCL refuses two ranks on one device, and gloo, handed CUDA tensors, runs
``all_reduce`` and ``all_gather_into_tensor`` from ``torch.distributed``
but not the functional collectives through which DTensor redistributes
(a ``Shard`` to ``Replicate`` move, a ``Partial`` sum, ``full_tensor``).
This backend is one Python ``ProcessGroup`` over a gloo one: every
collective copies each tensor it is handed to the host, runs gloo's
collective on the copies, waits, and copies the results back.  So a
DTensor step on 4 ranks of one card issues each collective where it
would on 4 cards, and pays for it in host copies.

It implements what DTensor and ``repro_torch.dist.shard_map`` issue:
all-reduce, all-gather into a tensor (and the list form), reduce-scatter
of a tensor, all-to-all of a tensor, broadcast and barrier.  gloo's
reduce-scatter is not asked for: this backend composes it from an
all-reduce and a local slice (the same numbers, ``world`` times the
bytes), and ``STAGED_BYTES["reduce_scatter as all_reduce"]`` counts it.

``STAGED_BYTES`` counts, by collective, the bytes this rank copied to the
host (input bytes; a collective's results come back in as many).
``register()`` names the backend to ``torch.distributed``;
``repro_torch.launch.mesh.init_world`` picks it by name for a world of
several ranks on one CUDA device.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist

NAME = "staged_gloo"

#: host bytes a rank staged, by collective (input bytes, summed over calls)
STAGED_BYTES: Dict[str, int] = {
    "all_reduce": 0, "all_gather": 0, "reduce_scatter as all_reduce": 0, "all_to_all": 0,
    "broadcast": 0,
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _done(result):
    from torch._C._distributed_c10d import _create_work_from_future

    fut = torch.futures.Future()
    fut.set_result(result)
    return _create_work_from_future(fut)


def _host(t: torch.Tensor) -> torch.Tensor:
    """A contiguous host copy of ``t`` (a fresh buffer on the CPU too)."""
    return t.detach().to("cpu", copy=True).contiguous()


class StagedGloo(dist.ProcessGroup):
    """One rank's group: gloo on host copies (see the module docstring)."""

    def __init__(self, store, rank: int, size: int, timeout):
        super().__init__(rank, size)
        self._gloo = dist.ProcessGroupGloo(store, rank, size, timeout)

    def getBackendName(self) -> str:
        return NAME

    # the functional collectives find a group by its name, which c10d sets
    # through ``_set_group_name`` and a Python group must answer itself
    def _set_group_name(self, name: str) -> None:
        self._name = name
        super()._set_group_name(name)

    @property
    def group_name(self) -> str:
        return self._name

    # -- all-reduce ---------------------------------------------------------

    def allreduce(self, tensors: List[torch.Tensor], opts=None):
        opts = opts if opts is not None else dist.AllreduceOptions()
        hosts = [_host(t) for t in tensors]
        STAGED_BYTES["all_reduce"] += sum(map(_nbytes, hosts))
        self._gloo.allreduce(hosts, opts).wait()
        for t, h in zip(tensors, hosts):
            t.copy_(h)
        return _done(tensors)

    def allreduce_coalesced(self, tensors: List[torch.Tensor], opts=None):
        work = None
        for t in tensors:
            o = dist.AllreduceOptions()
            if opts is not None:
                o.reduceOp = opts.reduceOp
            work = self.allreduce([t], o)
        return work if work is not None else _done(tensors)

    # -- all-gather ---------------------------------------------------------

    def all_gather_single(self, output: torch.Tensor, input: torch.Tensor, opts=None):
        host_in, host_out = _host(input), torch.empty(output.shape, dtype=output.dtype)
        STAGED_BYTES["all_gather"] += _nbytes(host_in)
        self._gloo._allgather_base(host_out, host_in).wait()
        output.copy_(host_out)
        return _done([output])

    _allgather_base = all_gather_single

    def allgather(self, outputs: List[List[torch.Tensor]], inputs: List[torch.Tensor],
                  opts=None):
        for outs, t in zip(outputs, inputs):
            flat = torch.empty((len(outs) * t.numel(),), dtype=t.dtype, device=t.device)
            self.all_gather_single(flat, t.reshape(-1))
            for o, chunk in zip(outs, flat.chunk(len(outs))):
                o.copy_(chunk.view(o.shape))
        return _done(outputs)

    def all_gather_single_coalesced(self, outputs, inputs, opts=None):
        for o, t in zip(outputs, inputs):
            self.all_gather_single(o, t)
        return _done(outputs)

    allgather_into_tensor_coalesced = all_gather_single_coalesced

    # -- reduce-scatter: all-reduce and a local slice ---------------------

    def reduce_scatter_single(self, output: torch.Tensor, input: torch.Tensor, opts=None):
        o = dist.AllreduceOptions()
        if opts is not None:
            o.reduceOp = opts.reduceOp
        host = _host(input)
        STAGED_BYTES["reduce_scatter as all_reduce"] += _nbytes(host)
        self._gloo.allreduce([host], o).wait()
        output.copy_(host.chunk(self.size())[self.rank()].view(output.shape))
        return _done([output])

    _reduce_scatter_base = reduce_scatter_single

    def reduce_scatter(self, outputs: List[torch.Tensor], inputs: List[List[torch.Tensor]],
                       opts=None):
        for o, ins in zip(outputs, inputs):
            self.reduce_scatter_single(o, torch.cat([t.reshape(-1) for t in ins]), opts)
        return _done(outputs)

    def reduce_scatter_single_coalesced(self, outputs, inputs, opts=None):
        for o, t in zip(outputs, inputs):
            self.reduce_scatter_single(o, t, opts)
        return _done(outputs)

    reduce_scatter_tensor_coalesced = reduce_scatter_single_coalesced

    # -- all-to-all, broadcast, barrier -------------------------------------

    def all_to_all_single(self, output, input, output_split_sizes, input_split_sizes,
                          opts=None):
        host_in, host_out = _host(input), torch.empty(output.shape, dtype=output.dtype)
        STAGED_BYTES["all_to_all"] += _nbytes(host_in)
        self._gloo.alltoall_base(host_out, host_in, list(output_split_sizes or []),
                                 list(input_split_sizes or []),
                                 dist.AllToAllOptions()).wait()
        output.copy_(host_out)
        return _done([output])

    alltoall_base = all_to_all_single

    def broadcast(self, tensors: List[torch.Tensor], opts=None):
        opts = opts if opts is not None else dist.BroadcastOptions()
        hosts = [_host(t) for t in tensors]
        STAGED_BYTES["broadcast"] += sum(map(_nbytes, hosts))
        self._gloo.broadcast(hosts, opts).wait()
        for t, h in zip(tensors, hosts):
            t.copy_(h)
        return _done(tensors)

    def barrier(self, opts=None):
        self._gloo.barrier(dist.BarrierOptions()).wait()
        return _done([])


def _create(store, rank, size, timeout):
    return StagedGloo(store, rank, size, timeout)


def register() -> None:
    """Name the backend to ``torch.distributed`` (once a process)."""
    if NAME not in dist.Backend.backend_list:
        dist.Backend.register_backend(NAME, _create, devices=["cpu", "cuda"])
