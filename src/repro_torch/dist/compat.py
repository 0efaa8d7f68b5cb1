"""Version shim for ``torch.distributed`` (port of ``repro.dist.compat``,
which papers over ``jax.shard_map``'s moves), the start of a process
group for a mesh, and the host-staged process group that lets two ranks
share one card.

Imports: ``DeviceMesh`` from ``torch.distributed.device_mesh`` and
``DTensor`` / ``Shard`` / ``Replicate`` / ``Partial`` from
``torch.distributed.tensor`` (and ``implicit_replication`` from its
``experimental``) on torch >= 2.4, from ``torch.distributed._tensor`` on
older releases. ``full`` is the explicit all-gather of a DTensor to a
plain tensor; ``from_local`` wraps evenly sharded shards without one.

Backends (``backend_for``):
  * the card, one rank a device: ``nccl``;
  * the card, more ranks than devices: ``hoststaged``, a process group
    of this module (``HostStagedGroup``) that runs every collective on
    gloo over host copies of its CUDA operands and copies the results
    back. NCCL refuses two ranks on one device, and gloo on CUDA tensors
    is only partial: on the H100 machine (torch 2.11, CUDA 12.8) gloo takes
    ``all_reduce`` (sum, max), ``broadcast``, ``all_gather``,
    ``all_gather_into_tensor``, ``reduce_scatter_tensor`` and
    ``all_to_all_single`` through ``torch.distributed``, aborts the
    process on ``send`` / ``recv`` (a ``writev`` of a device pointer), and
    crashes on every functional collective, the path DTensor's
    redistributions take. So the staged group covers every collective on
    a CUDA tensor: all-reduce, all-gather (list and tensor forms),
    reduce-scatter, all-to-all, broadcast, scatter, gather, send / recv
    and barrier. It is
    chosen by the backend's name and applies to every call; each rank's
    compute stays on the card;
  * the CPU: ``gloo``.
"""
from __future__ import annotations

import datetime
import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

try:
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
except ImportError:  # pragma: no cover - torch < 2.4
    from torch.distributed._tensor import (DTensor, Partial,  # noqa: F401
                                           Replicate, Shard)
    from torch.distributed._tensor.device_mesh import DeviceMesh  # noqa
    from torch.distributed._tensor.experimental import (  # noqa: F401
        implicit_replication)

HOST_STAGED = "hoststaged"


def full(x):
    """A DTensor's global value as a plain tensor on every rank (the
    collective its placements need); anything else as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def from_local(local: torch.Tensor, mesh, placements, shape) -> DTensor:
    """The DTensor of global ``shape`` whose shard on this rank is
    ``local`` (contiguous, evenly sharded; no collective)."""
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def _done(result=None):
    """A completed Work (the staged group finishes each collective before
    it returns)."""
    fut = torch.futures.Future()
    fut.set_result(result)
    return torch._C._distributed_c10d._create_work_from_future(fut)


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu() if t.device.type != "cpu" else t


class HostStagedGroup(dist.ProcessGroup):
    """A process group that runs each collective on gloo over host copies
    of its operands: CUDA inputs are copied to the host, the gloo
    collective runs there, and the results are copied back into the
    CUDA outputs. CPU operands go to gloo as they are. ``staged`` counts
    the collectives that copied, by name."""

    def __init__(self, store, rank: int, size: int, timeout):
        super().__init__(rank, size)
        self._rank, self._size = rank, size
        self._gloo = dist.ProcessGroupGloo(
            dist.PrefixStore("hoststaged/", store), rank, size, timeout)
        self.staged: dict[str, int] = {}

    # -- bookkeeping -------------------------------------------------------
    def getBackendName(self) -> str:
        return HOST_STAGED

    def size(self) -> int:
        return self._size

    @property
    def group_name(self) -> str:
        return dist.distributed_c10d._world.pg_names[self]

    def rank(self) -> int:
        return self._rank

    def _count(self, name: str, tensors) -> None:
        if any(t.device.type != "cpu" for t in tensors):
            self.staged[name] = self.staged.get(name, 0) + 1

    # -- collectives -------------------------------------------------------
    def allreduce(self, tensors, opts=None):
        self._count("all_reduce", tensors)
        hs = [_host(t).clone() for t in tensors]
        self._gloo.allreduce(hs, opts or dist.AllreduceOptions()).wait()
        for t, h in zip(tensors, hs):
            t.copy_(h)
        return _done(tensors)

    def allreduce_coalesced(self, tensors, opts=None):
        for t in tensors:
            o = dist.AllreduceOptions()
            if opts is not None:
                o.reduceOp = opts.reduceOp
            self.allreduce([t], o)
        return _done(tensors)

    def broadcast(self, tensors, opts=None):
        self._count("broadcast", tensors)
        hs = [_host(t).clone() for t in tensors]
        self._gloo.broadcast(hs, opts or dist.BroadcastOptions()).wait()
        for t, h in zip(tensors, hs):
            t.copy_(h)
        return _done(tensors)

    def allgather(self, output_tensors, input_tensors, opts=None):
        self._count("all_gather", input_tensors)
        hin = [_host(t).contiguous() for t in input_tensors]
        hout = [[torch.empty_like(h) for _ in outs]
                for h, outs in zip(hin, output_tensors)]
        self._gloo.allgather(hout, hin,
                             opts or dist.AllgatherOptions()).wait()
        for outs, hs in zip(output_tensors, hout):
            for o, h in zip(outs, hs):
                o.copy_(h)
        return _done(output_tensors)

    def all_gather_single(self, output_tensor, input_tensor, opts=None):
        self._count("all_gather_into_tensor", [input_tensor])
        h_in = _host(input_tensor).contiguous()
        h_out = torch.empty(output_tensor.shape, dtype=output_tensor.dtype)
        self._gloo._allgather_base(
            h_out, h_in, opts or dist.AllgatherOptions()).wait()
        output_tensor.copy_(h_out)
        return _done(output_tensor)

    _allgather_base = all_gather_single

    def all_gather_single_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs, strict=True):
            self.all_gather_single(o, i, opts)
        return _done(outputs)

    allgather_into_tensor_coalesced = all_gather_single_coalesced

    def reduce_scatter(self, output_tensors, input_tensors, opts=None):
        self._count("reduce_scatter", output_tensors)
        for out, ins in zip(output_tensors, input_tensors, strict=True):
            h_in = torch.cat([_host(t).reshape(-1) for t in ins])
            self._reduce_scatter_flat(out, h_in, opts)
        return _done(output_tensors)

    def _reduce_scatter_flat(self, out, h_in, opts) -> None:
        """reduce_scatter over gloo as all_reduce then this rank's slice
        (gloo's own reduce_scatter takes no flat CPU buffer in every
        release)."""
        h = h_in.clone()
        o = dist.AllreduceOptions()
        o.reduceOp = (opts.reduceOp if opts is not None
                      else dist.ReduceOp.SUM)
        self._gloo.allreduce([h], o).wait()
        n = out.numel()
        out.copy_(h[self._rank * n:(self._rank + 1) * n].reshape(out.shape))

    def reduce_scatter_single(self, output_tensor, input_tensor, opts=None):
        self._count("reduce_scatter_tensor", [input_tensor])
        self._reduce_scatter_flat(
            output_tensor, _host(input_tensor).reshape(-1), opts)
        return _done(output_tensor)

    _reduce_scatter_base = reduce_scatter_single

    def reduce_scatter_single_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs, strict=True):
            self.reduce_scatter_single(o, i, opts)
        return _done(outputs)

    reduce_scatter_tensor_coalesced = reduce_scatter_single_coalesced

    def all_to_all_single(self, output, input, output_split_sizes,
                          input_split_sizes, opts=None):
        self._count("all_to_all_single", [input])
        h_in = _host(input).contiguous()
        h_out = torch.empty(output.shape, dtype=output.dtype)
        self._gloo.alltoall_base(h_out, h_in, list(output_split_sizes or []),
                                 list(input_split_sizes or []),
                                 opts or dist.AllToAllOptions()).wait()
        output.copy_(h_out)
        return _done(output)

    alltoall_base = all_to_all_single

    def alltoall(self, output_tensors, input_tensors, opts=None):
        self._count("all_to_all", input_tensors)
        hin = [_host(t).contiguous() for t in input_tensors]
        hout = [torch.empty(o.shape, dtype=o.dtype) for o in output_tensors]
        self._gloo.alltoall(hout, hin, opts or dist.AllToAllOptions()).wait()
        for o, h in zip(output_tensors, hout):
            o.copy_(h)
        return _done(output_tensors)

    def scatter(self, output_tensors, input_tensors, opts=None):
        self._count("scatter", output_tensors)
        hout = [torch.empty(o.shape, dtype=o.dtype) for o in output_tensors]
        hin = [[_host(t).contiguous() for t in ins] for ins in input_tensors]
        self._gloo.scatter(hout, hin, opts or dist.ScatterOptions()).wait()
        for o, h in zip(output_tensors, hout):
            o.copy_(h)
        return _done(output_tensors)

    def gather(self, output_tensors, input_tensors, opts=None):
        self._count("gather", input_tensors)
        hin = [_host(t).contiguous() for t in input_tensors]
        hout = [[torch.empty(o.shape, dtype=o.dtype) for o in outs]
                for outs in output_tensors]
        self._gloo.gather(hout, hin, opts or dist.GatherOptions()).wait()
        for outs, hs in zip(output_tensors, hout):
            for o, h in zip(outs, hs):
                o.copy_(h)
        return _done(output_tensors)

    def send(self, tensors, dst: int, tag: int = 0):
        self._count("send", tensors)
        self._gloo.send([_host(t).contiguous() for t in tensors], dst,
                        tag).wait()
        return _done(tensors)

    def recv(self, tensors, src: int, tag: int = 0):
        self._count("recv", tensors)
        hs = [torch.empty(t.shape, dtype=t.dtype) for t in tensors]
        self._gloo.recv(hs, src, tag).wait()
        for t, h in zip(tensors, hs):
            t.copy_(h)
        return _done(tensors)

    def barrier(self, opts=None):
        self._gloo.barrier(opts or dist.BarrierOptions()).wait()
        return _done()


def _create_host_staged(store, rank, size, timeout):
    return HostStagedGroup(store, rank, size, timeout)


if HOST_STAGED not in dist.Backend.backend_list:
    dist.Backend.register_backend(HOST_STAGED, _create_host_staged,
                                  devices=["cpu", "cuda"])


def backend_for(device: torch.device, world: int) -> str:
    """The backend for ``world`` ranks on ``device``'s type: nccl with
    one rank a card, the host-staged group with more ranks than cards,
    gloo on the CPU."""
    if device.type == "cuda":
        return "nccl" if world <= torch.cuda.device_count() \
            else HOST_STAGED
    return "gloo"


def rank_env() -> tuple[int, int, int]:
    """(rank, world size, local rank) as ``torchrun`` sets them; (0, 1, 0)
    without it."""
    return (int(os.environ.get("RANK", 0)),
            int(os.environ.get("WORLD_SIZE", 1)),
            int(os.environ.get("LOCAL_RANK", 0)))


def rank_device(device) -> torch.device:
    """This rank's device: ``cuda:{local_rank % device_count}`` for a
    CUDA run (two ranks share a card when there are more ranks than
    cards), the CPU as it is."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank_env()[2] % torch.cuda.device_count())


def init_process_group(device, store_dir: Optional[str] = None,
                       timeout_s: float = 600.0) -> str:
    """Start the default process group for this rank and return its
    backend, or return the standing group's backend.

    Ranks read ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` as ``torchrun``
    sets them (its rendezvous in ``MASTER_ADDR`` / ``MASTER_PORT``). With
    none set, a single-rank group starts on a ``FileStore`` in a temporary
    directory (``store_dir`` when given)."""
    if dist.is_initialized():
        return dist.get_backend()
    dev = rank_device(device)
    rank, world, _ = rank_env()
    backend = backend_for(dev, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    if "RANK" in os.environ:
        dist.init_process_group(backend, rank=rank, world_size=world,
                                timeout=timeout)
    else:
        path = os.path.join(store_dir or tempfile.mkdtemp(), "store")
        dist.init_process_group(backend, store=dist.FileStore(path, 1),
                                rank=0, world_size=1, timeout=timeout)
    return backend


def staged_collectives() -> dict:
    """{collective: count} that went through the host-staged group of
    this process (empty on another backend)."""
    if not dist.is_initialized():
        return {}
    counts: dict = {}
    for pg in list(dist.distributed_c10d._world.pg_map):
        if isinstance(pg, HostStagedGroup):
            for k, v in pg.staged.items():
                counts[k] = counts.get(k, 0) + v
    return counts
