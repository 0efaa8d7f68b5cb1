"""Mesh construction (port of ``repro.launch.mesh``). Functions, not
module-level constants, so importing this module touches no device or
process-group state.

Single pod:  (16, 16)      axes ("data", "model")          — 256 ranks
Multi-pod:   (2, 16, 16)   axes ("pod", "data", "model")   — 512 ranks

A mesh is a ``DeviceMesh`` over the default process group, which
``make_local_mesh`` starts when none stands (``dist.compat``); the dry
run builds the production mesh over a fake group
(``fake_process_group``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.dist import compat


def _mesh(device, shape: tuple, axes: tuple):
    dev = compat.rank_device(device)
    return compat.DeviceMesh(dev.type,
                             torch.arange(dist.get_world_size()).reshape(
                                 shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The (16, 16) ("data", "model") or (2, 16, 16) ("pod", "data",
    "model") mesh over the process group that stands; a world of another
    size raises, naming the shape."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != n:
        raise ValueError(f"the production mesh {shape} {axes} needs {n} "
                         f"ranks; the process group has {world}")
    return _mesh(device, shape, axes)


def fake_process_group(world: int) -> None:
    """Start ``torch.distributed``'s ``fake`` backend in this process as
    rank 0 of ``world`` ranks (the dry run's 256 or 512): a mesh over it
    builds, and its collectives return at once without moving anything."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_local_mesh(model_axis: int = 1, device="cuda"):
    """Whatever this run has: a (world // model_axis, model_axis) mesh
    with dims ("data", "model") over the ranks ``torchrun`` started (the
    process group starts here when none stands); a single process without
    ``torchrun`` gets a 1 x 1 mesh. A ``model_axis`` that does not divide
    the world raises (the reference floors and leaves ranks idle)."""
    compat.init_process_group(device)
    world = dist.get_world_size()
    if model_axis < 1 or world % model_axis:
        raise ValueError(f"--model_axis {model_axis} does not divide the "
                         f"{world} ranks: start a multiple of {model_axis} "
                         f"ranks with torchrun")
    return _mesh(device, (world // model_axis, model_axis),
                 ("data", "model"))
